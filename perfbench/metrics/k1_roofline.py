"""K1's share of its roofline: the least time its launches' work could take
on the card (``roofline.k1_work``: real doc tokens, each byte once) over
their CUDA-event device time, in percent."""


def read(record):
    spent = record.get("kernel_s", {}).get("K1")
    if not spent or not record.get("k1_bound_s"):
        return None
    return 100.0 * record["k1_bound_s"] / spent
