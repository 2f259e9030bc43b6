"""The server's batch fill: queries over (batches x max_batch), from its
``/stats`` counters over the window, in percent."""


def read(record):
    s = record.get("serve")
    if not s or not s["batches"]:
        return None
    return 100.0 * s["queries"] / (s["batches"] * s["max_batch"])
