"""The server's mean batch time (``batch_ms_total / batches`` of its
``/stats`` counters over the window): host and device time of one padded
``searcher.search`` call."""


def read(record):
    s = record.get("serve")
    if not s or not s["batches"]:
        return None
    return s["batch_ms_total"] / s["batches"]
