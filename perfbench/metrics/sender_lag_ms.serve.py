"""The load generator's lateness: the 99th percentile of how long after
its due time each request was sent.  A high value means the generator, not
the server, failed to keep the rate."""


def read(record):
    s = record.get("serve")
    return None if not s else s.get("lag_p99_ms")
