"""Device operations a batch: the profiler's kernels, copies and sets,
plus the hand-written kernels counted by their launches (the trace may
miss those)."""


def read(record):
    return record["device_ops"] / record["batches"] if record.get("batches") and "device_ops" in record else None
