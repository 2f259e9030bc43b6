"""Device milliseconds a batch under the three query encoders'
``embed_tokens`` spans."""

SPANS = ("encoder.dpr", "encoder.splade", "encoder.colbert")


def read(record):
    dev = record.get("device_s", {})
    if not record.get("batches") or not any(s in dev for s in SPANS):
        return None
    return sum(dev.get(s, 0.0) for s in SPANS) * 1e3 / record["batches"]
