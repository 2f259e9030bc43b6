"""Device milliseconds a batch under the four retrieval legs' spans: their
scoring and top-k (``ops/``, ``index/``).  The trace gives a span the
operations launched inside it and not inside a span nested in it, so the
legs' query encoders (``encoder_device_ms``) are not in it."""

LEGS = ("leg.bm25", "leg.dpr", "leg.splade", "leg.colbert")


def read(record):
    dev = record.get("device_s", {})
    if not record.get("batches") or not any(s in dev for s in LEGS):
        return None
    return sum(dev.get(s, 0.0) for s in LEGS) * 1e3 / record["batches"]
