"""Device milliseconds a batch under the rerank span
(``HybridSearcher._rerank``: plan read-back, row assembly, the
cross-encoder's forward, the head merge)."""


def read(record):
    dev = record.get("device_s", {})
    if not record.get("batches") or not record.get("rerank_depth") or "rerank" not in dev:
        return None
    return dev["rerank"] * 1e3 / record["batches"]
