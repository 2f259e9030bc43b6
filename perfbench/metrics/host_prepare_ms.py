"""Host milliseconds a batch inside ``HybridSearcher._prepare_inputs``
(tokenization for every leg and the upload), from its span."""


def read(record):
    calls = record.get("span_calls", {}).get("prepare")
    return record["host_s"]["prepare"] * 1e3 / calls if calls else None
