"""A cell at a size a CPU test run holds: the LLeQA configuration's layout
with a small trunk, vocabulary and corpus."""

from __future__ import annotations

import copy
import json

from perfbench.spec import HERE


def tiny_cell(traffic: str = "rerank-b64", **mix_changes) -> dict:
    with open(HERE / "configs" / "lleqa-camembert-base.json") as f:
        cfg = json.load(f)
    with open(HERE / "traffic" / f"{traffic}.json") as f:
        mix = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg["encoder"].update(vocab_size=512, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                          intermediate_size=64, max_position_embeddings=130, dtype="float32")
    cfg.update(n_docs=300, query_length=16, doc_length=64, ce_max_length=80, topk=50, colbert_dim=16)
    cfg["corpus"].update(words=400, doc_words={"median": 20, "sigma": 0.8, "lo": 3, "hi": 64}, splade_doc_terms=24)
    cfg["weights"] = {"std": 0.2, "ln_std": 0.05}
    cfg["check"]["queries"] = 4
    mix.update(batch=8, batches_per_call=2, query_pool=64, warm_calls=1, trace_calls=2, check_batch_within=2,
               query_words={"median": 5, "sigma": 0.4, "lo": 2, "hi": 12})
    if mix.get("rerank_depth"):
        mix["rerank_depth"] = 10
    mix.update(mix_changes)
    return {"name": "tiny", "chips": 1, "cfg": cfg, "mix": mix, "end_to_end": [], "per_layer": []}
