"""Typed experiment presets, the same constants as
``fusion_tpu/cli/presets.py``, keyed by (model, dataset):

  * BM25 tuned params: LLeQA k1=2.5 b=0.2; mMARCO k1=0.9 b=0.4
    (run_bm25.sh:23-28)
  * BM25 tuning grid: k1 ∈ [0, 8] step 0.5 × b ∈ [0, 1] step 0.1
    (bm25.py:227-229)
  * DPR LLeQA: bs 64, 7 epochs, seqlen 512, lr 2e-5 AdamW, 5 seeds
    (run_dpr.sh:35-66)
  * SPLADE mMARCO: bs 128, 100k steps, linear sched, 4% warmup
    (run_splade.sh:50-57)
  * ColBERT mMARCO: bs 128, 200k steps, 20k warmup, dim 128, lr 5e-6
    (run_colbert.sh:26-76)
  * monoBERT mMARCO: bs 128, 20k steps, seqlen 256 (run_monobert.sh:46-52)
  * hybrid sweep: 11 retriever combos × {nsf,bcf,rrf} × 3 normalizations
    (run_hybrid.sh:22-52)
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np

SEEDS = (42, 43, 44, 45, 46)  # multi-seed reruns (run_dpr.sh:64)


@dataclass(frozen=True)
class BM25Preset:
    k1: float
    b: float
    do_preprocessing: bool = True
    top_k: int = 1000


BM25_PRESETS = {
    "lleqa": BM25Preset(k1=2.5, b=0.2),
    "mmarco": BM25Preset(k1=0.9, b=0.4),
}

BM25_TUNING_GRID = {
    "k1": np.arange(0.0, 8.5, 0.5).tolist(),
    "b": np.arange(0.0, 1.1, 0.1).tolist(),
}


@dataclass(frozen=True)
class TrainPreset:
    batch_size: int
    steps: int | None = None
    epochs: int | None = None
    learning_rate: float = 2e-5
    optimizer: str = "AdamW"
    scheduler: str = "linear"
    warmup_ratio: float = 0.04
    warmup_steps: int | None = None
    max_query_length: int = 64
    max_doc_length: int = 512
    weight_decay: float = 0.01
    extra: dict = field(default_factory=dict)


TRAIN_PRESETS = {
    ("dpr", "lleqa"): TrainPreset(
        batch_size=64, epochs=7, learning_rate=2e-5,
        max_query_length=512, max_doc_length=512,
    ),
    ("dpr", "mmarco"): TrainPreset(batch_size=128, steps=100_000, max_doc_length=128),
    ("splade", "mmarco"): TrainPreset(
        batch_size=128, steps=100_000, warmup_ratio=0.04,
        max_query_length=32, max_doc_length=128,
    ),
    ("splade", "lleqa"): TrainPreset(
        batch_size=32, epochs=20, max_query_length=64, max_doc_length=512
    ),
    ("colbert", "mmarco"): TrainPreset(
        batch_size=128, steps=200_000, warmup_steps=20_000, learning_rate=5e-6,
        max_query_length=32, max_doc_length=256, extra={"dim": 128},
    ),
    ("colbert", "lleqa"): TrainPreset(
        batch_size=32, steps=10_000, learning_rate=5e-6,
        max_query_length=64, max_doc_length=512, extra={"dim": 128},
    ),
    ("monobert", "mmarco"): TrainPreset(
        batch_size=128, steps=20_000, max_query_length=256, max_doc_length=256
    ),
    ("monobert", "lleqa"): TrainPreset(
        batch_size=32, epochs=10, max_query_length=256, max_doc_length=256
    ),
}

# test-time ColBERT lengths (run_colbert.sh:90-92, hybrid.py:129,133)
COLBERT_TEST_LENGTHS = {"query_maxlen": 64, "doc_maxlen": 512}

FUSION_METHODS = ("bcf", "rrf", "nsf")
FUSION_NORMALIZATIONS = ("min-max", "z-score", "percentile-rank")

# the 11 retriever combinations swept by run_hybrid.sh:22-33
HYBRID_COMBOS = [
    combo
    for r in range(2, 5)
    for combo in itertools.combinations(("bm25", "dpr", "splade", "colbert"), r)
]


def hybrid_sweep():
    """(combo, fusion, normalization) grid — nsf crosses normalizations,
    rank fusers don't (run_hybrid.sh:37-52)."""
    for combo in HYBRID_COMBOS:
        for method in FUSION_METHODS:
            if method == "nsf":
                for norm in FUSION_NORMALIZATIONS:
                    yield combo, method, norm
            else:
                yield combo, method, None


def train_preset(model: str, dataset: str) -> TrainPreset:
    """Preset lookup with an mMARCO fallback: mMARCO-style datasets share
    its recipe."""
    key = (model, dataset.split("-")[0])
    return TRAIN_PRESETS.get(key, TRAIN_PRESETS[(model, "mmarco")])
