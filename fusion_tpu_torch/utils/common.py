"""Shared utilities, as ``fusion_tpu/utils/common.py``: a wall-clock
context manager and a step-timing decorator, seeding, parameter and FLOPs
accounting, batching, TSV conversion, ranking → negatives, and the hub
upload.  ``set_seed`` returns a ``torch.Generator`` where the JAX package
returns a PRNG key; ``estimate_flops`` counts with PyTorch's
``FlopCounterMode`` where the JAX package reads XLA's cost analysis."""

from __future__ import annotations

import functools
import glob
import os
import random
import time
from contextlib import contextmanager
from typing import Callable, Iterable

import numpy as np
import torch


@contextmanager
def catchtime(name: str = "", printer: Callable = print):
    """Wall-clock context manager: ``with catchtime('encode'): ...``."""
    t0 = time.perf_counter()
    yield lambda: time.perf_counter() - t0
    printer(f"{name or 'elapsed'}: {time.perf_counter() - t0:.3f}s")


def log_step(fn=None, *, printer: Callable = print):
    """Decorator printing the duration of a build phase."""

    def wrap(f):
        @functools.wraps(f)
        def inner(*args, **kwargs):
            t0 = time.perf_counter()
            out = f(*args, **kwargs)
            printer(f"[{f.__name__}] took {time.perf_counter() - t0:.3f}s")
            return out

        return inner

    return wrap(fn) if fn is not None else wrap


def set_seed(seed: int = 42) -> torch.Generator:
    """Seed Python's, numpy's and torch's global RNGs and return a CPU
    ``torch.Generator`` seeded with ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def count_parameters(module: torch.nn.Module, trainable_only: bool = False) -> int:
    """Parameter count of a module (only those taking gradients with
    ``trainable_only``)."""
    return sum(p.numel() for p in module.parameters() if p.requires_grad or not trainable_only)


def estimate_flops(fn, *example_args) -> dict:
    """FLOPs of one call of ``fn`` as ``torch.utils.flop_counter`` counts
    them (matrix products and attention; elementwise work is not counted),
    with the call's time on the host clock."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with counter:
        fn(*example_args)
    return {"flops": float(counter.get_total_flops()), "seconds": time.perf_counter() - t0}


def batchify(items, batch_size: int):
    """Yield successive fixed-size slices (the last may be short)."""
    for i in range(0, len(items), batch_size):
        yield items[i : i + batch_size]


def tsv_to_jsonl(tsv_path: str, jsonl_path: str, columns: list[str] | None = None) -> int:
    """Convert a TSV to JSONL rows; returns the row count."""
    import csv
    import json

    n = 0
    with open(tsv_path) as fin, open(jsonl_path, "w") as fout:
        for row in csv.reader(fin, delimiter="\t"):
            fout.write(json.dumps(dict(zip(columns, row)) if columns else row) + "\n")
            n += 1
    return n


def convert_colbert_results_to_negatives(
    ranking: dict[int, list[int]] | str, qrels: dict[int, list[int]], num_negatives: int = 10
) -> dict[int, list[int]]:
    """Top-ranked non-positives per query from a ranking (an in-memory
    {qid: [pid, ...]} dict or a ranking TSV path, read in rank order)."""
    if isinstance(ranking, str):
        from fusion_tpu_torch.utils.rankingio import read_ranking_tsv

        ranking = read_ranking_tsv(ranking)
    return {qid: non_positives(preds, qrels.get(qid, ()), num_negatives) for qid, preds in ranking.items()}


def non_positives(ranked: Iterable[int], positives: Iterable[int], num_negatives: int) -> list[int]:
    """The hard-negative rule: the first ``num_negatives`` of ``ranked``
    that are not in ``positives``."""
    positives = set(positives)
    return [p for p in ranked if p not in positives][:num_negatives]


def get_training_filepath(data_dir: str, prefix: str) -> str | None:
    """The first cached training file in ``data_dir`` named ``prefix*``."""
    matches = sorted(glob.glob(os.path.join(data_dir, f"{prefix}*")))
    return matches[0] if matches else None


def push_to_hub(model_path: str, repo_id: str, token: str | None = None) -> bool:  # pragma: no cover
    """Upload a saved model directory to the HF hub; False (with the reason
    printed) where the hub client or the network is unavailable."""
    try:
        from huggingface_hub import HfApi

        api = HfApi(token=token or os.getenv("HF"))
        api.create_repo(repo_id, exist_ok=True)
        api.upload_folder(folder_path=model_path, repo_id=repo_id)
        return True
    except Exception as e:  # noqa: BLE001 - an optional upload reports and carries on
        print(f"push_to_hub unavailable: {e}")
        return False
