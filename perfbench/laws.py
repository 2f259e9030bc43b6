"""How far a cell moves across its length laws, and the lengths of the
documents that its rerank sees.

    python -m perfbench.laws --workload lleqa-rerank-b64 --seed <n> --seconds 10
        --scale query_words.median=0.5 doc_words.median=2 --uniform-heads   (one command line)

Each variant is one run of the cell as ``perfbench.run`` makes it, with one
parameter of a length law multiplied: ``query_words.<key>`` in the traffic
mix, ``doc_words.<key>`` in the configuration's corpus.  The committed laws
run first.  In a cell with a rerank, every run sets the words of the
documents in the fused heads that its window reranks (cut at the
cross-encoder's document cut, as the pairs hold them) beside the corpus's.
``--uniform-heads`` adds a run of the committed laws in which every fused
head is replaced, where the searcher produces it, by documents drawn
uniformly from the corpus, so that the lengths reranked follow the corpus
law; its fused lists are then no RRF, so it reads not correct, and only its
rate is read.  One JSON line per run.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import sys
import time
from contextlib import contextmanager

import numpy as np

from perfbench.run import T0  # noqa: F401 - starts the set-up clock

QUANTILES = (0.1, 0.25, 0.5, 0.75, 0.9)


def scaled(cell: dict, change: str) -> dict:
    """``cell`` with ``<law>.<key>=<factor>`` applied."""
    path, factor = change.split("=")
    law, key = path.split(".")
    out = copy.deepcopy(cell)
    where = out["mix"][law] if law == "query_words" else out["cfg"]["corpus"][law]
    where[key] = where[key] * float(factor)
    return out


@contextmanager
def fused_heads(record: list, uniform_seed: int | None = None):
    """Keep (on the device) the head of every fused list the searcher
    produces; with ``uniform_seed``, first replace each row's head by
    distinct documents drawn uniformly from the corpus."""
    import torch

    from fusion_tpu_torch.core.ranked import RankedLists
    from fusion_tpu_torch.serving import HybridSearcher

    orig = HybridSearcher._fuse
    gens = {}

    def fuse(self, *a, **kw):
        out = orig(self, *a, **kw)
        d = self.rerank_depth
        if not d:
            return out
        if uniform_seed is not None:
            dev = out.ids.device
            gen = gens.setdefault(dev, torch.Generator(device=dev).manual_seed(uniform_seed))
            n = len(self.corpus_ids)
            draw = torch.rand((out.ids.shape[0], n), generator=gen, device=dev).argsort(dim=1)[:, :d]
            ids = out.ids.clone()
            ids[:, :d] = draw.to(ids.dtype)
            out = RankedLists(ids, out.scores)
        record.append(out.ids[:, :d].clone())
        return out

    HybridSearcher._fuse = fuse
    try:
        yield
    finally:
        HybridSearcher._fuse = orig


def lengths(words: np.ndarray) -> dict:
    q = np.quantile(words, QUANTILES)
    return {"mean": float(words.mean()), **{f"q{int(p * 100)}": float(v) for p, v in zip(QUANTILES, q)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--scale", nargs="*", default=[], help="<law>.<key>=<factor>, one run each")
    ap.add_argument("--uniform-heads", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from perfbench import spec
    from perfbench.run import run_cell

    base = spec.cell(args.workload)
    runs = [("committed", base, None)] + [(c, scaled(base, c), None) for c in args.scale]
    if args.uniform_heads:
        runs.append(("uniform_heads", base, args.seed))
    for name, cell, uniform in runs:
        t = time.perf_counter()
        heads: list = []
        with fused_heads(heads, uniform):
            out = run_cell(cell, args.seed, args.seconds, False, device=args.device, t0=t, keep=True)
        kept = out.pop("_keep")
        line = {"variant": name, "correct": out["correct"], "attempted": out["attempted"],
                "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                "query_words": lengths(kept["inputs"].query_words.astype(np.float64)),
                "seconds": time.perf_counter() - t}
        if heads:
            ce_lens = kept["inputs"].ce_doc_lens.astype(np.float64)
            cut = cell["cfg"]["ce_max_length"] - 36  # the pairs' document cut (corpus.py)
            head_ids = np.concatenate([h.cpu().numpy().reshape(-1) for h in heads]).astype(np.int64)
            line["head_doc_words"] = lengths(ce_lens[head_ids])
            line["corpus_doc_words"] = lengths(ce_lens)
            line["head_share_at_cut"] = float((ce_lens[head_ids] >= cut).mean())
            line["corpus_share_at_cut"] = float((ce_lens >= cut).mean())
        print(json.dumps(line), flush=True)
        del kept, out, heads
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
