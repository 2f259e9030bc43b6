"""doc_block sweep of the binned dense top-k on one NVIDIA GPU.

The counterpart of ``scripts/probe_dense.py``: at the mMARCO serving shape
(8,912,896 int8 rows × 768, synthesized on the card from a seeded generator:
l2-normalized gaussian rows quantized per row, 6.85 GB; 64 gaussian
queries) it times

  * ``fused_dense_topk`` (K2 + the stable top-k of the bins) at doc_block
    2048, 4096 and 8192, k 1000;
  * k 100 and 1000 at doc_block 4096 (the select's share);
  * the no-mask variant (``dead_rows=False``: ``_binmax_nomask``'s function,
    the kernel without the dead-row term) at doc_block 4096;

and, beside each, the binned kernel alone.  Times are device times
(``bench_maxsim.device_ms``: the median of ``runs`` calls, each between two
CUDA events queued behind a short device sleep).  The top-k's sort runs on
the device too, so the fused times hold no host round trip.

Run on the card (one JSON line, under the script's metric name):
    python -m fusion_tpu_torch.tools.probe_dense [--n_docs 8912896] [--batch 64]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from fusion_tpu_torch.index.dense_quant import QuantizedDenseIndex
from fusion_tpu_torch.models.heads import l2_normalize
from fusion_tpu_torch.ops import dense_topk
from fusion_tpu_torch.tools.bench_maxsim import device_ms

H, CHUNK = 768, 131_072  # embedding width; rows synthesized per step


def synth_corpus(n: int, h: int = H, seed: int = 2, device="cuda") -> QuantizedDenseIndex:
    """``n`` l2-normalized gaussian rows, symmetric int8 per row (scale =
    max |x| / 127), made in steps of ``CHUNK`` rows from one generator."""
    gen = torch.Generator(device=device).manual_seed(seed)
    values = torch.empty((n, h), dtype=torch.int8, device=device)
    scales = torch.empty(n, device=device)
    for s in range(0, n, CHUNK):
        x = torch.randn(min(CHUNK, n - s), h, device=device, generator=gen)
        x = x / x.norm(dim=1, keepdim=True)
        sc = torch.clamp(x.abs().amax(dim=1) / 127.0, min=1e-12)
        values[s : s + x.shape[0]] = torch.clamp(torch.round(x / sc[:, None]), -127, 127).to(torch.int8)
        scales[s : s + x.shape[0]] = sc
    return QuantizedDenseIndex(values, scales, normalized=True)


def run(n_docs: int = 8_912_896, batch: int = 64, runs: int = 10, seed: int = 2) -> dict:
    """Time every configuration of the sweep; returns the JSON record."""
    if not torch.cuda.is_available():
        raise RuntimeError("the dense probe measures the card: no CUDA device is available")
    n = n_docs - n_docs % CHUNK
    index = synth_corpus(n, seed=seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    q = torch.randn(batch, H, device="cuda", generator=gen)
    qb = l2_normalize(q).to(torch.bfloat16)
    report = {"n_docs": n, "batch": batch, "runs": runs, "device": torch.cuda.get_device_name(0)}

    def fused(db, k=1000, dead_rows=True):
        return lambda: dense_topk.fused_dense_topk(q, index, k=k, doc_block=db, dead_rows=dead_rows)

    def kernel(db, dead_rows=True):
        return lambda: dense_topk.binmax_cuda(qb, index.values, index.scales, n, db, dead_rows)

    for db in dense_topk.KERNEL_DOC_BLOCKS:
        report[f"fused_db{db}_ms"] = device_ms(fused(db), runs)
        report[f"binmax_db{db}_ms"] = device_ms(kernel(db), runs)
    for k in (100, 1000):
        report[f"fused_db4096_k{k}_ms"] = device_ms(fused(4096, k), runs)
    report["fused_db4096_nomask_ms"] = device_ms(fused(4096, dead_rows=False), runs)
    report["binmax_db4096_nomask_ms"] = device_ms(kernel(4096, dead_rows=False), runs)
    return {"metric": "dense_fused_block_sweep", "detail": report}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n_docs", type=int, default=8_912_896)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--runs", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: the dense probe measures the card", file=sys.stderr)
        return 1
    print(json.dumps(run(args.n_docs, args.batch, args.runs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
