"""Scatter-kernel probe on pre-gathered operands on one NVIDIA GPU.

The counterpart of ``scripts/probe_scatter_kernel.py``, at its default
mMARCO shapes (``probe_scatter_layout.synth_index``): the postings are
gathered once, chunk-major ``[Q, Cp, Kq·capc]`` (``_gather_postings``), and
the probe times

  * K3 (``scatter_binmax_cuda``), which reads the index rows itself — the
    serving kernel, where the script times ``_scatter_kernel`` on the
    gathered operands;
  * the pre-gathered kernel on the chunk-major operands
    (``scatter_pregathered_cuda``: ``_b3d_kernel``'s function, which is
    ``_scatter_kernel``'s), against its plain version (``max_abs_err`` of the
    unpacked bin scores, equal -inf patterns);
  * ``select_topk``: the stable top-1000 over the packed bins.

The script's chunk-block sweeps (``cb`` 2–32) are grid sizes of the TPU
kernels, which carry the chunk axis through VMEM in blocks; on Hopper
persistent thread blocks walk the (query, chunk) items, so there is no such
parameter and no sweep is reported.  Times are device times (``bench_maxsim.device_ms``).

Run on the card (one JSON line, under the script's metric name):
    python -m fusion_tpu_torch.tools.probe_scatter_kernel
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from fusion_tpu_torch.ops import dense_topk, scatter_score
from fusion_tpu_torch.tools.bench_maxsim import device_ms
from fusion_tpu_torch.tools.probe_scatter_layout import synth_index

CHUNK_BLOCK = 32  # the script gathers once at its largest chunk block


def run(n_docs: int = 8_912_896, batch: int = 64, vocab: int = 32_768, kq: int = 64,
        docs_per_chunk: int = 16_384, capc: int = 32, runs: int = 10) -> dict:
    """Time K3, the chunk-major pre-gathered kernel and the select; returns
    the JSON record."""
    if not torch.cuda.is_available():
        raise RuntimeError("the scatter kernel probe measures the card: no CUDA device is available")
    index, qt, qw = synth_index(n_docs, vocab, docs_per_chunk, capc, batch, kq)
    docs, vals = scatter_score._gather_postings(qt, qw, index.post_doc, index.post_impact, CHUNK_BLOCK)
    q, c_pad, w = docs.shape
    report = {"n_docs": n_docs, "batch": batch, "vocab": vocab, "kq": kq, "docs_per_chunk": docs_per_chunk,
              "capc": capc, "chunks": index.post_doc.shape[1], "pregathered": [q, c_pad, w], "runs": runs,
              "chunk_block": "none on Hopper: persistent thread blocks walk the (query, chunk) items",
              "device": torch.cuda.get_device_name(0)}
    got = scatter_score.scatter_pregathered_cuda(docs, vals, docs_per_chunk)
    want = scatter_score.scatter_pregathered_plain(docs, vals, docs_per_chunk)
    fin = torch.isfinite(want)
    clean = lambda x: (x.view(torch.int32) & -16).view(torch.float32)  # noqa: E731
    report["pattern_equal"] = bool((torch.isfinite(got) == fin).all())
    report["max_abs_err"] = torch.where(fin, (clean(got) - clean(want)).abs(), 0.0).max().item()
    del want, fin
    report["k3_ms"] = device_ms(
        lambda: scatter_score.scatter_binmax_cuda(qt, qw, index.post_doc, index.post_impact, docs_per_chunk), runs)
    report["pregathered_chunk_major_ms"] = device_ms(
        lambda: scatter_score.scatter_pregathered_cuda(docs, vals, docs_per_chunk), runs)
    report["select_topk_ms"] = device_ms(
        lambda: dense_topk._select_topk(got, n_docs, 1000, docs_per_chunk), runs)
    return {"metric": "scatter_kernel_ab", "detail": report}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n_docs", type=int, default=8_912_896)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--vocab", type=int, default=32_768)
    ap.add_argument("--kq", type=int, default=64)
    ap.add_argument("--docs_per_chunk", type=int, default=16_384)
    ap.add_argument("--capc", type=int, default=32)
    ap.add_argument("--runs", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: the scatter kernel probe measures the card", file=sys.stderr)
        return 1
    record = run(args.n_docs, args.batch, args.vocab, args.kq, args.docs_per_chunk, args.capc, args.runs)
    print(json.dumps(record), flush=True)
    return 0 if record["detail"]["pattern_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
