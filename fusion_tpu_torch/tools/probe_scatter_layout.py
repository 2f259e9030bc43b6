"""Posting-layout probe of the SPLADE scatter leg on one NVIDIA GPU.

The counterpart of ``scripts/probe_scatter_layout.py``, at its default
mMARCO shapes (8,912,896 docs in 544 chunks of 16,384, vocabulary 32,768,
64 query terms, 32 postings per (term, chunk), 64 queries; the index rows
synthesized on the card from a seeded generator as the script draws them):

  * the stage splits of the posting pre-gather, as torch ops:
    ``pregather`` (``_gather_postings``: gather, widen, transpose to
    chunk-major), ``gather_only_i32`` (gather and widen the doc ids),
    ``pregather_2b`` (transpose the 2-byte rows, widen after) and
    ``gather_nt`` (gather without the transpose, term-major);
  * the search through K3 (``scatter_impact_search``, which reads the index
    rows itself) against the search through the term-major pre-gathered
    kernel (``_kernel_nt``'s function: ``gather_nt`` + ``pregathered_search``),
    with the script's check of the two (``nt_scores_match`` at rtol/atol
    1e-5, ``nt_top10_overlap``), and each kernel alone.

Times are device times (``bench_maxsim.device_ms``).

Run on the card (one JSON line, under the script's metric name):
    python -m fusion_tpu_torch.tools.probe_scatter_layout
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from fusion_tpu_torch.index.inverted import ChunkedImpactIndex
from fusion_tpu_torch.ops import scatter_score
from fusion_tpu_torch.tools.bench_maxsim import device_ms

CHUNK_BLOCK = 16  # the scripts' chunk padding of the gathered operands


def synth_index(n_docs=8_912_896, vocab=32_768, dpc=16_384, capc=32, batch=64, kq=64, seed=3,
                device="cuda"):
    """(index, q_terms, q_weights) drawn as the probe scripts draw them:
    uniform doc ids below ``dpc`` in every (term, chunk) row, impacts
    uniform in [0.05, 3) as f16, uniform query terms of weight 1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    c = -(-n_docs // dpc)
    post_doc = torch.randint(0, dpc, (vocab + 1, c, capc), device=device, generator=gen,
                             dtype=torch.int32).to(torch.int16)
    post_imp = (torch.rand(vocab + 1, c, capc, device=device, generator=gen) * 2.95 + 0.05).half()
    index = ChunkedImpactIndex(post_doc, post_imp, n_docs=n_docs, docs_per_chunk=dpc, vocab_size=vocab,
                               cap_per_chunk=capc, nnz_kept=(vocab + 1) * c * capc)
    q_terms = torch.randint(0, vocab, (batch, kq), device=device, generator=gen, dtype=torch.int32)
    return index, q_terms, torch.ones((batch, kq), device=device)


def run(n_docs: int = 8_912_896, batch: int = 64, vocab: int = 32_768, kq: int = 64,
        docs_per_chunk: int = 16_384, capc: int = 32, runs: int = 10) -> dict:
    """Time the stages and the two searches; returns the JSON record."""
    if not torch.cuda.is_available():
        raise RuntimeError("the scatter layout probe measures the card: no CUDA device is available")
    index, qt, qw = synth_index(n_docs, vocab, docs_per_chunk, capc, batch, kq)
    pd, pi = index.post_doc, index.post_impact
    report = {"n_docs": n_docs, "batch": batch, "vocab": vocab, "kq": kq, "docs_per_chunk": docs_per_chunk,
              "cap_per_chunk": capc, "chunks": pd.shape[1], "runs": runs, "device": torch.cuda.get_device_name(0)}

    def gather_only():
        return pd[qt.long().clamp(0, pd.shape[0] - 1)].to(torch.int32) & 0xFFFF

    def pregather_2b():
        q, c = qt.shape[0], pd.shape[1]
        terms = qt.long().clamp(0, pd.shape[0] - 1)
        docs = pd[terms].transpose(1, 2).reshape(q, c, kq * capc).to(torch.int32) & 0xFFFF
        vals = pi[terms].transpose(1, 2).reshape(q, c, kq * capc).to(torch.bfloat16)
        return docs, vals * qw.to(torch.bfloat16).repeat_interleave(capc, dim=1)[:, None, :]

    def gather_nt():
        return scatter_score.gather_postings_term_major(qt, qw, pd, pi, CHUNK_BLOCK)

    def search_nt():
        docs, vals = gather_nt()
        return scatter_score.pregathered_search(docs, vals, n_docs, docs_per_chunk, k=1000, layout="term_major")

    base = scatter_score.scatter_impact_search(qt, qw, index, k=1000)
    nt = search_nt()
    ids_b, sc_b = base.ids.cpu().numpy(), base.scores.cpu().numpy()
    ids_n, sc_n = nt.ids.cpu().numpy(), nt.scores.cpu().numpy()
    report["nt_scores_match"] = bool(np.allclose(sc_b, sc_n, rtol=1e-5, atol=1e-5, equal_nan=True))
    report["nt_top10_overlap"] = float(np.mean([len(set(a[:10]) & set(b[:10])) / 10 for a, b in zip(ids_b, ids_n)]))

    report["pregather_ms"] = device_ms(
        lambda: scatter_score._gather_postings(qt, qw, pd, pi, CHUNK_BLOCK), runs)
    report["gather_only_i32_ms"] = device_ms(gather_only, runs)
    report["pregather_2b_ms"] = device_ms(pregather_2b, runs)
    report["gather_nt_ms"] = device_ms(gather_nt, runs)
    report["scatter_baseline_ms"] = device_ms(lambda: scatter_score.scatter_impact_search(qt, qw, index, k=1000), runs)
    report["scatter_nt_ms"] = device_ms(search_nt, runs)
    docs4, vals4 = gather_nt()
    report["k3_kernel_ms"] = device_ms(
        lambda: scatter_score.scatter_binmax_cuda(qt, qw, pd, pi, docs_per_chunk), runs)
    report["nt_kernel_ms"] = device_ms(
        lambda: scatter_score.scatter_pregathered_cuda(docs4, vals4, docs_per_chunk, "term_major"), runs)
    return {"metric": "scatter_layout_probe", "detail": report}


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
        print("no CUDA device: the scatter layout probe measures the card", file=sys.stderr)
        return 1
    record = run(args.n_docs, args.batch, args.vocab, args.kq, args.docs_per_chunk, args.capc, args.runs)
    print(json.dumps(record), flush=True)
    return 0 if record["detail"]["nt_scores_match"] else 1


if __name__ == "__main__":
    sys.exit(main())
