"""Stage breakdown of the chunked SPLADE impact leg (the sort form).

The counterpart of ``scripts/probe_chunked_impact.py``.  At mMARCO's shape
(8,912,896 docs, V 32,768, 272 chunks × cap 64, batch 64; postings drawn on
the device from a seeded ``torch.Generator``: uniform local doc ids, f16
impacts in [0.05, 3)) it times the stages of ``chunked_impact_search``
(``index/inverted.py``) in isolation:

  gather        the posting rows of each query term, weighted by the f16
                query weight, laid out as [Q·C, Kq·capc]
  sort2         + a stable ``torch.sort`` of the doc ids and a
                ``torch.gather`` of the values (torch has no multi-operand
                sort)
  sort_packed   + one ``torch.sort`` of a single integer key per posting,
                doc id << 16 | f16 impact bits, as ``chunked_impact_search``
                packs it (the pad 0xFFFF sorts last)
  segscan       + the run totals (``ops/segscan.segmented_run_totals``)
  full          the whole search (k 1,000, local_k 128), both sort forms,
                at Kq 32, 48 and 64

Times are the median of ``--iters`` calls, each between two CUDA events
(``bench_maxsim.device_ms``); with ``--device cpu`` (smoke sizes only) they
are host-clock times of the CPU run, not device times.

Run on the card (one JSON line, under the script's metric name and keys):
    python -m fusion_tpu_torch.tools.probe_chunked_impact
CPU smoke:
    python -m fusion_tpu_torch.tools.probe_chunked_impact --device cpu \\
        --n_docs 4096 --vocab 512 --capc 8 --docs_per_chunk 1024 --batch 4 --iters 2
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from fusion_tpu_torch.core.device import resolve_device
from fusion_tpu_torch.index.inverted import ChunkedImpactIndex, chunked_impact_search
from fusion_tpu_torch.ops.segscan import segmented_run_totals

KQ_SWEEP = (32, 48, 64)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n_docs", type=int, default=8_912_896)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--vocab", type=int, default=32_768)
    ap.add_argument("--capc", type=int, default=64)
    ap.add_argument("--docs_per_chunk", type=int, default=32_768)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (the measurement) or cpu (smoke sizes)")
    return ap.parse_args(argv)


def make_index(n_docs: int, vocab: int, capc: int, docs_per_chunk: int, gen: torch.Generator,
               device) -> ChunkedImpactIndex:
    """Every (term, chunk) row full: ``capc`` uniform local doc ids (stored
    as the port's int16 bits of a uint16) and f16 impacts in [0.05, 3)."""
    c = -(-n_docs // docs_per_chunk)
    shape = (vocab + 1, c, capc)
    post_doc = torch.randint(0, docs_per_chunk, shape, generator=gen, device=device, dtype=torch.int32)
    post_doc = post_doc.to(torch.int16)
    post_imp = (torch.rand(shape, generator=gen, device=device) * 2.95 + 0.05).to(torch.float16)
    return ChunkedImpactIndex(post_doc, post_imp, n_docs=n_docs, docs_per_chunk=docs_per_chunk,
                              vocab_size=vocab, cap_per_chunk=capc, nnz_kept=(vocab + 1) * c * capc)


def make_queries(batch: int, kq: int, vocab: int, gen: torch.Generator, device):
    """(terms int32 [B, Kq] uniform over the vocabulary, weights f32 ones)."""
    terms = torch.randint(0, vocab, (batch, kq), generator=gen, device=device, dtype=torch.int32)
    return terms, torch.ones((batch, kq), device=device)


def gather_stage(index: ChunkedImpactIndex, q_terms, q_weights):
    """(local doc ids int64, f16 weighted impacts), both [Q·C, Kq·capc]."""
    vp1, c, capc = index.post_doc.shape
    q, kq = q_terms.shape
    terms = q_terms.long().clamp(0, vp1 - 1)
    docs = index.post_doc[terms].long() & 0xFFFF
    vals = index.post_impact[terms] * q_weights[..., None, None].to(torch.float16)
    width = kq * capc
    return (docs.permute(0, 2, 1, 3).reshape(q * c, width), vals.permute(0, 2, 1, 3).reshape(q * c, width))


def sort2_stage(index, q_terms, q_weights):
    """Rows sorted by doc id, stable, the values carried by a gather."""
    docs, vals = gather_stage(index, q_terms, q_weights)
    docs_s, order = torch.sort(docs, dim=1, stable=True)
    return docs_s, torch.gather(vals, 1, order)


def pack(docs: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """One int64 key per posting: doc id << 16 | the f16 value's bits."""
    return (docs << 16) | (vals.view(torch.int16).long() & 0xFFFF)


def sort_packed_stage(index, q_terms, q_weights):
    docs, vals = gather_stage(index, q_terms, q_weights)
    return torch.sort(pack(docs, vals), dim=1).values


def segscan_stage(index, q_terms, q_weights):
    """(run totals f32, run ends) of the packed sort's rows."""
    key_s = sort_packed_stage(index, q_terms, q_weights)
    docs_s = key_s >> 16
    vals_s = (key_s & 0xFFFF).to(torch.int16).view(torch.float16)
    return segmented_run_totals(docs_s, vals_s.float(), q_terms.shape[1])


def stage_ms(fn, iters: int, device: torch.device) -> float:
    """Median ms of ``fn()``: CUDA events on the card, the host clock on the
    CPU."""
    if device.type == "cuda":
        from fusion_tpu_torch.tools.bench_maxsim import device_ms

        return device_ms(fn, iters)
    fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run(n_docs: int = 8_912_896, batch: int = 64, vocab: int = 32_768, capc: int = 64,
        docs_per_chunk: int = 32_768, iters: int = 8, device="cuda", seed: int = 0) -> dict:
    """Time every stage; returns the JSON record."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    index = make_index(n_docs, vocab, capc, docs_per_chunk, gen, device)
    report = {"n_docs": n_docs, "batch": batch, "vocab": vocab, "capc": capc, "chunks": index.num_chunks}
    qt, qw = make_queries(batch, 64, vocab, gen, device)
    for name, fn in (("gather", gather_stage), ("gather_sort2", sort2_stage),
                     ("gather_sortpacked", sort_packed_stage), ("gather_sortpacked_segscan", segscan_stage)):
        report[f"kq64_{name}_ms"] = stage_ms(lambda: fn(index, qt, qw), iters, device)
    for kq in KQ_SWEEP:
        qt, qw = make_queries(batch, kq, vocab, gen, device)
        for packed in (False, True):
            label = f"kq{kq}_full_{'packed' if packed else 'sort2'}_ms"
            report[label] = stage_ms(
                lambda: chunked_impact_search(qt, qw, index, k=1000, local_k=128, packed_sort=packed),
                iters, device,
            )
        print(f"# {kq}: {report}", file=sys.stderr, flush=True)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {"metric": "chunked_impact_stage_breakdown", "detail": report, "device": name}


def main(argv=None) -> dict:
    args = parse_args(argv)
    record = run(args.n_docs, args.batch, args.vocab, args.capc, args.docs_per_chunk, args.iters, args.device)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
