"""Drive the fusion_tpu_torch main path once on one NVIDIA GPU and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints its result and wall time; any failed check exits 1):
  1. device  — requires CUDA; prints the card's name and power limit;
  2. build   — compiles the MaxSim kernel (csrc/maxsim.cu) with nvcc;
  3. kernel  — the kernel against its plain PyTorch version on the card, at
               the serving shape (Ld 128, N 28,032, D 128, QL 64x32) and a
               ragged one; |kernel - plain| <= 1e-2 + 1e-3 |plain| (both
               accumulate bf16 products in f32; only the order of the sums
               differs); median CUDA-event times of both over 12 runs;
  4. small   — a tiny searcher on the CPU (plain paths) and on the card
               (kernel path) from the same seeds: per-system sorted scores
               agree within 1e-2 (f32 encoders, bf16-stored corpora: an f32
               difference of an ulp can round a stored value to the
               neighbouring bf16 value, 2^-8 apart relatively);
  5. slice   — HybridSearcher.build at CamemBERT-base width (random seeded
               weights, bf16) over the synthetic zipf corpus of bench.py
               (seed 42, N 27,940, 40-160 words per doc; Lq 32, Ld 128), then
               search 192 queries at batch 64 with every kernel launch count
               set to 0 just before and read just after; checks shapes, id
               range, finite non-increasing scores, that the kernel ran, and
               that the ColBERT leg through the kernel matches the plain path
               on one batch (mean top-100 overlap >= 0.99); then times warm
               batches with CUDA events and reads the peak device memory.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Matmul precision on the card: TF32 off for
matmuls and cuDNN, bf16 reduced-precision reductions off.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_TOL = (1e-2, 1e-3)  # atol, rtol
N_DOCS, BATCH, N_QUERIES, TOPK, LQ, LD, DIM = 27_940, 64, 192, 1000, 32, 128, 128


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def phase(name: str, t0: float, **fields) -> None:
    extra = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{name}] {time.perf_counter() - t0:.3f}s {extra}", flush=True)


def timed_ms(torch, fn, runs: int) -> list[float]:
    """Per-run CUDA-event times (ms) of ``fn()``."""
    out = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return out


def kernel_vs_plain(torch, maxsim, ld, n, d, ql, seed, runs):
    """(max |kernel - plain|, kernel ms median, plain ms median)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    corpus = torch.randn(ld, n, d, device="cuda", generator=gen).to(torch.bfloat16)
    q = torch.randn(ql, d, device="cuda", generator=gen).to(torch.bfloat16)
    got = maxsim.maxsim_maxima_cuda(q, corpus)
    want = maxsim.maxsim_maxima_plain(q, corpus)
    torch.cuda.synchronize()
    check(got.shape == (n, ql) and bool(torch.isfinite(got).all()), f"kernel output bad at {(ld, n, d, ql)}")
    err = (got - want).abs()
    atol, rtol = KERNEL_TOL
    check(bool((err <= atol + rtol * want.abs()).all()), f"kernel disagrees at {(ld, n, d, ql)}: max err {err.max().item()}")
    k_ms, p_ms = [], []
    for _ in range(runs):  # alternate, so drift hits both alike
        k_ms += timed_ms(torch, lambda: maxsim.maxsim_maxima_cuda(q, corpus), 1)
        p_ms += timed_ms(torch, lambda: maxsim.maxsim_maxima_plain(q, corpus), 1)
    return err.max().item(), statistics.median(k_ms), statistics.median(p_ms)


def check_ranked(torch, np, ranked, n_queries, topk, n_docs) -> None:
    """Fused output: int32 [Q, k] ids in [0, N) or -1, no duplicates in a
    row, finite scores that never increase along a row."""
    ids, scores = ranked.ids.numpy(), ranked.scores.numpy()
    check(ranked.ids.dtype == torch.int32 and ids.shape == (n_queries, topk), f"ids {ranked.ids.dtype} {ids.shape}")
    check(bool((((ids >= 0) & (ids < n_docs)) | (ids == -1)).all()), "ids out of range")
    check(bool(np.isfinite(scores).all()), "non-finite fused scores")
    check(bool((np.diff(scores, axis=1) <= 0).all()), "fused scores increase along a row")
    check(all(len(set(r[r >= 0])) == (r >= 0).sum() for r in ids), "duplicate ids in a row")


def colbert_leg_overlap(torch, np, maxsim, searcher, batch) -> float:
    """Mean top-100 overlap of the ColBERT leg as served (through the kernel
    on the card) with the same leg scored by the plain maxima op."""
    from fusion_tpu_torch.core.ranked import ranked_from_scores

    leg = searcher.search_systems(batch, batch_size=len(batch), external_ids=False)["colbert"]
    inputs = searcher._prepare_inputs(batch)
    mask = inputs["cb_mask"].float()
    q_tok = searcher.colbert_model.embed_tokens(inputs["cb_ids"], inputs["cb_mask"])
    corpus_tm, doc_valid = searcher.colbert_index.prepared()
    maxima = maxsim.maxsim_maxima_plain(q_tok.to(torch.bfloat16).flatten(0, 1), corpus_tm)
    plain = (maxima.view(-1, *mask.shape) * mask[None]).sum(-1).T
    plain = ranked_from_scores(torch.where(doc_valid[None], plain, -torch.inf), leg.depth)
    return float(np.mean([
        len(set(a[:100].tolist()) & set(b[:100].tolist())) / min(100, len(a))
        for a, b in zip(leg.ids.numpy(), plain.ids.cpu().numpy())
    ]))


def zipf_corpus(np, n, n_queries, seed=42, vocab=30_000):
    """The synthetic corpus of bench.py: zipf-distributed words t<id>,
    40-160 words per doc; queries of 6 words."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    lens = rng.integers(40, 160, size=n)
    docs = [" ".join(f"t{t}" for t in rng.choice(vocab, size=length, p=p)) for length in lens]
    queries = [" ".join(f"t{t}" for t in rng.choice(vocab, size=6, p=p)) for _ in range(n_queries)]
    return docs, queries


def small_agreement(torch, np):
    """Tiny f32 searcher on the CPU and on the card from the same seeds."""
    from fusion_tpu_torch.models.biencoder import BiEncoder
    from fusion_tpu_torch.models.colbert import ColBERT
    from fusion_tpu_torch.models.encoder import EncoderConfig
    from fusion_tpu_torch.serving import HybridSearcher

    docs, queries = zipf_corpus(np, 300, 9, seed=7, vocab=400)
    corpus = dict(enumerate(docs))
    cfg = EncoderConfig.tiny(vocab_size=512)
    out = {}
    for device in ("cpu", "cuda"):
        kw = dict(max_query_length=LQ, max_doc_length=48, device=device)
        searcher = HybridSearcher.build(
            corpus, bm25_docs=docs, topk=20, batch_size=64, device=device,
            dense_model=BiEncoder(cfg, head="dense", seed=1, **kw),
            splade_model=BiEncoder(cfg, head="splade", seed=2, **kw),
            colbert_model=ColBERT(cfg, dim=16, seed=3, **kw),
        )
        out[device] = searcher.search_systems(queries, batch_size=4)
    worst = 0.0
    for system, ranked in out["cpu"].items():
        a = torch.sort(ranked.scores, dim=1, descending=True).values
        b = torch.sort(out["cuda"][system].scores, dim=1, descending=True).values
        err = (a - b).abs().max().item()
        check(err <= 1e-2, f"small input: {system} scores differ CPU vs card by {err}")
        worst = max(worst, err)
    return worst


def main() -> int:
    import numpy as np
    import torch

    t0 = time.perf_counter()
    check(torch.cuda.is_available(), "no CUDA device: this script measures the card and has no CPU mode")
    check(
        os.path.isdir(os.path.join(REPO, "fusion_tpu_torch")),
        "run chip_smoke.py from the root of a checkout (fusion_tpu_torch/ not found)",
    )
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    phase("device", t0, kind=repr(kind), count=count, torch=torch.__version__, cuda=torch.version.cuda)

    from fusion_tpu_torch.ops import _kernels, maxsim

    t0 = time.perf_counter()
    lib = _kernels.load("maxsim")
    phase("build", t0, nvcc_s=f"{lib.build_seconds:.3f}")
    print(lib.build_log.strip(), flush=True)

    t0 = time.perf_counter()
    err_bench, k_ms, p_ms = kernel_vs_plain(torch, maxsim, LD, 28_032, DIM, BATCH * LQ, seed=0, runs=12)
    phase("kernel", t0, shape="Ld128xN28032xD128xQL2048", max_abs_err=err_bench, kernel_ms=k_ms, plain_ms=p_ms)
    t0 = time.perf_counter()
    err_ragged, _, _ = kernel_vs_plain(torch, maxsim, 37, 1000, DIM, 3 * 29, seed=1, runs=1)
    phase("kernel", t0, shape="Ld37xN1000xD128xQL87", max_abs_err=err_ragged)

    t0 = time.perf_counter()
    small_err = small_agreement(torch, np)
    phase("small", t0, max_sorted_score_diff=small_err)

    from fusion_tpu_torch.models.biencoder import BiEncoder
    from fusion_tpu_torch.models.colbert import ColBERT
    from fusion_tpu_torch.models.encoder import EncoderConfig
    from fusion_tpu_torch.serving import HybridSearcher

    t0 = time.perf_counter()
    docs, queries = zipf_corpus(np, N_DOCS, N_QUERIES)
    cfg = EncoderConfig(dtype=torch.bfloat16, dropout=0.0)  # CamemBERT-base width
    kw = dict(max_query_length=LQ, max_doc_length=LD, device="cuda")
    dense = BiEncoder(cfg, head="dense", seed=11, **kw)
    splade = BiEncoder(cfg, head="splade", seed=12, **kw)
    colbert = ColBERT(cfg, dim=DIM, seed=13, **kw)
    phase("models", t0, layers=cfg.num_layers, hidden=cfg.hidden_size, vocab=cfg.vocab_size)
    t0 = time.perf_counter()
    searcher = HybridSearcher.build(
        dict(enumerate(docs)), bm25_docs=docs, dense_model=dense, splade_model=splade,
        colbert_model=colbert, topk=TOPK, batch_size=256, fusion_method="rrf", device="cuda",
    )
    torch.cuda.synchronize()
    phase("index", t0, systems=",".join(searcher.active_systems), docs=N_DOCS)

    maxsim.maxsim_maxima_cuda.launches = 0
    t0 = time.perf_counter()
    ranked, _ = searcher.search(queries, batch_size=BATCH)
    launches = maxsim.maxsim_maxima_cuda.launches
    phase("search", t0, queries=N_QUERIES, maxsim_launches=launches)
    check(launches >= N_QUERIES // BATCH, f"MaxSim kernel launched {launches} times during search")
    check_ranked(torch, np, ranked, N_QUERIES, TOPK, N_DOCS)

    t0 = time.perf_counter()
    overlap = colbert_leg_overlap(torch, np, maxsim, searcher, queries[:BATCH])
    phase("colbert_leg", t0, top100_overlap_kernel_vs_plain=overlap)
    check(overlap >= 0.99, f"ColBERT leg kernel vs plain top-100 overlap {overlap}")

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    batch_ms = [
        t / (N_QUERIES // BATCH)
        for t in timed_ms(torch, lambda: searcher.search(queries, batch_size=BATCH), 3)
    ]
    phase(
        "timing", t0, ms_per_batch_median=statistics.median(batch_ms),
        ms_per_batch_runs=batch_ms, batch=BATCH, gpu=repr(smi),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
    )

    record = {"kernels": [{
        "name": "maxsim_maxima_T",
        "route": "cuda",
        "source": "fusion_tpu_torch/csrc/maxsim.cu",
        "replaces": "fusion_tpu/ops/maxsim.py:225",
        "launches": launches,
        "max_abs_err": max(err_bench, err_ragged),
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
