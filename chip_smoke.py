"""Drive the fusion_tpu_torch main paths once on one NVIDIA GPU and check them.

Run from the root of a checkout:  python3 chip_smoke.py [--profile]

Phases (each prints its result and wall time; any failed check exits 1):
  1. device   — requires CUDA; prints the card's name and power limit;
  2. build    — compiles the three kernels (csrc/maxsim.cu, dense_topk.cu,
                scatter_score.cu), one nvcc each, all at once; prints their
                register / shared-memory reports;
  3. kernel   — K1 (MaxSim) against its plain version at the serving shape
                (Ld 128, N 28,032, D 128, QL 64x32) and a ragged one;
                |kernel - plain| <= 1e-2 + 1e-3 |plain| (bf16 products
                accumulated in f32 in another order); median CUDA-event
                times over 10 alternating runs;
  4. k2       — K2 (int8 matmul + 16-doc binned max) against its plain version
                at the serving shape (Q 64, H 768, N 8,912,896, seeded int8
                rows, every 97th row dead) and a ragged one (Q 37, N 100,003
                padded to 2048-doc blocks with scale-0 rows, masked by
                n_docs): the -inf pattern equal, unpacked bin scores within
                1e-5 + 4e-6 |plain| (f32 sums of bf16 products in another
                order; the packing clears 4 mantissa bits, 2^-19 relative, on
                each side), and the in-bin offsets equal wherever the plain
                bin's two best scores differ by more than that; median times
                over 10 alternating runs;
  5. k3       — K3 (the scatter scorer) likewise at the mMARCO serving shape
                (Q 64, Kq 64, docs_per_chunk 16,384, capc 32, C 544, V 32,005)
                and a ragged one (Q 5, Kq 7, docs_per_chunk 2048, 3 chunks,
                sentinel-padded rows, an empty last chunk, pad query terms):
                scores within 1e-6 + 1e-5 |plain| (a doc's score is an f32
                sum of at most Kq bf16 values; the kernel's shared-memory
                atomics add them in another order on every run);
  6. small    — a tiny searcher on the CPU (plain paths) and on the card
                (kernels) from the same seeds: per-system sorted scores agree
                within 1e-2 (f32 encoders, bf16/int8-stored corpora: an ulp
                of f32 difference can round a stored or query value to its
                bf16 neighbour, 2^-8 apart relatively);
  7. scale_small — the same for a tiny scale-mode searcher with an int8
                corpus (dense_impl="fused", splade_impl="scatter"), 1e-2;
  8. slice    — HybridSearcher.build at CamemBERT-base width (random seeded
                weights, bf16) over the synthetic zipf corpus of bench.py
                (seed 42, N 27,940, 40-160 words per doc; Lq 32, Ld 128), then
                search 192 queries at batch 64 with every kernel launch count
                set to 0 just before and read just after; checks shapes, id
                range, finite non-increasing scores, that K1 ran, and that
                the ColBERT leg through the kernel matches the plain path on
                one batch (mean top-100 overlap >= 0.99); times warm batches
                with CUDA events and reads the peak device memory;
  9. scale_build — HybridSearcher.build(scale_mode=True, int8_corpus=True,
                dense_impl="fused", splade_impl="scatter") over the same
                corpus and models, all four legs (impact_cap 1024: at 14
                chunks of 2048 docs, 64 query terms x the equal-mass
                per-chunk cap must fit the 8,192-posting layout); search 192
                queries at batch 64: K1, K2 and K3 each launch; fused output
                checked; warm timing and peak memory;
 10. scale_mmarco — the three-leg scale-mode searcher (BM25 impact index, int8
                DPR, SPLADE scatter + exact rescore) at mMARCO's 8,912,896 docs:
                the query side is real (tokenizers, the zipf BM25Index, the
                CamemBERT-width DPR and SPLADE encoders), the index arrays are
                synthesized on the card from seeded generators at
                BENCH_MMARCO_r05.json's serving-default shapes (BM25 cap 2048
                over the BM25Index's own vocabulary; int8 DPR H 768; SPLADE
                chunks of 16,384 docs, capc 32, rescore store K 128 at depth
                512, over the encoder's 32,005 terms); search 192 queries at
                batch 64: K2 and K3 launch; fused output checked; the DPR and
                SPLADE legs through the kernels against the same legs through
                the plain versions on one batch (top-100 overlap >= 0.99);
                warm timing and peak memory.

``--profile`` adds a torch.profiler pass over one warm search of each
searcher and prints the device busy share and the top kernels.

The line before the last is the kernels' JSON record (launches from the
slice's search for K1 and the mMARCO search for K2 and K3); the last line is
{"ok": true, "device": {...}}.  Matmul precision on the card: TF32 off for
matmuls and cuDNN, bf16 reduced-precision reductions off.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_TOL = (1e-2, 1e-3)  # K1: atol, rtol
K2_TOL = (1e-5, 4e-6)
K3_TOL = (1e-6, 1e-5)
N_DOCS, BATCH, N_QUERIES, TOPK, LQ, LD, DIM = 27_940, 64, 192, 1000, 32, 128, 128
RUNS = 10  # alternating kernel / plain timing runs
MM_DOCS, MM_H, MM_DPC, MM_CAPC, MM_BM25_CAP, MM_STORE_K, MM_DEPTH = (
    8_912_896, 768, 16_384, 32, 2048, 128, 512,
)
SPLADE_VOCAB = 32_005  # CamemBERT's vocabulary: the SPLADE encoder's output width


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


def alternating_ms(torch, kernel_fn, plain_fn, runs: int) -> tuple[float, float]:
    """Median CUDA-event times of kernel and plain, taken in turns so drift
    hits both alike."""
    k_ms, p_ms = [], []
    for _ in range(runs):
        k_ms += timed_ms(torch, kernel_fn, 1)
        p_ms += timed_ms(torch, plain_fn, 1)
    return statistics.median(k_ms), statistics.median(p_ms)


def kernel_vs_plain(torch, maxsim, ld, n, d, ql, seed, runs):
    """K1: (max |kernel - plain|, kernel ms median, plain ms median)."""
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
    k_ms, p_ms = alternating_ms(
        torch, lambda: maxsim.maxsim_maxima_cuda(q, corpus),
        lambda: maxsim.maxsim_maxima_plain(q, corpus), runs,
    ) if runs else (None, None)
    return err.max().item(), k_ms, p_ms


def unpack_bins(torch, packed):
    """Packed bin maxima → (clean scores, in-bin offsets)."""
    bits = packed.view(torch.int32)
    clean = torch.where(torch.isfinite(packed), (bits & -16).view(torch.float32), -torch.inf)
    return clean, bits & 0xF


def compare_bins(torch, got, want, gap, tol, label):
    """Kernel vs plain packed bins: the -inf pattern equal, clean scores within
    tol, offsets equal where the plain bin's two best scores are more than
    the tolerance apart.  Returns the max |error| of the clean scores."""
    atol, rtol = tol
    g, g_off = unpack_bins(torch, got)
    w, w_off = unpack_bins(torch, want)
    check(got.shape == want.shape, f"{label}: shapes {tuple(got.shape)} vs {tuple(want.shape)}")
    check(not bool(torch.isnan(got).any()), f"{label}: NaN in the kernel's output")
    fin = torch.isfinite(w)
    check(bool((torch.isfinite(g) == fin).all()), f"{label}: the -inf pattern differs")
    err = torch.where(fin, (g - w).abs(), 0.0)
    bound = atol + rtol * w.abs()
    check(bool((err <= torch.where(fin, bound, 1.0)).all()), f"{label}: max err {err.max().item()}")
    clear = fin & (gap > atol + rtol * w.abs())
    bad = int((clear & (g_off != w_off)).sum())
    check(bad == 0, f"{label}: {bad} bin offsets differ where the plain top-2 are apart")
    return err.max().item(), int(clear.sum())


def k2_gap(torch, dense_topk, q, values, scales, n_docs, rows_per_step=65536):
    """Per bin: plain best score minus second best (f32 [Q, N/16])."""
    from fusion_tpu_torch.ops.mips import matmul_f32

    n_pad = values.shape[0]
    gap = torch.empty((q.shape[0], n_pad // 16), device=q.device)
    lane = torch.arange(128, device=q.device)
    for start in range(0, n_pad, rows_per_step):
        vals = values[start : start + rows_per_step]
        nb = vals.shape[0] // 2048
        raw = matmul_f32(q, vals.to(torch.bfloat16).T)
        sc = dense_topk._apply_scales(raw, scales[start : start + rows_per_step])
        doc = start + (torch.arange(nb, device=q.device)[:, None, None] * 2048
                       + torch.arange(16, device=q.device)[None, :, None] * 128 + lane)
        sc = torch.where(doc < n_docs, sc.view(-1, nb, 16, 128), -torch.inf)
        top2 = torch.topk(sc, 2, dim=2).values  # [Q, nb, 2, 128]
        gap[:, start // 16 : start // 16 + nb * 128] = (top2[:, :, 0] - top2[:, :, 1]).reshape(q.shape[0], -1)
    return gap


def k2_check(torch, dense_topk, q_n, n_real, n_pad, h, seed, runs, dead_every=97, device="cuda"):
    """K2 at one shape: (max error, checked bins, kernel ms, plain ms)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    values = torch.randint(-127, 128, (n_pad, h), device=device, generator=gen, dtype=torch.int8)
    scales = torch.rand(n_pad, device=device, generator=gen) * 2e-3 + 5e-4
    scales[::dead_every] = 0.0
    scales[n_real:] = 0.0  # the build pads: scale 0, masked by n_docs
    q = torch.randn(q_n, h, device=device, generator=gen)
    q = (q / q.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    got = dense_topk.binmax_cuda(q, values, scales, n_real)
    want = dense_topk.binmax_plain(q, values, scales, n_real)
    torch.cuda.synchronize()
    gap = k2_gap(torch, dense_topk, q, values, scales, n_real)
    err, checked = compare_bins(torch, got, want, gap, K2_TOL, f"K2 Q{q_n} N{n_real}")
    del gap
    k_ms = p_ms = None
    if runs:
        k_ms, p_ms = alternating_ms(
            torch, lambda: dense_topk.binmax_cuda(q, values, scales, n_real),
            lambda: dense_topk.binmax_plain(q, values, scales, n_real), runs,
        )
    return err, checked, k_ms, p_ms


def k3_gap(torch, scatter_score, q_terms, q_weights, post_doc, post_impact, dpc, cb=16):
    """Per bin: plain best score minus second best (f32 [Q, C·dpc/16])."""
    h = scatter_score._plan(dpc)
    c = post_doc.shape[1]
    docs, vals = scatter_score._gather_postings(q_terms, q_weights, post_doc, post_impact, cb)
    q = q_terms.shape[0]
    gap = torch.empty((q, docs.shape[1], dpc // 16), device=q_terms.device)
    for ci in range(0, docs.shape[1], cb):
        sc = scatter_score._chunk_scores(docs[:, ci : ci + cb], vals[:, ci : ci + cb], h)
        top2 = torch.topk(sc.reshape(q, -1, 16, dpc // 16), 2, dim=2).values
        gap[:, ci : ci + cb] = top2[:, :, 0] - top2[:, :, 1]
    return gap[:, :c].reshape(q, -1)


def k3_inputs(torch, seed, q_n, kq, vocab, n_chunks, capc, dpc, pad_rows=False, device="cuda"):
    """Seeded chunked-index rows and a query batch (queries have distinct
    terms; every 5th query ends in pad terms of weight 0)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    post_doc = torch.randint(0, dpc, (vocab + 1, n_chunks, capc), device=device,
                             generator=gen, dtype=torch.int32).to(torch.int16)
    post_impact = (torch.rand(vocab + 1, n_chunks, capc, device=device, generator=gen)
                   * 2.95 + 0.05).to(torch.float16)
    if pad_rows:  # short posting lists, and a last chunk with none
        fill = torch.rand(vocab + 1, n_chunks, capc, device=device, generator=gen) < 0.6
        fill[:, -1] = False
        post_doc = torch.where(fill, post_doc, torch.full_like(post_doc, -1))
        post_impact = torch.where(fill, post_impact, torch.zeros_like(post_impact))
    post_doc[vocab], post_impact[vocab] = -1, 0.0  # the sentinel row of pad terms
    q_terms = torch.argsort(torch.rand(q_n, vocab, device=device, generator=gen), dim=1)[:, :kq]
    q_terms = q_terms.to(torch.int32).contiguous()
    q_weights = torch.rand(q_n, kq, device=device, generator=gen) * 0.95 + 0.05
    q_terms[::5, kq - kq // 4 :] = vocab
    q_weights[::5, kq - kq // 4 :] = 0.0
    return q_terms, q_weights, post_doc.contiguous(), post_impact.contiguous()


def k3_check(torch, scatter_score, seed, q_n, kq, vocab, n_chunks, capc, dpc, runs,
             pad_rows=False, device="cuda"):
    """K3 at one shape: (max error, checked bins, kernel ms, plain ms)."""
    args = k3_inputs(torch, seed, q_n, kq, vocab, n_chunks, capc, dpc, pad_rows, device)
    got = scatter_score.scatter_binmax_cuda(*args, dpc)
    want = scatter_score.scatter_binmax_plain(*args, dpc)
    torch.cuda.synchronize()
    gap = k3_gap(torch, scatter_score, *args, dpc)
    err, checked = compare_bins(torch, got, want, gap, K3_TOL, f"K3 Q{q_n} C{n_chunks} dpc{dpc}")
    del gap
    k_ms = p_ms = None
    if runs:
        k_ms, p_ms = alternating_ms(
            torch, lambda: scatter_score.scatter_binmax_cuda(*args, dpc),
            lambda: scatter_score.scatter_binmax_plain(*args, dpc), runs,
        )
    return err, checked, k_ms, p_ms


def check_ranked(torch, np, ranked, n_queries, topk, n_docs) -> None:
    """Fused output: int32 [Q, k] ids in [0, N) or -1, no duplicates in a
    row, finite scores that never increase along a row."""
    ids, scores = ranked.ids.numpy(), ranked.scores.numpy()
    check(ranked.ids.dtype == torch.int32 and ids.shape == (n_queries, topk), f"ids {ranked.ids.dtype} {ids.shape}")
    check(bool((((ids >= 0) & (ids < n_docs)) | (ids == -1)).all()), "ids out of range")
    check(bool(np.isfinite(scores).all()), "non-finite fused scores")
    check(bool((np.diff(scores, axis=1) <= 0).all()), "fused scores increase along a row")
    check(all(len(set(r[r >= 0])) == (r >= 0).sum() for r in ids), "duplicate ids in a row")


def overlap100(np, a, b) -> float:
    """Mean top-100 overlap of two [Q, k] id arrays (pads excluded)."""
    out = []
    for x, y in zip(a, b):
        x, y = x[:100], y[:100]
        x, y = set(x[x >= 0].tolist()), set(y[y >= 0].tolist())
        out.append(len(x & y) / max(1, len(y)))
    return float(np.mean(out))


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
    return overlap100(np, leg.ids.numpy(), plain.ids.cpu().numpy())


def scale_legs_overlap(torch, np, searcher, batch) -> dict[str, float]:
    """Top-100 overlap of the DPR and SPLADE legs as served (through K2 and
    K3) with the same legs through the kernels' plain versions."""
    from fusion_tpu_torch.index.inverted import activations_to_query_terms
    from fusion_tpu_torch.index.sparse import sparse_rescore
    from fusion_tpu_torch.models.heads import l2_normalize
    from fusion_tpu_torch.ops import dense_topk, scatter_score

    legs = searcher.search_systems(batch, batch_size=len(batch), external_ids=False)
    inputs = searcher._prepare_inputs(batch)
    dc, n = searcher.dense_corpus, searcher.dense_n_docs
    q = searcher.dense_model.embed_tokens(inputs["q_ids"], inputs["q_mask"]).float()
    qb = (l2_normalize(q) if dc.normalized else q).to(torch.bfloat16)
    packed = dense_topk.binmax_plain(qb, dc.values, dc.scales, n)
    dpr = dense_topk._select_topk(packed, n, min(searcher.topk, n), 2048)
    sp = searcher.splade_model.embed_tokens(inputs["sp_ids"], inputs["sp_mask"]).float()
    if searcher.splade_model.similarity == "cos_sim":
        sp = l2_normalize(sp)
    terms, weights = activations_to_query_terms(sp, searcher.splade_query_terms)
    idx = searcher.splade_scatter_index
    packed = scatter_score.scatter_binmax_plain(terms, weights, idx.post_doc, idx.post_impact, idx.docs_per_chunk)
    cand = dense_topk._select_topk(packed, idx.n_docs, searcher.splade_rescore_depth, idx.docs_per_chunk)
    splade = sparse_rescore(sp, cand.ids, searcher.splade_rescore_store,
                            k=min(searcher.topk, cand.ids.shape[1]))
    return {
        "dpr": overlap100(np, legs["dpr"].ids.numpy(), dpr.ids.cpu().numpy()),
        "splade": overlap100(np, legs["splade"].ids.numpy(), splade.ids.cpu().numpy()),
    }


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


def small_agreement(torch, np, scale: bool):
    """Tiny f32 searcher on the CPU and on the card from the same seeds
    (``scale``: scale mode with an int8 corpus, K2 and K3 forced)."""
    from fusion_tpu_torch.models.biencoder import BiEncoder
    from fusion_tpu_torch.models.colbert import ColBERT
    from fusion_tpu_torch.models.encoder import EncoderConfig
    from fusion_tpu_torch.serving import HybridSearcher

    docs, queries = zipf_corpus(np, 300, 9, seed=7, vocab=400)
    corpus = dict(enumerate(docs))
    cfg = EncoderConfig.tiny(vocab_size=512)
    opts = dict(
        scale_mode=True, int8_corpus=True, dense_impl="fused", splade_impl="scatter",
        impact_cap=64,
    ) if scale else {}
    out = {}
    for device in ("cpu", "cuda"):
        kw = dict(max_query_length=LQ, max_doc_length=48, device=device)
        searcher = HybridSearcher.build(
            corpus, bm25_docs=docs, topk=20, batch_size=64, device=device,
            dense_model=BiEncoder(cfg, head="dense", seed=1, **kw),
            splade_model=BiEncoder(cfg, head="splade", seed=2, **kw),
            colbert_model=ColBERT(cfg, dim=16, seed=3, **kw), **opts,
        )
        out[device] = searcher.search_systems(queries, batch_size=4)
    worst = 0.0
    for system, ranked in out["cpu"].items():
        a = torch.sort(ranked.scores, dim=1, descending=True).values
        b = torch.sort(out["cuda"][system].scores, dim=1, descending=True).values
        fin = torch.isfinite(a)
        check(bool((fin == torch.isfinite(b)).all()), f"small input: {system} -inf pattern differs")
        err = torch.where(fin, (a - b).abs(), 0.0).max().item()
        check(err <= 1e-2, f"small input: {system} scores differ CPU vs card by {err}")
        worst = max(worst, err)
    return worst


def reset_counts(maxsim, dense_topk, scatter_score) -> None:
    maxsim.maxsim_maxima_cuda.launches = 0
    dense_topk.binmax_cuda.launches = 0
    scatter_score.scatter_binmax_cuda.launches = 0


def counts(maxsim, dense_topk, scatter_score) -> dict[str, int]:
    return {
        "K1": maxsim.maxsim_maxima_cuda.launches,
        "K2": dense_topk.binmax_cuda.launches,
        "K3": scatter_score.scatter_binmax_cuda.launches,
    }


def warm_timing(torch, searcher, queries, name, smi) -> dict:
    """ms per 64-query batch over 3 warm searches, and the peak memory."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    batch_ms = [
        t / (len(queries) // BATCH)
        for t in timed_ms(torch, lambda: searcher.search(queries, batch_size=BATCH), 3)
    ]
    out = dict(
        ms_per_batch_median=statistics.median(batch_ms), ms_per_batch_runs=batch_ms,
        batch=BATCH, gpu=repr(smi), peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    phase(f"{name}_timing", t0, **out)
    return out


def profile_search(torch, searcher, queries, name) -> None:
    """Device busy share of one warm search, and its top kernels."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        searcher.search(queries, batch_size=BATCH)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - w0) * 1000
    averages = prof.key_averages()
    events = [e for e in averages if e.device_type.name == "CUDA"]
    dev_ms = sum(e.self_device_time_total for e in events) / 1000
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    host = sorted((e for e in averages if e.device_type.name == "CPU"),
                  key=lambda e: -e.self_cpu_time_total)[:8]
    phase(
        f"{name}_profile", t0, wall_ms=wall_ms, device_ms=dev_ms,
        busy_share=dev_ms / wall_ms if wall_ms else None,
        top=[(e.key[:60], round(e.self_device_time_total / 1000, 3)) for e in top],
        top_host=[(e.key[:40], e.count, round(e.self_cpu_time_total / 1000, 3)) for e in host],
    )


def synth_mmarco(torch, np, bm25, gen_seed=21, device="cuda", n=MM_DOCS, ch=131_072):
    """mMARCO-size index arrays on the card from seeded generators (the
    shapes of BENCH_MMARCO_r05.json's serving defaults, the vocabularies of
    the real query side)."""
    from fusion_tpu_torch.index.dense_quant import QuantizedDenseIndex
    from fusion_tpu_torch.index.inverted import ChunkedImpactIndex, ImpactIndex
    from fusion_tpu_torch.index.sparse import SpladeRescoreStore

    gen = torch.Generator(device=device).manual_seed(gen_seed)
    # BM25: cap 2048 over the BM25Index's own V; row V is the sentinel row
    v = bm25.vocab_size
    post_doc = torch.randint(0, n, (v + 1, MM_BM25_CAP), device=device, generator=gen, dtype=torch.int32)
    post_imp = (torch.rand(v + 1, MM_BM25_CAP, device=device, generator=gen) * 2.95 + 0.05).half()
    post_doc[v], post_imp[v] = n, 0.0
    bm25_ii = ImpactIndex(post_doc, post_imp, n_docs=n, vocab_size=v, cap=MM_BM25_CAP,
                          nnz_kept=v * MM_BM25_CAP)
    # DPR: l2-normalized gaussian rows, per-row int8, in chunks
    values = torch.empty((n, MM_H), dtype=torch.int8, device=device)
    scales = torch.empty(n, device=device)
    for s in range(0, n, ch):
        x = torch.randn(ch, MM_H, device=device, generator=gen)
        x = x / x.norm(dim=1, keepdim=True)
        sc = torch.clamp(x.abs().amax(dim=1) / 127.0, min=1e-12)
        values[s : s + ch] = torch.clamp(torch.round(x / sc[:, None]), -127, 127).to(torch.int8)
        scales[s : s + ch] = sc
    dense = QuantizedDenseIndex(values, scales, normalized=True)
    # SPLADE: chunked index over the encoder's vocabulary (row V sentinel)
    vs, c = SPLADE_VOCAB, n // MM_DPC
    sp_doc = torch.randint(0, MM_DPC, (vs + 1, c, MM_CAPC), device=device, generator=gen,
                           dtype=torch.int32).to(torch.int16)
    sp_imp = (torch.rand(vs + 1, c, MM_CAPC, device=device, generator=gen) * 2.95 + 0.05).half()
    sp_doc[vs], sp_imp[vs] = -1, 0.0
    scatter = ChunkedImpactIndex(sp_doc, sp_imp, n_docs=n, docs_per_chunk=MM_DPC, vocab_size=vs,
                                 cap_per_chunk=MM_CAPC, nnz_kept=vs * c * MM_CAPC)
    # the rescore store: K uint16 term ids ++ K f16 weight bits per doc
    packed = torch.empty((n, 2 * MM_STORE_K), dtype=torch.int16, device=device)
    for s in range(0, n, ch):
        terms = torch.randint(0, vs, (ch, MM_STORE_K), device=device, generator=gen, dtype=torch.int32)
        w = (torch.rand(ch, MM_STORE_K, device=device, generator=gen) * 2.95 + 0.05).half()
        packed[s : s + ch, :MM_STORE_K] = terms.to(torch.int16)  # < 32,768: no wrap
        packed[s : s + ch, MM_STORE_K:] = w.view(torch.int16)
    store = SpladeRescoreStore(packed, n_docs=n, vocab_size=vs, prune_topk=MM_STORE_K)
    gb = sum(t.nbytes for t in (post_doc, post_imp, values, scales, sp_doc, sp_imp, packed)) / 1e9
    return bm25_ii, dense, scatter, store, gb


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one warm search of each searcher with torch.profiler")
    args = ap.parse_args()

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

    from fusion_tpu_torch.ops import _kernels, dense_topk, maxsim, scatter_score

    t0 = time.perf_counter()
    libs = _kernels.load_all(["maxsim", "dense_topk", "scatter_score"])
    phase("build", t0, nvcc_s=[f"{lib.build_seconds:.3f}" for lib in libs])
    for lib in libs:
        print(lib.build_log.strip(), flush=True)

    t0 = time.perf_counter()
    k1_err, k1_ms, k1_plain = kernel_vs_plain(torch, maxsim, LD, 28_032, DIM, BATCH * LQ, seed=0, runs=RUNS)
    phase("kernel", t0, shape="Ld128xN28032xD128xQL2048", max_abs_err=k1_err, kernel_ms=k1_ms, plain_ms=k1_plain)
    t0 = time.perf_counter()
    err, _, _ = kernel_vs_plain(torch, maxsim, 37, 1000, DIM, 3 * 29, seed=1, runs=0)
    phase("kernel", t0, shape="Ld37xN1000xD128xQL87", max_abs_err=err)
    k1_err = max(k1_err, err)

    t0 = time.perf_counter()
    k2_err, checked, k2_ms, k2_plain = k2_check(torch, dense_topk, BATCH, MM_DOCS, MM_DOCS, MM_H, 3, RUNS)
    phase("k2", t0, shape=f"Q64xH768xN{MM_DOCS}", max_abs_err=k2_err, offsets_checked=checked,
          kernel_ms=k2_ms, plain_ms=k2_plain)
    t0 = time.perf_counter()
    err, checked, _, _ = k2_check(torch, dense_topk, 37, 100_003, -(-100_003 // 2048) * 2048, MM_H, 4, 0)
    phase("k2", t0, shape="Q37xH768xN100003(pad 100352)", max_abs_err=err, offsets_checked=checked)
    k2_err = max(k2_err, err)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    k3_err, checked, k3_ms, k3_plain = k3_check(
        torch, scatter_score, 5, BATCH, 64, SPLADE_VOCAB, MM_DOCS // MM_DPC, MM_CAPC, MM_DPC, RUNS
    )
    phase("k3", t0, shape="Q64xKq64xC544xcapc32xdpc16384", max_abs_err=k3_err,
          offsets_checked=checked, kernel_ms=k3_ms, plain_ms=k3_plain)
    t0 = time.perf_counter()
    err, checked, _, _ = k3_check(torch, scatter_score, 6, 5, 7, 50, 3, 16, 2048, 0, pad_rows=True)
    phase("k3", t0, shape="Q5xKq7xC3xcapc16xdpc2048 (padded rows, empty chunk)", max_abs_err=err,
          offsets_checked=checked)
    k3_err = max(k3_err, err)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    phase("small", t0, max_sorted_score_diff=small_agreement(torch, np, scale=False))
    t0 = time.perf_counter()
    phase("scale_small", t0, max_sorted_score_diff=small_agreement(torch, np, scale=True))

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
    check(cfg.vocab_size == SPLADE_VOCAB, "the SPLADE encoder's vocabulary is not CamemBERT's")

    t0 = time.perf_counter()
    searcher = HybridSearcher.build(
        dict(enumerate(docs)), bm25_docs=docs, dense_model=dense, splade_model=splade,
        colbert_model=colbert, topk=TOPK, batch_size=256, fusion_method="rrf", device="cuda",
    )
    torch.cuda.synchronize()
    phase("index", t0, systems=",".join(searcher.active_systems), docs=N_DOCS)

    reset_counts(maxsim, dense_topk, scatter_score)
    t0 = time.perf_counter()
    ranked, _ = searcher.search(queries, batch_size=BATCH)
    slice_counts = counts(maxsim, dense_topk, scatter_score)
    phase("search", t0, queries=N_QUERIES, launches=slice_counts)
    check(slice_counts["K1"] >= N_QUERIES // BATCH, f"MaxSim kernel launched {slice_counts['K1']} times")
    check_ranked(torch, np, ranked, N_QUERIES, TOPK, N_DOCS)

    t0 = time.perf_counter()
    overlap = colbert_leg_overlap(torch, np, maxsim, searcher, queries[:BATCH])
    phase("colbert_leg", t0, top100_overlap_kernel_vs_plain=overlap)
    check(overlap >= 0.99, f"ColBERT leg kernel vs plain top-100 overlap {overlap}")
    warm_timing(torch, searcher, queries, "slice", smi)
    if args.profile:
        profile_search(torch, searcher, queries, "slice")
    bm25 = searcher.bm25
    del searcher, ranked
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    scale = HybridSearcher.build(
        dict(enumerate(docs)), bm25_docs=docs, dense_model=dense, splade_model=splade,
        colbert_model=colbert, topk=TOPK, batch_size=256, fusion_method="rrf", device="cuda",
        scale_mode=True, int8_corpus=True, dense_impl="fused", splade_impl="scatter",
        impact_cap=1024,
    )
    torch.cuda.synchronize()
    sc_idx = scale.splade_scatter_index
    phase("scale_index", t0, systems=",".join(scale.active_systems), docs=N_DOCS,
          splade_layout=f"C{sc_idx.num_chunks}xcapc{sc_idx.cap_per_chunk}xdpc{sc_idx.docs_per_chunk}")
    reset_counts(maxsim, dense_topk, scatter_score)
    t0 = time.perf_counter()
    ranked, _ = scale.search(queries, batch_size=BATCH)
    build_counts = counts(maxsim, dense_topk, scatter_score)
    phase("scale_search", t0, queries=N_QUERIES, launches=build_counts)
    for name, launched in build_counts.items():
        check(launched > 0, f"scale_build: {name} never launched during the search")
    check_ranked(torch, np, ranked, N_QUERIES, TOPK, N_DOCS)
    warm_timing(torch, scale, queries, "scale_build", smi)
    if args.profile:
        profile_search(torch, scale, queries, "scale_build")
    del scale, ranked, colbert
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    bm25_ii, dense_idx, scatter_idx, store, index_gb = synth_mmarco(torch, np, bm25)
    mm = HybridSearcher(
        corpus_ids=np.arange(MM_DOCS, dtype=np.int64), bm25=bm25, bm25_impact_index=bm25_ii,
        dense_model=dense, dense_corpus=dense_idx, dense_impl="fused",
        splade_model=splade, splade_scatter_index=scatter_idx, splade_query_terms=64,
        splade_rescore_store=store, splade_rescore_depth=MM_DEPTH,
        topk=TOPK, fusion_method="rrf", device=torch.device("cuda"),
    )
    torch.cuda.synchronize()
    phase("mmarco_index", t0, systems=",".join(mm.active_systems), docs=MM_DOCS, index_gb=index_gb,
          bm25_vocab=bm25.vocab_size, splade_vocab=SPLADE_VOCAB)
    reset_counts(maxsim, dense_topk, scatter_score)
    t0 = time.perf_counter()
    ranked, _ = mm.search(queries, batch_size=BATCH)
    mm_counts = counts(maxsim, dense_topk, scatter_score)
    phase("mmarco_search", t0, queries=N_QUERIES, launches=mm_counts)
    for name in ("K2", "K3"):
        check(mm_counts[name] > 0, f"scale_mmarco: {name} never launched during the search")
    check_ranked(torch, np, ranked, N_QUERIES, TOPK, MM_DOCS)
    t0 = time.perf_counter()
    legs = scale_legs_overlap(torch, np, mm, queries[:BATCH])
    phase("mmarco_legs", t0, top100_overlap_kernel_vs_plain=legs)
    for name, value in legs.items():
        check(value >= 0.99, f"scale_mmarco: {name} leg kernel vs plain top-100 overlap {value}")
    warm_timing(torch, mm, queries, "scale_mmarco", smi)
    if args.profile:
        profile_search(torch, mm, queries, "scale_mmarco")

    record = {"kernels": [
        {
            "name": "maxsim_maxima_T", "route": "cuda",
            "source": "fusion_tpu_torch/csrc/maxsim.cu",
            "replaces": "fusion_tpu/ops/maxsim.py:225",
            "launches": slice_counts["K1"], "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain,
        },
        {
            "name": "dense_binmax", "route": "cuda",
            "source": "fusion_tpu_torch/csrc/dense_topk.cu",
            "replaces": "fusion_tpu/ops/dense_topk.py:102",
            "launches": mm_counts["K2"], "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain,
        },
        {
            "name": "scatter_binmax", "route": "cuda",
            "source": "fusion_tpu_torch/csrc/scatter_score.cu",
            "replaces": "fusion_tpu/ops/scatter_score.py:138",
            "launches": mm_counts["K3"], "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain,
        },
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
