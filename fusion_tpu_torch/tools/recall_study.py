"""Recall study for the corpus-scale index forms: pruning knobs vs exact.

The counterpart of ``scripts/recall_study.py``.  The mMARCO-scale forms
trade bounded recall for speed; this tool measures that trade with planted
relevance (queries made correlated with document clusters or topics, so the
exact top-k is structured by construction), on the port's own forms:

  * dense:   clustered 768-d embeddings; the int8 exact merge
             (``quantized_dense_search``) and the fused binned top-k
             (``fused_dense_topk``, K2 on the card) at k 100 and 1000 against
             exact bf16 (``dense_search``);
  * lexical: BM25-style zipf impacts, impact-ordered caps 512 / 2048 against
             the exact scorer, with the cap guard's unsafe-term fraction;
  * splade:  SPLADE-like activations (|V| 32k, ~128 terms a doc, lognormal
             magnitudes) in a flat (σ 0.6) and a peaked (σ 1.2) world,
             queries sharing terms with a planted doc: flat caps, the chunked
             sort forms, the factorized scatter form (K3 on the card) at both
             capacities, the query-term cap, and the two-stage scatter +
             ``sparse_rescore`` at depths 512-4096;
  * colbert: planted topics (128 docs a topic share token clusters; queries
             drawn from one topic): the PLAID sweep (``ivf_cap`` × ``nprobe``
             × ``ncand``, K4 in the rescore's gather on the card) and the
             prune tier against the exhaustive ``maxsim_search_compressed``
             (block decompression into K1 on the card).

Every world but the dense one is drawn from ``np.random.default_rng(0)`` in
the script's order, so the lexical, splade and colbert worlds are the
script's own, bit for bit.  The script draws the dense world with
``jax.random``; here it comes from a seeded ``torch.Generator`` on the
device (``dense_world``), the same recipe.  The script's
``int8_approx_topk`` row (``local_topk="approx"``) has no counterpart: the
port's select is exact; the report names it under ``"not_ported"``.  The
colbert index is the port's own build (k-means seeded by numpy; the JAX
package seeds with ``jax.random``); ``run`` takes another index builder,
which the parity test uses to search a converted JAX index.

Reports mean top-k overlap per query and prints one JSON line (the
script's keys, plus the seconds of each section).

Run on the card:  python -m fusion_tpu_torch.tools.recall_study [--only colbert]
CPU smoke:        add --device cpu --n_docs 20000 --colbert_docs 4096 --batch 8
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

NOT_PORTED = {
    "int8_approx_topk": (
        "the script passes local_topk='approx' (the TPU's approx_max_k) to quantized_dense_search; "
        "the port's select is exact and quantized_dense_search takes no local_topk, so the row would "
        "repeat int8_exact_merge"
    ),
}
DENSE_H, DENSE_CLUSTERS, DENSE_CHUNK = 768, 1024, 131_072
# index builds of a section run side by side on the host (the C++ packers
# release the interpreter); each build is deterministic, so the order of
# their ends does not matter
BUILD_WORKERS = min(4, os.cpu_count() or 1)


def overlap_at_k(a_ids: np.ndarray, b_ids: np.ndarray, k: int) -> float:
    """Mean |top-k(a) ∩ top-k(b)| / k over queries."""
    return float(np.mean([
        len(set(a_ids[q, :k].tolist()) & set(b_ids[q, :k].tolist())) / k
        for q in range(a_ids.shape[0])
    ]))


def _ids(ranked) -> np.ndarray:
    return ranked.ids.cpu().numpy()


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n_docs", type=int, default=1_048_576)
    ap.add_argument("--colbert_docs", type=int, default=262_144)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--only", default=None, choices=[None, "dense", "lexical", "splade", "colbert"])
    ap.add_argument("--doc_jitter", type=float, default=0.7,
                    help="colbert doc-token jitter norm as a fraction of the unit cluster center "
                         "(cos(token, center) = 1/sqrt(1+j^2)); 0.7 -> strongly structured exact "
                         "top-k, 1.5 -> mid-regime where the PLAID knobs start to matter")
    ap.add_argument("--device", default="cuda", help="cuda (the measurement) or cpu (smoke sizes)")
    ap.add_argument("--out", default=None, help="also write the JSON record to this file")
    return ap.parse_args(argv)


# ----------------------------------------------------------------------
# dense: clustered 768-d embeddings, queries near cluster centers
# ----------------------------------------------------------------------
def dense_world(n: int, b: int, device, seed: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """(corpus bf16 [n, 768], queries f32 [b, 768]): rows are one of 1,024
    unit centers plus 0.35-σ gaussian noise, normalized, made in steps of
    131,072 rows from one seeded generator; the queries sit near the first
    ``b`` centers."""
    gen = torch.Generator(device=device).manual_seed(seed)
    centers = torch.randn(DENSE_CLUSTERS, DENSE_H, device=device, generator=gen)
    centers = centers / centers.norm(dim=-1, keepdim=True)
    corpus = torch.empty((n, DENSE_H), dtype=torch.bfloat16, device=device)
    for s in range(0, n, DENSE_CHUNK):
        m = min(DENSE_CHUNK, n - s)
        assign = torch.randint(0, DENSE_CLUSTERS, (m,), device=device, generator=gen)
        x = centers[assign] + 0.35 * torch.randn(m, DENSE_H, device=device, generator=gen)
        corpus[s : s + m] = (x / x.norm(dim=-1, keepdim=True)).to(torch.bfloat16)
    q = centers[:b] + 0.35 * torch.randn(b, DENSE_H, device=device, generator=gen)
    return corpus, q / q.norm(dim=-1, keepdim=True)


def dense_section(corpus: torch.Tensor, q: torch.Tensor, k: int, report: dict) -> None:
    """Overlaps of the int8 exact merge and the fused binned top-k (K2) with
    exact bf16 cosine search."""
    from fusion_tpu_torch.index.dense_quant import quantize_dense_index, quantized_dense_search
    from fusion_tpu_torch.ops.dense_topk import fused_dense_topk
    from fusion_tpu_torch.ops.mips import dense_search

    exact_ids = _ids(dense_search(q.to(torch.bfloat16), corpus, k=k, similarity="cos_sim"))
    qidx = quantize_dense_index(corpus, similarity="cos_sim")
    got = quantized_dense_search(q, qidx, k=k)
    report[f"dense_int8_exact_merge_overlap@{k}"] = round(overlap_at_k(_ids(got), exact_ids, k), 4)
    got = fused_dense_topk(q, qidx, k=k)
    report[f"dense_fused_binned_overlap@{k}"] = round(overlap_at_k(_ids(got), exact_ids, k), 4)
    got1000 = fused_dense_topk(q, qidx, k=1000)
    exact1000 = quantized_dense_search(q, qidx, k=1000)
    report["dense_fused_binned_overlap@1000"] = round(overlap_at_k(_ids(got1000), _ids(exact1000), 1000), 4)


# ----------------------------------------------------------------------
# lexical: zipf term distribution, impact caps vs exact scorer
# ----------------------------------------------------------------------
def lexical_world(rng: np.random.Generator, n: int, b: int) -> dict:
    """BM25-style postings: 64 zipf^0.9 terms a doc over 65,536 (duplicates
    padded with the vocabulary size), impact idf × U(0.6, 1.4) (high-df terms
    carry low impact, which is why impact-ordered capping works); two query
    sets of 16 terms: raw zipf, and terms of df ≤ n/64."""
    v, kd = 65_536, 64
    zipf_p = 1.0 / np.arange(1, v + 1) ** 0.9
    zipf_p /= zipf_p.sum()
    terms = rng.choice(v, size=(n, kd), p=zipf_p)
    terms.sort(axis=1)
    dup = np.concatenate([np.zeros((n, 1), bool), terms[:, 1:] == terms[:, :-1]], 1)
    terms = np.where(dup, v, terms)
    df = np.bincount(terms.ravel(), minlength=v + 1)[:v].astype(np.float64)
    idf = np.log10((n - df + 0.5) / (df + 0.5)).clip(min=0.05)
    weights = np.where(
        terms < v, idf[np.minimum(terms, v - 1)] * rng.uniform(0.6, 1.4, size=(n, kd)), 0.0,
    ).astype(np.float32)
    qsets = {"zipfq": np.asarray(rng.choice(v, size=(b, 16), p=zipf_p), np.int32)}
    rare_terms = np.nonzero((df > 0) & (df <= n / 64))[0]
    qsets["filteredq"] = np.asarray(rng.choice(rare_terms, size=(b, 16)), np.int32)
    return {"vocab": v, "terms": terms, "weights": weights, "qsets": qsets}


def _sparse_index(terms: np.ndarray, weights: np.ndarray, v: int, device):
    from fusion_tpu_torch.index.sparse import SparseIndex

    return SparseIndex(
        entry_term=torch.as_tensor(terms.astype(np.int32), device=device),
        entry_weight=torch.as_tensor(weights, device=device),
        n_docs=terms.shape[0], vocab_size=v, nnz=int((terms < v).sum()),
    )


def _coo(terms: np.ndarray, weights: np.ndarray, v: int):
    kd = terms.shape[1]
    flat_t, flat_w = terms.ravel(), weights.ravel()
    flat_d = np.repeat(np.arange(terms.shape[0], dtype=np.int64), kd)
    keep = flat_t < v
    return flat_t[keep], flat_d[keep], flat_w[keep]


def lexical_section(world: dict, k: int, device, report: dict) -> None:
    from fusion_tpu_torch.index.inverted import build_impact_index, impact_search
    from fusion_tpu_torch.index.sparse import lexical_query_matrix, sparse_search

    v, terms, weights = world["vocab"], world["terms"], world["weights"]
    n, b = terms.shape[0], next(iter(world["qsets"].values())).shape[0]
    sp = _sparse_index(terms, weights, v, device)
    q_weights = torch.ones((b, 16), device=device)
    exact_by_set = {}
    for tag, q_terms in world["qsets"].items():
        qv = lexical_query_matrix(torch.as_tensor(q_terms, device=device), q_weights, v)
        exact_by_set[tag] = _ids(sparse_search(qv, sp, k=k))
    del sp
    t, d, w = _coo(terms, weights, v)
    with warnings.catch_warnings(), ThreadPoolExecutor(BUILD_WORKERS) as pool:
        warnings.simplefilter("ignore")  # the guard under study
        built = {cap: pool.submit(build_impact_index, t, d, w, v, n, cap=cap, device=device) for cap in (512, 2048)}
    for cap in (512, 2048):
        inv = built.pop(cap).result()
        for tag, q_terms in world["qsets"].items():
            got = impact_search(torch.as_tensor(q_terms, device=device), q_weights, inv, k=k)
            report[f"lexical_cap{cap}_{tag}_overlap@{k}"] = round(overlap_at_k(_ids(got), exact_by_set[tag], k), 4)
            # the cap guard: the share of query terms past the safe df
            # ratio, which must flag the raw-zipf set and pass the filtered one
            report[f"lexical_cap{cap}_{tag}_guard_unsafe_frac"] = round(inv.unsafe_query_term_frac(q_terms), 4)
        report[f"lexical_cap{cap}_nnz_kept_frac"] = round(inv.nnz_kept / t.size, 4)
        del inv


# ----------------------------------------------------------------------
# splade: SPLADE-like activations, planted query-term overlap
# ----------------------------------------------------------------------
SPLADE_V, SPLADE_KD, SPLADE_KQ = 32_768, 128, 64


def splade_world(rng: np.random.Generator, n: int, b: int, sigma: float) -> dict:
    """One SPLADE world at doc-weight lognormal σ = ``sigma`` (0.6 flat, 1.2
    peaked): 128 zipf^0.8 terms a doc over 32,768; each query copies the 32
    strongest terms of a seed doc and adds 32 zipf terms, lognormal weights."""
    v, kd, kq = SPLADE_V, SPLADE_KD, SPLADE_KQ
    zipf_p = 1.0 / np.arange(1, v + 1) ** 0.8
    zipf_p /= zipf_p.sum()
    terms = rng.choice(v, size=(n, kd), p=zipf_p)
    terms.sort(axis=1)
    dup = np.concatenate([np.zeros((n, 1), bool), terms[:, 1:] == terms[:, :-1]], 1)
    terms = np.where(dup, v, terms)
    weights = np.where(terms < v, rng.lognormal(-0.5, sigma, size=(n, kd)), 0.0).astype(np.float32)
    seed_docs = rng.integers(0, n, size=b)
    q_terms = np.full((b, kq), v, np.int64)
    q_w = np.zeros((b, kq), np.float32)
    for qi in range(b):
        row = terms[seed_docs[qi]]
        real = row[row < v]
        order = np.argsort(-weights[seed_docs[qi]][row < v])
        take = real[order][: kq // 2]  # the doc's strongest terms
        generic = rng.choice(v, size=kq - take.size, p=zipf_p)
        q_terms[qi] = np.concatenate([take, generic])
        q_w[qi] = rng.lognormal(-0.5, sigma, size=kq).astype(np.float32)
    return {"terms": terms, "weights": weights, "seed_docs": seed_docs, "q_terms": q_terms, "q_w": q_w}


def _splade_layout(n: int) -> tuple[list[int], list[int], int]:
    """(the chunked sort forms' capc, capacity-matched to the flat caps 4,096
    and 16,384 over 32,768-doc chunks; the scatter form's capc over
    16,384-doc chunks within the kernel's posting-width budget; the smaller
    scatter capc, which also feeds the two-stage form)."""
    from fusion_tpu_torch.ops.scatter_score import MAX_POSTING_WIDTH

    num_chunks = -(-n // 32_768)
    nc_sc = -(-n // 16_384)
    cap_fit = MAX_POSTING_WIDTH // SPLADE_KQ
    chunked = sorted({max(16_384 // num_chunks, 8), max(4096 // num_chunks, 8)})
    scatter = sorted({min(max(16_384 // nc_sc, 4), cap_fit), min(max(4096 // nc_sc, 4), cap_fit)})
    return chunked, scatter, min(max(4096 // nc_sc, 4), cap_fit)


def splade_builds(world: dict, pool: ThreadPoolExecutor, device) -> dict:
    """Start the world's index builds on ``pool``: the flat form at the
    shipped cap (16,384) and a quarter of it, the chunked sort forms and the
    factorized scatter forms (``_splade_layout``)."""
    from fusion_tpu_torch.index.inverted import build_chunked_impact_index, build_impact_index

    v, n = SPLADE_V, world["terms"].shape[0]
    t, d, w = _coo(world["terms"], world["weights"], v)
    chunked_capcs, scatter_capcs, _ = _splade_layout(n)
    return {
        "nnz": t.size,
        "flat": {cap: pool.submit(build_impact_index, t, d, w, v, n, cap=cap, device=device) for cap in (4096, 16_384)},
        "chunked": {capc: pool.submit(build_chunked_impact_index, t, d, w, v, n, docs_per_chunk=32_768,
                                      cap_per_chunk=capc, device=device) for capc in chunked_capcs},
        "scatter": {capc: pool.submit(build_chunked_impact_index, t, d, w, v, n, docs_per_chunk=16_384,
                                      cap_per_chunk=capc, device=device) for capc in scatter_capcs},
    }


def splade_section(world: dict, builds: dict, tag: str, k: int, device, report: dict) -> None:
    """The world's overlaps against the exact scorer, over the indexes
    ``splade_builds`` started."""
    from fusion_tpu_torch.index.inverted import chunked_impact_search, impact_search
    from fusion_tpu_torch.index.sparse import build_rescore_store, lexical_query_matrix, sparse_rescore, sparse_search
    from fusion_tpu_torch.ops.scatter_score import scatter_impact_search

    v, kq = SPLADE_V, SPLADE_KQ
    terms, weights, q_terms, q_w = world["terms"], world["weights"], world["q_terms"], world["q_w"]
    n, b = terms.shape[0], q_terms.shape[0]
    nnz, flat, chunked, scatter = builds["nnz"], builds["flat"], builds["chunked"], builds["scatter"]
    chunked_capcs, scatter_capcs, capc2 = _splade_layout(n)
    sp = _sparse_index(terms, weights, v, device)
    qt, qw = torch.as_tensor(q_terms.astype(np.int32), device=device), torch.as_tensor(q_w, device=device)
    qv = lexical_query_matrix(qt, qw, v)
    exact_ids = _ids(sparse_search(qv, sp, k=k))
    seed_docs = world["seed_docs"]
    seed_found = float(np.mean([seed_docs[qi] in set(exact_ids[qi, :10].tolist()) for qi in range(b)]))
    report[f"splade_{tag}_seed_doc_in_exact_top10"] = round(seed_found, 4)

    for cap in (4096, 16_384):
        inv = flat.pop(cap).result()
        got = impact_search(qt, qw, inv, k=k)
        report[f"splade_{tag}_flat_cap{cap}_overlap@{k}"] = round(overlap_at_k(_ids(got), exact_ids, k), 4)
        report[f"splade_{tag}_flat_cap{cap}_kept_frac"] = round(inv.nnz_kept / nnz, 4)
        del inv
    for capc in chunked_capcs:
        ch = chunked.pop(capc).result()
        for local_k in (64, 128, 256):
            got = chunked_impact_search(qt, qw, ch, k=k, local_k=local_k, bf16_payload=True)
            report[f"splade_{tag}_chunked_capc{capc}_lk{local_k}_bf16_overlap@{k}"] = round(
                overlap_at_k(_ids(got), exact_ids, k), 4)
        got = chunked_impact_search(qt, qw, ch, k=k, local_k=128, bf16_payload=False)
        report[f"splade_{tag}_chunked_capc{capc}_lk128_f32_overlap@{k}"] = round(
            overlap_at_k(_ids(got), exact_ids, k), 4)
        report[f"splade_{tag}_chunked_capc{capc}_kept_frac"] = round(ch.nnz_kept / nnz, 4)
        del ch
    for capc in scatter_capcs:
        ch = scatter[capc].result()
        got = scatter_impact_search(qt, qw, ch, k=k)
        report[f"splade_{tag}_scatter_capc{capc}_overlap@{k}"] = round(overlap_at_k(_ids(got), exact_ids, k), 4)
        report[f"splade_{tag}_scatter_capc{capc}_kept_frac"] = round(ch.nnz_kept / nnz, 4)
        del ch
        if capc != capc2:
            del scatter[capc]
    # the query-term cap (the serving knob splade_query_terms: 64 vs 32 / 48)
    for kq_cap in (32, 48):
        order = np.argsort(-q_w, axis=1)[:, :kq_cap]
        qt_c = np.take_along_axis(q_terms, order, axis=1)
        qw_c = np.take_along_axis(q_w, order, axis=1)
        qv_c = lexical_query_matrix(torch.as_tensor(qt_c.astype(np.int32), device=device),
                                    torch.as_tensor(qw_c, device=device), v)
        report[f"splade_{tag}_queryterms{kq_cap}_vs_{kq}_overlap@{k}"] = round(
            overlap_at_k(_ids(sparse_search(qv_c, sp, k=k)), exact_ids, k), 4)
    # the two-stage form (capped scatter candidates + exact rescore against
    # the stored f16 doc vectors): exact is taken over the f16 vectors the
    # store holds, so candidate recall is its only quality lever
    store = build_rescore_store(sp)
    sp16 = sp._replace(entry_weight=sp.entry_weight.to(torch.float16).to(torch.float32))
    exact16_ids = _ids(sparse_search(qv, sp16, k=k))
    del sp, sp16
    ch2 = scatter.pop(capc2).result()
    for depth in (512, 1024, 2048, 4096):
        cand = scatter_impact_search(qt, qw, ch2, k=min(depth, n))
        cand_ids = _ids(cand)
        crec = float(np.mean([
            len(set(cand_ids[qi].tolist()) & set(exact16_ids[qi, :k].tolist())) / k for qi in range(b)
        ]))
        got = sparse_rescore(qv, cand.ids, store, k=k)
        report[f"splade_{tag}_twostage_scatter_d{depth}_overlap@{k}"] = round(
            overlap_at_k(_ids(got), exact16_ids, k), 4)
        report[f"splade_{tag}_twostage_scatter_d{depth}_cand_recall@{k}"] = round(crec, 4)
    del ch2, store


# ----------------------------------------------------------------------
# colbert: planted topics, the PLAID sweep vs exhaustive compressed search
# ----------------------------------------------------------------------
COLBERT_LD, COLBERT_D, TOPIC_DOCS, CLUSTERS_PER_TOPIC, QUERY_TOKENS = 16, 128, 128, 16, 8


def colbert_world(rng: np.random.Generator, ncb: int, b: int, doc_jitter: float) -> dict:
    """Docs of 16 tokens, each token a cluster center of its topic's 16
    plus jitter of norm ``doc_jitter`` (per component ``doc_jitter / √D``),
    normalized; queries of 8 tokens from one topic's clusters (jitter 0.4)."""
    ld, d = COLBERT_LD, COLBERT_D
    n_topics = max(ncb // TOPIC_DOCS, 1)
    nc_true = int(min(max(ncb * ld // 128, 1024), 65_536))
    tok_centers = rng.standard_normal((nc_true, d)).astype(np.float32)
    tok_centers /= np.linalg.norm(tok_centers, axis=-1, keepdims=True)
    topic_clusters = rng.integers(0, nc_true, size=(n_topics, CLUSTERS_PER_TOPIC))
    doc_topic = np.repeat(np.arange(n_topics), TOPIC_DOCS)[:ncb]
    pick = rng.integers(0, CLUSTERS_PER_TOPIC, size=(ncb, ld))
    assign = topic_clusters[doc_topic[:, None], pick]
    toks = tok_centers[assign] + (doc_jitter / np.sqrt(d)) * rng.standard_normal((ncb, ld, d)).astype(np.float32)
    toks /= np.linalg.norm(toks, axis=-1, keepdims=True)
    mask = np.ones((ncb, ld), np.float32)
    n_tokens = ncb * ld
    n_cent = int(2 ** np.round(np.log2(max(16 * np.sqrt(n_tokens), 256))))
    n_cent = min(n_cent, n_tokens // 8)
    q_topic = rng.integers(0, n_topics, size=b)
    q_pick = rng.integers(0, CLUSTERS_PER_TOPIC, size=(b, QUERY_TOKENS))
    q_assign = topic_clusters[q_topic[:, None], q_pick]
    q_tok = tok_centers[q_assign] + (0.4 / np.sqrt(d)) * rng.standard_normal((b, QUERY_TOKENS, d)).astype(np.float32)
    q_tok /= np.linalg.norm(q_tok, axis=-1, keepdims=True)
    # the jitter's scale is an f64 scalar, so the tokens are f64 until here;
    # the searches take them in f32
    toks, q_tok = toks.astype(np.float32), q_tok.astype(np.float32)
    return {"toks": toks, "mask": mask, "n_cent": n_cent, "n_topics": n_topics, "doc_topic": doc_topic,
            "q_topic": q_topic, "q_tok": q_tok}


def colbert_index(world: dict, device):
    """The port's residual-compressed index of the world (2 bits, 4 k-means
    iterations, the script's centroid count and sample)."""
    from fusion_tpu_torch.index.compression import compress_token_index

    n_tokens = world["toks"].shape[0] * world["toks"].shape[1]
    return compress_token_index(
        torch.as_tensor(world["toks"], device=device), torch.as_tensor(world["mask"], device=device),
        num_centroids=world["n_cent"], nbits=2, kmeans_iters=4, sample_size=min(n_tokens, 1_048_576),
    )


def colbert_section(world: dict, index, k: int, device, report: dict) -> None:
    from fusion_tpu_torch.index.compression import maxsim_search_compressed
    from fusion_tpu_torch.index.plaid import build_ivf, plaid_search

    ncb, ld = world["mask"].shape
    mask, n_cent, doc_topic, q_topic = world["mask"], world["n_cent"], world["doc_topic"], world["q_topic"]
    q_tok = torch.as_tensor(world["q_tok"], device=device)
    q_mask = torch.ones(q_tok.shape[:2], device=device)
    exact_ids = _ids(maxsim_search_compressed(q_tok, q_mask, index, k=k))
    b = exact_ids.shape[0]
    # how structured the exact top-k is: the share from the query's topic
    same_topic = float(np.mean([np.mean(doc_topic[exact_ids[qi, :k]] == q_topic[qi]) for qi in range(b)]))
    report["plaid_exact_topk_same_topic_frac"] = round(same_topic, 4)

    cid_np = index.centroid_ids.cpu().numpy()
    best = None
    for ivf_cap in (1024, 4096):
        ivf = build_ivf(cid_np, mask, n_cent, cap=ivf_cap, device=device)
        for nprobe in (2, 4, 8, 16, 32, 64):
            for ncand in (1024, 4096, 8192):
                got = _ids(plaid_search(q_tok, q_mask, index, ivf, k=k, nprobe=nprobe, ncand=min(ncand, ncb),
                                        cand_chunk=512, ncand_rescore=None))
                ov = overlap_at_k(got, exact_ids, k)
                key = f"plaid_cap{ivf_cap}_np{nprobe}_nc{ncand}"
                report[f"{key}_overlap@{k}"] = round(ov, 4)
                report[f"{key}_overlap@10"] = round(overlap_at_k(got, exact_ids, 10), 4)
                cost = nprobe * ivf_cap + ncand * ld  # relative work model
                if ov >= 0.9 and (best is None or cost < best[1]):
                    best = (key, cost, ov)
        del ivf
    if best is not None:
        report["plaid_cheapest_config_with_overlap>=0.9"] = {"config": best[0], "overlap": best[2]}
    # the centroid-only prune tier at the serving defaults: what capping the
    # exact-rescore depth costs
    ivf = build_ivf(cid_np, mask, n_cent, cap=1024, device=device)
    nc0 = min(4096, ncb)
    for nr in (256, 512, 1024, 2048):
        if nr >= nc0:
            continue
        got = _ids(plaid_search(q_tok, q_mask, index, ivf, k=k, nprobe=4, ncand=nc0, cand_chunk=256,
                                ncand_rescore=nr))
        report[f"plaid_np4_nc{nc0}_rescore{nr}_overlap@{k}"] = round(overlap_at_k(got, exact_ids, k), 4)
        report[f"plaid_np4_nc{nc0}_rescore{nr}_overlap@10"] = round(overlap_at_k(got, exact_ids, 10), 4)


# ----------------------------------------------------------------------
def run(args: argparse.Namespace, build_colbert_index=colbert_index) -> dict:
    """Every section ``args`` asks for, on ``args.device``; the JSON record.
    ``build_colbert_index(world, device)`` makes the colbert section's
    compressed index."""
    from fusion_tpu_torch.core.device import resolve_device

    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    n, b, k, only = args.n_docs, args.batch, args.k, args.only
    report: dict = {}
    seconds: dict = {}

    def section(name: str, fn) -> None:
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds[name] = round(time.perf_counter() - t0, 3)
        log(f"{name} done in {seconds[name]:.1f}s")

    if only in (None, "dense"):
        def dense():
            corpus, q = dense_world(n, b, device)
            dense_section(corpus, q, k, report)
        section("dense", dense)
    if only in (None, "lexical"):
        section("lexical", lambda: lexical_section(lexical_world(rng, n, b), k, device, report))
    if only in (None, "splade"):
        # the flat world (comparable with earlier studies), then the
        # realistically peaked log1p∘relu shape, drawn while the flat
        # world's indexes build; one world's builds at a time bounds the
        # host and device memory they hold
        def splade():
            with ThreadPoolExecutor(BUILD_WORKERS) as pool:
                flat = splade_world(rng, n, b, 0.6)
                flat_builds = splade_builds(flat, pool, device)
                peaked = splade_world(rng, n, b, 1.2)
                splade_section(flat, flat_builds, "flat", k, device, report)
                del flat, flat_builds
                splade_section(peaked, splade_builds(peaked, pool, device), "peaked", k, device, report)
        section("splade", splade)
    if only in (None, "colbert"):
        def colbert():
            world = colbert_world(rng, args.colbert_docs, b, args.doc_jitter)
            index = build_colbert_index(world, device)
            colbert_section(world, index, k, device, report)
        section("colbert", colbert)

    best = report.get("plaid_cheapest_config_with_overlap>=0.9")
    return {
        "metric": "scale_form_recall_vs_exact_planted",
        "value": best["overlap"] if isinstance(best, dict) else 0.0,
        "unit": f"top-{k} overlap",
        "detail": {"n_docs": n, "colbert_docs": args.colbert_docs, "batch": b, "planted_relevance": True, **report,
                   "not_ported": dict(NOT_PORTED) if only in (None, "dense") else {},
                   "section_seconds": seconds, "backend": device.type,
                   "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"},
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    record = run(args)
    line = json.dumps(record)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return record


if __name__ == "__main__":
    main()
