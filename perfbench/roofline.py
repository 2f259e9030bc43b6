"""Peaks of one NVIDIA H100 and the work of what the hybrid search computes.

Peaks: NVIDIA's data sheet for the SXM part, dense (a frozen copy of
``fusion_tpu_torch/tools/bench_maxsim.py``'s table), at the full 700 W.
Work is counted from the shapes and the inputs perfbench made, never from
the program: each input byte read once, each output byte written once, and
data-dependent work as these inputs need it (K1 counts the documents' real
tokens, not their padding; BM25 and SPLADE count the postings and nonzeros
their sparse inputs hold; an encoder counts the tokens its mask attends).
"""

from __future__ import annotations

import numpy as np

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time the card could take: operations at the peak rate
    against bytes at the memory bandwidth, whichever is larger."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES)


def k1_work(ql: int, ld: int, n: int, d: int, real_tokens: int) -> tuple[float, float]:
    """K1 over bf16 [QL, D] query tokens and a bf16 token-major [Ld, N, D]
    corpus → f32 [N, QL] maxima: the products of the real doc tokens, the
    corpus and queries read once, the maxima written once."""
    flops = 2.0 * ql * d * real_tokens
    nbytes = 2.0 * ld * n * d + 2.0 * ql * d + 4.0 * n * ql
    return flops, nbytes


def encoder_flops(enc: dict, lengths: np.ndarray) -> float:
    """A trunk's forward over sequences of the given attended lengths."""
    h, i, layers = enc["hidden_size"], enc["intermediate_size"], enc["num_hidden_layers"]
    lengths = np.asarray(lengths, np.float64)
    per_token = 2.0 * (4 * h * h + 2 * h * i)
    return float(layers * (per_token * lengths.sum() + 4.0 * h * (lengths ** 2).sum()))


def hybrid_batch_flops(cfg: dict, q_words: np.ndarray, q_bm25_df: np.ndarray, splade_nnz: int,
                       real_doc_tokens: int, pair_lengths: np.ndarray | None) -> float:
    """Useful operations of one batch of the default hybrid search.

    ``q_words``: each query's word count; ``q_bm25_df``: per query, the
    summed document frequency of its distinct words times their count
    (the postings BM25 touches); ``splade_nnz``: the nonzeros of all SPLADE
    rows; ``real_doc_tokens``: ColBERT's real tokens; ``pair_lengths``: the
    reranked pairs' token counts (None without a rerank)."""
    enc = cfg["encoder"]
    h, v, lq, dim = enc["hidden_size"], enc["vocab_size"], cfg["query_length"], cfg["colbert_dim"]
    n, qn = cfg["n_docs"], len(q_words)
    attended = np.minimum(np.asarray(q_words) + 2, lq)
    flops = 2 * encoder_flops(enc, attended)  # DPR and SPLADE see the real tokens
    flops += encoder_flops(enc, np.full(qn, lq))  # ColBERT's [MASK]-augmented queries
    flops += 2.0 * (h * h + h * v) * attended.sum()  # SPLADE's MLM head
    flops += 2.0 * h * dim * qn * lq  # ColBERT's projection
    flops += 2.0 * qn * n * h  # DPR scores
    flops += 2.0 * qn * splade_nnz  # SPLADE scores over the rows' nonzeros
    flops += 2.0 * float(np.sum(q_bm25_df))  # BM25 postings
    flops += 2.0 * qn * lq * dim * real_doc_tokens  # MaxSim
    if pair_lengths is not None and len(pair_lengths):
        flops += encoder_flops(enc, pair_lengths) + len(pair_lengths) * 2.0 * (h * h + h)
    return flops


def hybrid_traced_work(cfg: dict, traffic: dict, inputs, traced: list, rows_of, k1_shapes: list) -> dict:
    """Useful operations of the traced calls (``traced``: (call, final ids)
    pairs) and K1's work per launch (``k1_shapes``: the launches' (queries,
    corpus) shapes)."""
    words = cfg["corpus"]["words"]
    doc = np.repeat(np.arange(inputs.n_docs), inputs.doc_words)
    df = np.bincount(np.unique(doc * words + inputs.doc_flat) % words, minlength=words)
    splade_nnz = int((inputs.splade_rows != 0).sum())
    real_tokens = int(inputs.colbert_lens.sum())
    depth, b = traffic.get("rerank_depth", 0), traffic["batch"]
    lce = cfg["ce_max_length"] - 36
    flops = 0.0
    for call, ids in traced:
        rows = rows_of(call)
        for s in range(0, len(rows), b):
            r = rows[s : s + b]
            qw = inputs.query_words[r]
            # each distinct query word touches its postings once per occurrence
            q_df = np.array([
                df[inputs.query_flat[inputs.query_offsets[i] : inputs.query_offsets[i + 1]]].sum() for i in r
            ])
            pairs = None
            if depth:
                head = ids[s : s + b, :depth]
                pairs = (2 + np.minimum(qw, 32)[:, None] + np.minimum(inputs.ce_doc_lens[head], lce)).ravel()
            flops += hybrid_batch_flops(cfg, qw, q_df, splade_nnz, real_tokens, pairs)
    k1 = [k1_work(q[0], c[0], c[1], c[2], real_tokens) for q, c in k1_shapes]
    return {
        "useful_flops": flops,
        "k1_flops": sum(f for f, _ in k1),
        "k1_bytes": sum(nb for _, nb in k1),
        "k1_bound_s": sum(bound_s(f, nb) for f, nb in k1),
    }
