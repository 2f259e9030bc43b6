"""Term-major impact-ordered inverted indexes (the scale-mode lexical forms).

  * ``ImpactIndex`` — ``post_doc int32[V+1, P]``, ``post_impact f16[V+1, P]``:
    each term's postings sorted by DESCENDING impact and capped at ``P``
    (exact whenever every term has ≤ P postings).  Row V is the sentinel row
    for query pad slots (doc = n_docs).  ``impact_search`` scores a batch by
    gathering the query-term rows, sorting (doc, value) pairs by doc id, and
    summing each doc's run (``ops/segscan.py``): O(Q·Kq·P), independent of N.
  * ``ChunkedImpactIndex`` — the same postings split into doc-range chunks
    with a per-(term, chunk) cap: ``post_doc [V+1, C, capc]`` local doc ids
    and ``post_impact f16``.  Local ids are uint16 values kept in an int16
    tensor (torch has few uint16 ops); the pad ``CHUNK_SENTINEL`` = 0xFFFF
    reads back as -1, so widen with ``& 0xFFFF``.  It feeds the scatter
    scorer (``ops/scatter_score.py``).

The build functions run on the host in numpy (offline index work) and put
the arrays on ``device``; they give the arrays that
``fusion_tpu/index/inverted.py``'s numpy build path gives.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from fusion_tpu_torch.core.ranked import RankedLists, stable_topk
from fusion_tpu_torch.ops.segscan import segmented_run_totals

# Query terms whose document frequency exceeds CAP_SAFE_DF_RATIO × cap are
# quality-unsafe under impact-ordered capping (the JAX package's planted-
# relevance study: overlap@100 0.94 with stopword-filtered queries, 0.39/0.20
# when raw zipf queries hit ultra-common truncated terms).  Preprocessing
# strips high-df terms from queries; the guards make the contract visible.
CAP_SAFE_DF_RATIO = 8

CHUNK_SENTINEL = 0xFFFF  # uint16 pad (docs_per_chunk must stay < 65535)


class ImpactCapTruncationWarning(UserWarning):
    """Impact-ordered capping is about to (or did) truncate ultra-common
    terms hard enough to endanger recall for queries that use them."""


def _warn_unsafe_terms(df: np.ndarray, cap: int, nnz_total: int,
                       mass_frac_threshold: float = 0.2) -> None:
    """Build-time guard: warn when terms with df > ratio·cap carry a large
    share of the postings mass (the raw-zipf / unpreprocessed-text shape)."""
    unsafe = df > CAP_SAFE_DF_RATIO * cap
    n_unsafe = int(unsafe.sum())
    if not n_unsafe or not nnz_total:
        return
    mass = float(df[unsafe].sum()) / float(nnz_total)
    if mass < mass_frac_threshold:
        return
    warnings.warn(
        f"impact cap {cap}: {n_unsafe} term(s) have df > "
        f"{CAP_SAFE_DF_RATIO}*cap (max df {int(df.max())}) carrying "
        f"{mass:.0%} of all postings — queries containing them will see "
        f"badly truncated recall. Preprocess the corpus/queries (strip "
        f"stopwords), raise the cap, or use the flat/scatter exact forms.",
        ImpactCapTruncationWarning,
        stacklevel=3,
    )


class ImpactIndex(NamedTuple):
    post_doc: torch.Tensor  # int32 [V+1, P], pad = n_docs (sentinel)
    post_impact: torch.Tensor  # f16 [V+1, P], pad = 0
    n_docs: int
    vocab_size: int
    cap: int
    nnz_kept: int
    # host document frequencies [V] (int32 numpy) for the query-time guard
    term_df: np.ndarray | None = None

    def nbytes(self) -> int:
        return self.post_doc.nbytes + self.post_impact.nbytes

    def unsafe_query_term_frac(self, q_terms: np.ndarray) -> float:
        """Fraction of real (non-pad) query terms whose posting list was
        truncated past the safe ratio — the query-time cap guard."""
        if self.term_df is None:
            return 0.0
        t = np.asarray(q_terms).ravel()
        real = t[(t >= 0) & (t < self.vocab_size)]
        if real.size == 0:
            return 0.0
        return float((self.term_df[real] > CAP_SAFE_DF_RATIO * self.cap).mean())


def build_impact_index(
    entry_term: np.ndarray,  # [nnz]
    entry_doc: np.ndarray,  # [nnz]
    impacts: np.ndarray,  # f32 [nnz]
    vocab_size: int,
    n_docs: int,
    cap: int = 4096,
    device="cpu",
) -> ImpactIndex:
    """Host-side build from COO postings; the arrays then live on ``device``."""
    t = np.asarray(entry_term, dtype=np.int64)
    counts = np.bincount(t, minlength=vocab_size)
    df = counts[:vocab_size].astype(np.int32)
    _warn_unsafe_terms(df, cap, int(t.size))
    d = np.asarray(entry_doc, dtype=np.int64)
    v = np.asarray(impacts, dtype=np.float32)
    order = np.lexsort((-v, t))  # term-major, impact descending within term
    t, d, v = t[order], d[order], v[order]
    starts = np.zeros(vocab_size + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    rank = np.arange(t.size, dtype=np.int64) - starts[t]
    keep = rank < cap
    post_doc = np.full((vocab_size + 1, cap), n_docs, dtype=np.int32)
    post_imp = np.zeros((vocab_size + 1, cap), dtype=np.float16)
    post_doc[t[keep], rank[keep]] = d[keep]
    post_imp[t[keep], rank[keep]] = v[keep]
    return ImpactIndex(
        post_doc=torch.as_tensor(post_doc, device=device),
        post_impact=torch.as_tensor(post_imp, device=device),
        n_docs=n_docs,
        vocab_size=vocab_size,
        cap=cap,
        nnz_kept=int(keep.sum()),
        term_df=df,
    )


def impact_search(
    q_terms: torch.Tensor,  # int [Q, Kq] (pad >= vocab_size)
    q_weights: torch.Tensor,  # f32 [Q, Kq]
    index: ImpactIndex,
    k: int = 1000,
) -> RankedLists:
    """Query-driven scoring over the impact-ordered index.

    Exact when every query term has ≤ cap postings; otherwise scores use
    each term's top-cap impacts.  Docs sharing no term with the query score
    -inf and come back as id -1."""
    q, kq = q_terms.shape
    vp1 = index.post_doc.shape[0]
    terms = q_terms.long().clamp(0, vp1 - 1)
    docs = index.post_doc[terms].reshape(q, -1)  # [Q, Kq·P] contiguous row gathers
    vals = (index.post_impact[terms].float() * q_weights.float()[..., None]).reshape(q, -1)
    # stable sort by doc id: each doc's entries keep their term order, so the
    # run sums below add in the JAX package's order
    docs_s, order = torch.sort(docs, dim=1, stable=True)
    vals_s = torch.gather(vals, 1, order)
    seg, is_end = segmented_run_totals(docs_s, vals_s, kq)
    scores = torch.where(is_end & (docs_s < index.n_docs), seg, -torch.inf)
    top_scores, pos = stable_topk(scores, min(k, index.n_docs))
    top_docs = torch.gather(docs_s, 1, pos)
    # slots past the matched docs carry PAD_ID, never the sentinel doc id
    top_docs = torch.where(torch.isfinite(top_scores), top_docs, -1)
    return RankedLists(ids=top_docs.to(torch.int32), scores=top_scores)


def activations_to_query_terms(
    query_activations: torch.Tensor, kq: int  # [Q, V] dense (e.g. SPLADE)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense query activations → (terms int32 [Q, Kq], weights [Q, Kq]):
    each query's Kq strongest terms (query-side pruning); non-positive slots
    become the pad term V with weight 0."""
    v = query_activations.shape[-1]
    weights, terms = stable_topk(query_activations, kq)
    terms = torch.where(weights > 0, terms, v).to(torch.int32)
    return terms, torch.clamp(weights, min=0.0)


class ChunkedImpactIndex(NamedTuple):
    """Impact-ordered postings split into doc-range chunks: exact whenever
    every (term, chunk) has ≤ cap_per_chunk postings; the cap prunes per
    (term, doc range), so skewed terms keep their top impacts in every
    range."""

    post_doc: torch.Tensor  # int16 [V+1, C, capc]: uint16 local doc ids, pad 0xFFFF
    post_impact: torch.Tensor  # f16 [V+1, C, capc], pad = 0
    n_docs: int
    docs_per_chunk: int
    vocab_size: int
    cap_per_chunk: int
    nnz_kept: int

    def nbytes(self) -> int:
        return self.post_doc.nbytes + self.post_impact.nbytes

    @property
    def num_chunks(self) -> int:
        return self.post_doc.shape[1]


def build_chunked_impact_index(
    entry_term: np.ndarray,
    entry_doc: np.ndarray,
    impacts: np.ndarray,
    vocab_size: int,
    n_docs: int,
    docs_per_chunk: int = 32768,
    cap_per_chunk: int = 64,
    device="cpu",
) -> ChunkedImpactIndex:
    """Host-side build from COO postings; the arrays then live on ``device``."""
    if docs_per_chunk >= CHUNK_SENTINEL:
        raise ValueError(f"docs_per_chunk must be < {CHUNK_SENTINEL}, got {docs_per_chunk}")
    num_chunks = -(-n_docs // docs_per_chunk)
    t = np.asarray(entry_term, dtype=np.int64)
    # the chunked form's per-term capacity is cap_per_chunk × num_chunks
    _warn_unsafe_terms(
        np.bincount(t, minlength=vocab_size)[:vocab_size],
        cap_per_chunk * num_chunks,
        int(t.size),
    )
    d = np.asarray(entry_doc, dtype=np.int64)
    v = np.asarray(impacts, dtype=np.float32)
    c = d // docs_per_chunk
    local = (d % docs_per_chunk).astype(np.uint16)
    group = t * num_chunks + c  # (term, chunk) group key
    order = np.lexsort((-v, group))
    group, local, v = group[order], local[order], v[order]
    counts = np.bincount(group, minlength=vocab_size * num_chunks)
    starts = np.zeros(vocab_size * num_chunks + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    rank = np.arange(group.size, dtype=np.int64) - starts[group]
    keep = rank < cap_per_chunk
    post_doc = np.full(
        (vocab_size + 1, num_chunks, cap_per_chunk), CHUNK_SENTINEL, dtype=np.uint16
    )
    post_imp = np.zeros((vocab_size + 1, num_chunks, cap_per_chunk), dtype=np.float16)
    gk = group[keep]
    post_doc[gk // num_chunks, gk % num_chunks, rank[keep]] = local[keep]
    post_imp[gk // num_chunks, gk % num_chunks, rank[keep]] = v[keep]
    return ChunkedImpactIndex(
        post_doc=torch.as_tensor(post_doc.view(np.int16), device=device),
        post_impact=torch.as_tensor(post_imp, device=device),
        n_docs=n_docs,
        docs_per_chunk=docs_per_chunk,
        vocab_size=vocab_size,
        cap_per_chunk=cap_per_chunk,
        nnz_kept=int(keep.sum()),
    )


def _sparse_coo(sparse_index) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Real (term, doc, weight) postings of a fixed-K SparseIndex (host)."""
    term = sparse_index.entry_term.cpu().numpy().ravel()
    n, kk = sparse_index.entry_term.shape
    doc = np.repeat(np.arange(n, dtype=np.int64), kk)
    imp = sparse_index.entry_weight.cpu().numpy().ravel()
    keep = term < sparse_index.vocab_size
    return term[keep], doc[keep], imp[keep]


def sparse_to_impact_index(sparse_index, cap: int = 4096) -> ImpactIndex:
    """Doc-major fixed-K SparseIndex → flat impact form, on its device."""
    term, doc, imp = _sparse_coo(sparse_index)
    return build_impact_index(
        term, doc, imp,
        vocab_size=sparse_index.vocab_size,
        n_docs=sparse_index.n_docs,
        cap=cap,
        device=sparse_index.entry_term.device,
    )


def sparse_to_chunked_impact_index(
    sparse_index, docs_per_chunk: int = 32768, cap_per_chunk: int = 64
) -> ChunkedImpactIndex:
    """Doc-major fixed-K SparseIndex → chunked impact form, on its device."""
    term, doc, imp = _sparse_coo(sparse_index)
    return build_chunked_impact_index(
        term, doc, imp,
        vocab_size=sparse_index.vocab_size,
        n_docs=sparse_index.n_docs,
        docs_per_chunk=docs_per_chunk,
        cap_per_chunk=cap_per_chunk,
        device=sparse_index.entry_term.device,
    )
