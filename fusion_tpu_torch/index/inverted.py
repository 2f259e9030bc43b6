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
    scorer (``ops/scatter_score.py``) and the sort form
    ``chunked_impact_search``.

The build functions run on the host (offline index work: numpy, or the C++
packers of ``native/`` above 2M postings) and put the arrays on ``device``;
they give the arrays that ``fusion_tpu/index/inverted.py`` gives.
"""

from __future__ import annotations

import os
import warnings
from typing import NamedTuple

import numpy as np
import torch

from fusion_tpu_torch import native
from fusion_tpu_torch.core.ranked import RankedLists, stable_topk
from fusion_tpu_torch.ops.segscan import segmented_run_totals
from fusion_tpu_torch.parallel.sharding import INDEX_AXIS, default_index_rank, globalize, merge_shards

# Query terms whose document frequency exceeds CAP_SAFE_DF_RATIO × cap are
# quality-unsafe under impact-ordered capping (the JAX package's planted-
# relevance study: overlap@100 0.94 with stopword-filtered queries, 0.39/0.20
# when raw zipf queries hit ultra-common truncated terms).  Preprocessing
# strips high-df terms from queries; the guards make the contract visible.
CAP_SAFE_DF_RATIO = 8

CHUNK_SENTINEL = 0xFFFF  # uint16 pad (docs_per_chunk must stay < 65535)

# builds above this many postings go through the C++ packers by default
NATIVE_MIN_POSTINGS = 2_000_000


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

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        extra = {} if self.term_df is None else {"term_df": np.asarray(self.term_df, np.int32)}
        np.savez_compressed(
            os.path.join(path, "impact_index.npz"),
            post_doc=self.post_doc.cpu().numpy(),
            post_impact=self.post_impact.cpu().numpy(),
            meta=np.array([self.n_docs, self.vocab_size, self.cap, self.nnz_kept], np.int64),
            **extra,
        )

    @classmethod
    def load(cls, path: str, device="cuda") -> "ImpactIndex":
        device = torch.device(device)
        with np.load(os.path.join(path, "impact_index.npz")) as z:
            n, v, cap, nnz = (int(x) for x in z["meta"])
            return cls(
                post_doc=torch.as_tensor(z["post_doc"], device=device),
                post_impact=torch.as_tensor(z["post_impact"], device=device),
                n_docs=n, vocab_size=v, cap=cap, nnz_kept=nnz,
                term_df=z["term_df"] if "term_df" in z.files else None,
            )

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
    use_native: bool | None = None,
    *,
    device,
) -> ImpactIndex:
    """Host-side build from COO postings; the arrays then live on ``device``.

    ``use_native=None`` routes builds of more than 2M postings through the
    C++ packer (``native.pack_flat_impact``: a bounded heap per term instead
    of a global lexsort), True always (numpy when it does not compile); both
    give the same arrays where impacts do not tie at a term's cap."""
    t = np.asarray(entry_term, dtype=np.int64)
    if use_native is None:
        use_native = t.size > NATIVE_MIN_POSTINGS
    counts = np.bincount(t, minlength=vocab_size)
    df = counts[:vocab_size].astype(np.int32)
    _warn_unsafe_terms(df, cap, int(t.size))
    packed = native.pack_flat_impact(entry_term, entry_doc, impacts, vocab_size, n_docs, cap) if use_native else None
    if packed is not None:
        post_doc, post_imp, kept = packed
    else:
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
        kept = int(keep.sum())
    return ImpactIndex(
        post_doc=torch.as_tensor(post_doc, device=device),
        post_impact=torch.as_tensor(post_imp, device=device),
        n_docs=n_docs,
        vocab_size=vocab_size,
        cap=cap,
        nnz_kept=kept,
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


def shard_impact_index(index: ImpactIndex, n_shards: int, *, rank: int | None = None) -> "ShardedImpactIndex":
    """Split an ImpactIndex into ``n_shards`` doc-range shards and keep shard
    ``rank`` (default: this process's index coordinate,
    ``parallel.sharding.default_index_rank``) on the index's device.

    Each shard keeps, per term, its doc range's postings re-packed to the
    front (impact order kept), with local doc ids and pad ``docs_per_shard``:
    the host repack of the JAX package, whose ``[S, V+1, P]`` stack holds
    these rows.  Host-side build work."""
    rank = default_index_rank(n_shards) if rank is None else rank
    docs = index.post_doc.cpu().numpy()
    imps = index.post_impact.cpu().numpy()
    n = index.n_docs
    per = -(-n // n_shards)
    lo, hi = rank * per, min((rank + 1) * per, n)
    in_shard = (docs >= lo) & (docs < hi)
    # stable front-packing per row keeps impact order
    order = np.argsort(~in_shard, axis=1, kind="stable")
    d_s = np.take_along_axis(np.where(in_shard, docs - lo, per), order, axis=1).astype(np.int32)
    i_s = np.take_along_axis(np.where(in_shard, imps, 0), order, axis=1).astype(np.float16)
    device = index.post_doc.device
    return ShardedImpactIndex(
        post_doc=torch.as_tensor(d_s, device=device),
        post_impact=torch.as_tensor(i_s, device=device),
        n_docs=n,
        docs_per_shard=per,
        vocab_size=index.vocab_size,
        cap=docs.shape[1],
        term_df=index.term_df,
    )


class ShardedImpactIndex(NamedTuple):
    """One rank's doc-range shard of an ImpactIndex (``shard_impact_index``)."""

    post_doc: torch.Tensor  # int32 [V+1, P] (local doc ids; pad = docs_per_shard)
    post_impact: torch.Tensor  # f16 [V+1, P]
    n_docs: int
    docs_per_shard: int
    vocab_size: int
    cap: int
    term_df: object = None  # host df [V]: the query-time cap guard

    def unsafe_query_term_frac(self, q_terms) -> float:
        return ImpactIndex.unsafe_query_term_frac(self, q_terms)

    def local(self) -> ImpactIndex:
        """The shard as an ImpactIndex over its ``docs_per_shard`` local docs."""
        return ImpactIndex(post_doc=self.post_doc, post_impact=self.post_impact, n_docs=self.docs_per_shard,
                           vocab_size=self.vocab_size, cap=self.cap, nnz_kept=0, term_df=self.term_df)


def sharded_impact_search(
    q_terms: torch.Tensor,
    q_weights: torch.Tensor,
    index: ShardedImpactIndex,
    mesh,
    k: int = 1000,
) -> RankedLists:
    """Index-parallel impact search: each rank scores its doc-range shard
    (queries replicated), and the per-shard top-k lists all-gather and merge
    (``parallel.sharding.merge_shards``).  Depth ``min(k, docs_per_shard)``,
    as the JAX function's."""
    per = index.docs_per_shard
    k = min(k, per)
    local = impact_search(q_terms, q_weights, index.local(), k=k)
    return merge_shards(globalize(local, mesh.coords[INDEX_AXIS], per), local.scores, k, mesh)


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

    def save(self, path: str) -> None:
        """The JAX package's file: local doc ids as uint16."""
        os.makedirs(path, exist_ok=True)
        np.savez_compressed(
            os.path.join(path, "chunked_impact_index.npz"),
            post_doc=self.post_doc.cpu().numpy().view(np.uint16),
            post_impact=self.post_impact.cpu().numpy(),
            meta=np.array(
                [self.n_docs, self.docs_per_chunk, self.vocab_size, self.cap_per_chunk, self.nnz_kept],
                np.int64,
            ),
        )

    @classmethod
    def load(cls, path: str, device="cuda") -> "ChunkedImpactIndex":
        device = torch.device(device)
        with np.load(os.path.join(path, "chunked_impact_index.npz")) as z:
            n, per, v, cap, nnz = (int(x) for x in z["meta"])
            return cls(
                post_doc=torch.as_tensor(z["post_doc"].view(np.int16), device=device),
                post_impact=torch.as_tensor(z["post_impact"], device=device),
                n_docs=n, docs_per_chunk=per, vocab_size=v, cap_per_chunk=cap, nnz_kept=nnz,
            )


def build_chunked_impact_index(
    entry_term: np.ndarray,
    entry_doc: np.ndarray,
    impacts: np.ndarray,
    vocab_size: int,
    n_docs: int,
    docs_per_chunk: int = 32768,
    cap_per_chunk: int = 64,
    use_native: bool | None = None,
    *,
    device,
) -> ChunkedImpactIndex:
    """Host-side build from COO postings; the arrays then live on ``device``.

    ``use_native`` as ``build_impact_index``'s, through
    ``native.pack_chunked_impact`` (a bounded heap per (term, chunk))."""
    if docs_per_chunk >= CHUNK_SENTINEL:
        raise ValueError(f"docs_per_chunk must be < {CHUNK_SENTINEL}, got {docs_per_chunk}")
    num_chunks = -(-n_docs // docs_per_chunk)
    t = np.asarray(entry_term, dtype=np.int64)
    if use_native is None:
        use_native = t.size > NATIVE_MIN_POSTINGS
    # the chunked form's per-term capacity is cap_per_chunk × num_chunks
    _warn_unsafe_terms(
        np.bincount(t, minlength=vocab_size)[:vocab_size],
        cap_per_chunk * num_chunks,
        int(t.size),
    )
    packed = native.pack_chunked_impact(
        entry_term, entry_doc, impacts, vocab_size, n_docs, docs_per_chunk, cap_per_chunk
    ) if use_native else None
    if packed is not None:
        post_doc, post_imp, kept = packed
    else:
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
        kept = int(keep.sum())
    return ChunkedImpactIndex(
        post_doc=torch.as_tensor(post_doc.view(np.int16), device=device),
        post_impact=torch.as_tensor(post_imp, device=device),
        n_docs=n_docs,
        docs_per_chunk=docs_per_chunk,
        vocab_size=vocab_size,
        cap_per_chunk=cap_per_chunk,
        nnz_kept=kept,
    )


def chunked_impact_search(
    q_terms: torch.Tensor,  # int [Q, Kq] (pad >= vocab_size)
    q_weights: torch.Tensor,  # f32 [Q, Kq]
    index: ChunkedImpactIndex,
    k: int = 1000,
    local_k: int = 128,
    bf16_payload: bool = True,
    packed_sort: bool = True,
) -> RankedLists:
    """Query-driven scoring over the chunked impact index, the sort form:
    per (query, chunk) row the gathered postings are sorted by local doc id
    and each doc's run summed (``ops/segscan.py``); each chunk contributes
    its top ``local_k`` docs to the final top-k (a chunk holding more of the
    global top-k is the approximation, quantified by
    ``scripts/recall_study.py``).

    ``bf16_payload`` multiplies and sorts 2-byte payloads (f16 impacts times
    f16 query weights, ≤0.4 % relative error per term; the runs sum in
    f32), False f32 ones.  ``packed_sort`` sorts one key of (doc id << 16 |
    f16 impact bits) instead of a key and a payload: impacts are ≥ 0, so the
    bits order as the values, and each run's entries come out in one order
    whatever the sort.  Selects are exact and stable where the JAX package's
    per-chunk select is ``approx_max_k``."""
    q, kq = q_terms.shape
    vp1, c, capc = index.post_doc.shape
    k = min(k, index.n_docs)
    terms = q_terms.long().clamp(0, vp1 - 1)
    docs = index.post_doc[terms].long() & 0xFFFF  # [Q, Kq, C, capc] local ids
    if bf16_payload:
        vals = index.post_impact[terms] * q_weights[..., None, None].to(torch.float16)
    else:
        vals = index.post_impact[terms].float() * q_weights.float()[..., None, None]
    width = kq * capc
    docs = docs.permute(0, 2, 1, 3).reshape(q * c, width)
    vals = vals.permute(0, 2, 1, 3).reshape(q * c, width)
    if packed_sort and bf16_payload:
        key_s, _ = torch.sort((docs << 16) | (vals.view(torch.int16).long() & 0xFFFF), dim=1)
        docs_s = key_s >> 16
        vals_s = (key_s & 0xFFFF).to(torch.int16).view(torch.float16)
    else:
        docs_s, order = torch.sort(docs, dim=1, stable=True)
        vals_s = torch.gather(vals, 1, order)
    seg, is_end = segmented_run_totals(docs_s, vals_s.float(), kq)
    scores = torch.where(is_end & (docs_s != CHUNK_SENTINEL), seg, -torch.inf)
    lk = min(local_k, width)
    if width > 2 * lk:
        loc_vals, loc_pos = stable_topk(scores, lk)
        loc_docs = torch.gather(docs_s, 1, loc_pos)
    else:
        lk, loc_vals, loc_docs = width, scores, docs_s
    chunk_of_row = (torch.arange(q * c, device=docs.device) % c)[:, None]
    gids = torch.where(torch.isfinite(loc_vals), chunk_of_row * index.docs_per_chunk + loc_docs, -1)
    pool_scores, pool_ids = loc_vals.reshape(q, c * lk), gids.reshape(q, c * lk)
    kk = min(k, pool_scores.shape[-1])
    top_scores, pos = stable_topk(pool_scores, kk)
    top_ids = torch.where(torch.isfinite(top_scores), torch.gather(pool_ids, 1, pos), -1)
    if kk < k:
        top_scores = torch.nn.functional.pad(top_scores, (0, k - kk), value=-torch.inf)
        top_ids = torch.nn.functional.pad(top_ids, (0, k - kk), value=-1)
    return RankedLists(ids=top_ids.to(torch.int32), scores=top_scores)


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
