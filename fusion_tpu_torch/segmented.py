"""Streaming index updates: a segmented hybrid searcher.

A ``HybridSearcher`` is an offline build: adding one document would mean
building every index again.  The segmented searcher adds and deletes
documents while it serves, arranged around what each index costs:

  * **neural legs** (DPR / SPLADE / ColBERT / the cross-encoder's doc
    tokens): encoding is the cost, so new documents become a NEW SEGMENT —
    only the delta is encoded.  A query asks every segment for its
    per-system top-k (``HybridSearcher.search_systems``) and the lists of
    each system are merged by score: exact, because within a system scores
    compare across segments (int8 scales are per row; SPLADE and MaxSim
    scores are absolute).  A compressed ColBERT segment quantizes against
    its own centroids, the one approximation.
  * **BM25**: idf depends on the global df and N, so per-segment BM25 scores
    do not compare.  The lexical build is the cheap one (the C++ posting
    builder of ``native/``), so BM25 is REBUILT over the whole corpus on
    every add and delete, and idf stays exact.

Deletes are tombstones: the ids leave every merged list at once and their
neural rows stay until ``compact()`` folds the segments into one (one
re-encode), the segment merge.  One lock serializes searches against
updates, so an HTTP server (``server.py``) can serve while documents are
added.  The merge, fusion and rerank run on the searcher's ``device``; each
segment's cross-encoder doc tokens stay on the device where they were built
and the rerank gathers each segment's rows from its own table.

With ``mesh=`` (``parallel.sharding.make_mesh``) every segment and the
global BM25 index serve as ``ShardedHybridSearcher`` over the mesh ``index``
axis: each rank builds the same segments and keeps its shard of each, and the
rerank gathers each candidate's tokens from the rank that owns its row (an
ownership-masked gather and a sum all-reduce).  Every rank must make the same
updates and searches in the same order.
"""

from __future__ import annotations

import threading
import time
from typing import Mapping, Sequence

import numpy as np
import torch

from fusion_tpu_torch.core.device import check_use_pallas, resolve_device
from fusion_tpu_torch.core.ranked import PAD_ID, RankedLists, stable_topk
from fusion_tpu_torch.fusion.aggregator import Aggregator
from fusion_tpu_torch.models.encoder import token_tensors
from fusion_tpu_torch.serving import HybridSearcher, rerank_head_merge

__all__ = ["SegmentedHybridSearcher"]

# the build arguments of the global BM25 searcher
_BM25_KEYS = (
    "k1", "b", "impact_cap", "bm25_preprocess", "scale_mode", "topk",
    "int8_corpus",  # selects the quantized dense-impact form — must match
    "device",
)


def _merge_ranked(parts: list[RankedLists], k: int) -> RankedLists:
    """Merge per-segment top-k lists of ONE system (external ids, disjoint
    corpora) into the global top-k by score; equal scores keep the lower
    position, so the earlier part first (as ``lax.top_k``)."""
    if len(parts) == 1:
        return _pad_to(parts[0], k)
    ids = torch.cat([p.ids for p in parts], dim=1)
    scores = torch.cat([p.scores for p in parts], dim=1)
    top_scores, pos = stable_topk(scores, min(k, ids.shape[1]))
    return _pad_to(RankedLists(torch.gather(ids, 1, pos).to(torch.int32), top_scores), k)


def _pad_to(r: RankedLists, k: int) -> RankedLists:
    d = r.depth
    if d >= k:
        return r
    pad = torch.nn.functional.pad
    return RankedLists(pad(r.ids, (0, k - d), value=PAD_ID), pad(r.scores, (0, k - d), value=-torch.inf))


class SegmentedHybridSearcher:
    """Hybrid serving with online document adds and deletes (neural
    segments + a global BM25 index).

    The query surface of ``HybridSearcher.search``, built with its keyword
    arguments (``device`` among them, given to every segment's build).
    ``bm25_docs`` (when lexical search is wanted) are the preprocessed
    strings of the initial corpus, and ``add_documents`` takes the delta's.
    ``build_seconds`` holds the host seconds of the last BM25 rebuild
    (``bm25``) and of the last segment build (``segment``)."""

    def __init__(
        self,
        corpus: Mapping[int, str],
        bm25_docs: Sequence[str] | None = None,
        **build_kwargs,
    ) -> None:
        self._kwargs = dict(build_kwargs)
        self.mesh = self._kwargs.pop("mesh", None)
        self.device = resolve_device(self._kwargs.get("device", "cuda"))
        self._kwargs["device"] = self.device
        self.topk = int(build_kwargs.get("topk", 1000))
        self.fusion_method = build_kwargs.get("fusion_method", "rrf")
        self.normalization = build_kwargs.get("normalization")
        self.linear_weights = build_kwargs.get("linear_weights")
        self.rerank_depth = int(build_kwargs.get("rerank_depth", 100))
        self.rerank_chunk = int(self._kwargs.pop("rerank_chunk", 512))
        self.percentile_distributions = self._kwargs.pop("percentile_distributions", None)
        self.cross_encoder = build_kwargs.get("cross_encoder")
        self.build_seconds: dict[str, float] = {}

        # one coarse lock serializes searches against add/delete/compact —
        # the advertised use is updating WHILE an HTTP dispatcher serves
        self._lock = threading.RLock()
        self._tombstones: set[int] = set()
        self._has_bm25 = bm25_docs is not None
        self._bm25_docs: list[str] = list(bm25_docs) if bm25_docs else []
        self._bm25_ids: list[int] = list(corpus.keys()) if self._has_bm25 else []
        self.bm25_searcher: HybridSearcher | None = None
        if self._has_bm25:
            self._rebuild_bm25()

        self.segments: list[HybridSearcher] = []
        self._corpora: list[dict] = []
        self._ce_len: int | None = None
        if self._neural_active:
            self._add_segment(dict(corpus))

    # ------------------------------------------------------------------
    @property
    def _neural_active(self) -> bool:
        return any(
            self._kwargs.get(k) is not None
            for k in ("dense_model", "splade_model", "colbert_model", "cross_encoder")
        )

    @property
    def n_docs(self) -> int:
        """Logical (servable) doc count — tombstoned docs excluded."""
        if self._has_bm25:
            return len(self._bm25_ids)
        physical = {i for c in self._corpora for i in c}
        return len(physical - self._tombstones)

    @property
    def active_systems(self) -> list[str]:
        # bm25 and the rerank stage are the segmented searcher's own; the
        # neural legs are what the segments' searcher reports
        out = ["bm25"] if self._has_bm25 else []
        if self.segments:
            seg_systems = self.segments[0].active_systems
            out += [s for s in ("dpr", "splade", "colbert") if s in seg_systems]
        if self.cross_encoder is not None:
            out.append("monobert")
        return out

    # ------------------------------------------------------------------
    def _rebuild_bm25(self) -> None:
        """Global lexical rebuild — exact idf over ALL segments' docs."""
        t0 = time.perf_counter()
        kwargs = {k: self._kwargs[k] for k in _BM25_KEYS if k in self._kwargs}
        corpus = dict(zip(self._bm25_ids, self._bm25_docs))
        self.bm25_searcher = self._maybe_shard(HybridSearcher.build(corpus, bm25_docs=self._bm25_docs, **kwargs))
        self.build_seconds["bm25"] = time.perf_counter() - t0

    def _maybe_shard(self, seg: HybridSearcher):
        """``seg`` itself, or with a mesh this rank's shard of it."""
        if self.mesh is None:
            return seg
        from fusion_tpu_torch.serving_sharded import ShardedHybridSearcher

        return ShardedHybridSearcher.from_searcher(seg, self.mesh, impact_cap=self._kwargs.get("impact_cap"))

    def _neural_kwargs(self) -> dict:
        kw = {k: v for k, v in self._kwargs.items() if k not in ("k1", "b", "bm25_preprocess")}
        if self._ce_len is not None:
            # segments must share the CE doc-token width to merge candidates
            kw["ce_max_doc_tokens"] = self._ce_len
        return kw

    def _add_segment(self, corpus: dict) -> None:
        t0 = time.perf_counter()
        seg = HybridSearcher.build(corpus, bm25_docs=None, **self._neural_kwargs())
        if seg.ce_doc_tokens is not None and self._ce_len is None:
            self._ce_len = int(seg.ce_doc_tokens.shape[1])
        self.segments.append(self._maybe_shard(seg))
        self._corpora.append(corpus)
        self._refresh_ce_tables()
        self.build_seconds["segment"] = time.perf_counter() - t0

    def _refresh_ce_tables(self) -> None:
        """External-id → (segment, local row) lookup for the rerank gather:
        host arrays over each segment's ``corpus_ids``.  The doc-token
        tables themselves stay in their segments, never concatenated."""
        if self.cross_encoder is None:
            self._ce_lookup = None
            return
        ids, seg_of, row_of = [], [], []
        for si, s in enumerate(self.segments):
            cid = np.asarray(s.corpus_ids, np.int64)
            ids.append(cid)
            seg_of.append(np.full(cid.size, si, np.int32))
            row_of.append(np.arange(cid.size, dtype=np.int32))
        ids = np.concatenate(ids)
        order = np.argsort(ids, kind="stable")
        self._ce_lookup = (ids[order], np.concatenate(seg_of)[order], np.concatenate(row_of)[order])

    # ------------------------------------------------------------------
    def add_documents(self, corpus: Mapping[int, str], bm25_docs: Sequence[str] | None = None) -> None:
        """Online add: encodes ONLY the new docs (new neural segment) and
        rebuilds the global BM25 index (exact idf).

        Re-adding a previously deleted id is allowed once its row is gone
        from the neural segments (i.e. after :meth:`compact`); before
        that, the stale row would duplicate the new one."""
        with self._lock:
            new_ids = {int(i) for i in corpus.keys()}
            physical = {i for c in self._corpora for i in c}
            blocked = new_ids & physical
            if blocked:
                raise ValueError(
                    "doc ids still present in neural segments (compact() "
                    f"before re-adding deleted ids): {sorted(blocked)[:5]}"
                )
            live = set(self._bm25_ids) if self._has_bm25 else physical
            dup = new_ids & live
            if dup:
                raise ValueError(f"doc ids already indexed: {sorted(dup)[:5]}")
            self._tombstones -= new_ids
            if self._has_bm25:
                if bm25_docs is None or len(bm25_docs) != len(corpus):
                    raise ValueError(
                        "lexical search is active: pass the delta's "
                        "preprocessed bm25_docs alongside the raw corpus"
                    )
                self._bm25_ids.extend(corpus.keys())
                self._bm25_docs.extend(bm25_docs)
                self._rebuild_bm25()
            if self._neural_active:
                self._add_segment(dict(corpus))

    def delete_documents(self, ids) -> None:
        """Online delete: tombstone the ids (filtered from every merged
        list) and rebuild BM25 without them (exact df/N).  The neural
        segments keep the rows until :meth:`compact` reclaims them."""
        with self._lock:
            ids = {int(i) for i in ids}
            known = set(self._bm25_ids) if self._has_bm25 else {i for c in self._corpora for i in c}
            if self._neural_active and not self._has_bm25:
                known -= self._tombstones
            missing = ids - known
            if missing:
                raise ValueError(f"unknown doc ids: {sorted(missing)[:5]}")
            if self._neural_active:
                # rows stay in the segments until compact(); filter at merge
                self._tombstones |= ids
            if self._has_bm25:
                keep = [(i, d) for i, d in zip(self._bm25_ids, self._bm25_docs) if i not in ids]
                self._bm25_ids = [i for i, _ in keep]
                self._bm25_docs = [d for _, d in keep]
                self._rebuild_bm25()

    def compact(self) -> None:
        """Fold all neural segments into one (one full re-encode) and
        reclaim tombstoned rows."""
        with self._lock:
            if not self._neural_active:
                self._tombstones = set()  # BM25 was already rebuilt clean
                return
            if len(self.segments) <= 1 and not self._tombstones:
                return
            union: dict = {}
            for c in self._corpora:
                union.update(c)
            for i in self._tombstones:
                union.pop(i, None)
            self._tombstones = set()
            self.segments = []
            self._corpora = []
            self._add_segment(union)

    # ------------------------------------------------------------------
    def search(
        self, queries: Sequence[str], batch_size: int = 32, use_pallas: bool | None = None,
    ) -> tuple[RankedLists, float]:
        """The contract of ``HybridSearcher.search`` (external ids; ranked
        lists on the host, ms per query), serialized against updates by the
        instance lock."""
        check_use_pallas(use_pallas)
        with self._lock:
            return self._search_locked(queries, batch_size, use_pallas)

    def _search_locked(
        self, queries: Sequence[str], batch_size: int, use_pallas: bool | None
    ) -> tuple[RankedLists, float]:
        t0 = time.perf_counter()
        per_system: dict[str, list[RankedLists]] = {}
        sources = ([self.bm25_searcher] if self.bm25_searcher is not None else []) + self.segments
        for searcher in sources:
            for name, r in searcher.search_systems(queries, batch_size=batch_size, use_pallas=use_pallas).items():
                per_system.setdefault(name, []).append(
                    RankedLists(r.ids.to(self.device), r.scores.to(self.device))
                )
        merged = {
            name: self._strip_tombstones(_merge_ranked(parts, self.topk))
            for name, parts in per_system.items()
        }
        if len(merged) == 1:
            fused = next(iter(merged.values()))
        else:
            weights = self.linear_weights or {s: 1.0 / len(merged) for s in merged}
            fused = Aggregator.fuse(
                merged,
                method=self.fusion_method,
                normalization=self.normalization,
                linear_weights=weights if self.fusion_method == "nsf" else None,
                percentile_distributions=self.percentile_distributions,
                return_topk=self.topk,
            )
        if self.cross_encoder is not None:
            fused = self._rerank(queries, fused, batch_size)
        fused = RankedLists(fused.ids.cpu(), fused.scores.cpu())
        elapsed = (time.perf_counter() - t0) * 1000 / max(len(queries), 1)
        return fused, elapsed

    def _strip_tombstones(self, r: RankedLists) -> RankedLists:
        """Deleted docs sink to (-1, -inf) tail slots until compact()
        reclaims their rows (the effective depth shrinks by the tombstoned
        entries that had made the top-k)."""
        if not self._tombstones:
            return r
        dead = torch.as_tensor(sorted(self._tombstones), dtype=torch.int64, device=r.ids.device)
        bad = torch.isin(r.ids.long(), dead)
        scores, order = torch.sort(torch.where(bad, -torch.inf, r.scores), dim=1, descending=True, stable=True)
        ids = torch.gather(torch.where(bad, PAD_ID, r.ids), 1, order)
        return RankedLists(ids, scores)

    # ------------------------------------------------------------------
    def _rerank(self, queries: Sequence[str], fused: RankedLists, batch_size: int) -> RankedLists:
        """The cross-encoder over the fused head, in the flat form (every
        pair padded to the segments' doc width).  External ids span
        segments: each segment's rows are gathered from its own table
        ([Q, kr, Ld] per segment, combined by select masks); a sharded
        segment's rows come from the ranks that own them."""
        ce = self.cross_encoder
        kr = min(self.rerank_depth, fused.depth)
        head_ids = fused.ids[:, :kr].cpu().numpy()
        # external id -> (segment, local row), host-side sorted lookup
        sorted_ids, seg_of, row_of = self._ce_lookup
        pos = np.clip(np.searchsorted(sorted_ids, head_ids), 0, len(sorted_ids) - 1)
        found = sorted_ids[pos] == head_ids
        segs = np.where(found, seg_of[pos], -1)
        rows = np.where(found, row_of[pos], 0)
        valid = found & (head_ids != PAD_ID)

        out_parts = []
        q_len = self.segments[0].ce_query_length
        for start in range(0, len(queries), batch_size):
            chunk = list(queries[start : start + batch_size])
            sl = slice(start, start + len(chunk))
            q_ids, q_mask = token_tensors(*ce.encode_queries_raw(chunk, max_query_tokens=q_len), self.device)
            d_ids = d_mask = None
            for si, seg in enumerate(self.segments):
                pick = (segs[sl] == si) & valid[sl]
                if not pick.any():
                    continue
                if self.mesh is not None:
                    r = torch.as_tensor(np.where(pick, rows[sl], -1), dtype=torch.long, device=self.device)
                    ti, tm = seg._owned_tokens(r)
                else:
                    r = torch.as_tensor(np.where(pick, rows[sl], 0), dtype=torch.long,
                                        device=seg.ce_doc_tokens.device)
                    m = torch.as_tensor(pick, device=self.device)[..., None].long()
                    ti = ce._token_ids(seg.ce_doc_tokens[r]).to(self.device) * m
                    tm = seg.ce_doc_mask[r].to(self.device).long() * m
                d_ids = ti if d_ids is None else d_ids + ti
                d_mask = tm if d_mask is None else d_mask + tm
            if d_ids is None:  # every head slot is a pad
                d_ids = d_mask = torch.zeros((len(chunk), kr, 1), dtype=torch.long, device=self.device)
            logits = ce.rerank_tokens(q_ids, q_mask, d_ids, d_mask, pair_chunk=self.rerank_chunk)
            part = RankedLists(fused.ids[sl], fused.scores[sl])
            out_parts.append(rerank_head_merge(part, part.ids[:, :kr], logits))
        return RankedLists(
            ids=torch.cat([p.ids for p in out_parts]), scores=torch.cat([p.scores for p in out_parts])
        )
