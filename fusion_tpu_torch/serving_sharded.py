"""Mesh-sharded hybrid serving: the whole pipeline over many devices.

``ShardedHybridSearcher`` serves a corpus whose indexes are doc-range sharded
over the mesh ``index`` axis (``parallel/sharding.py``).  The port runs one
process per device: every rank holds its own shard of each index, answers the
same query batch with the same calls in the same order, and per batch

  encodes the queries (replicated: every rank runs the encoders)
    → searches its shard of each leg with the single-device forms
      (BM25 impact, dense int8 / bf16 block or fused (K2), SPLADE scatter (K3)
      or impact with the per-shard exact rescore, or the dense matrix,
      ColBERT PLAID (K4 in the rescore's gathers)), each with a local top-k
    → all-gathers and merges the tiny per-shard lists (one merge per leg,
      ``merge_shards``: on equal scores the lower shard first)
    → fuses the merged lists (replicated)
    → reranks: the rank OWNING each fused candidate supplies its doc tokens
      (an ownership-masked gather and a sum all-reduce), the cross-encoder
      forward is split by query rows over the ranks, and the logits
      all-gather back.  The packed stage is planned on the host from the
      fetched head ids, as on one device; each rank scores ``R/S`` of the
      rows and the slot scatter is summed across the ranks.

Every ``kl`` comes from ``docs_per_shard``, never from what a shard holds, so
the ranks always make the same collective calls.  ``from_searcher`` is the
offline step: on every rank it repacks the built ``HybridSearcher``'s
indexes on the host exactly as the JAX package does and keeps the rank's
shard.  A bucketed searcher shards to the flat rerank, as in the JAX package.
``dense_local_topk='approx'`` is served by the exact select.  JAX's
``_merge_shards`` is ``parallel.sharding.merge_shards`` (the one merge),
under both names here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from fusion_tpu_torch.core.ranked import RankedLists
from fusion_tpu_torch.index.compression import CompressedTokenIndex
from fusion_tpu_torch.index.dense_quant import QuantizedDenseIndex
from fusion_tpu_torch.index.inverted import (
    ShardedImpactIndex,
    activations_to_query_terms,
    impact_search,
    shard_impact_index,
)
from fusion_tpu_torch.index.plaid import ShardedPlaidIndex, _plaid_shard_search, shard_plaid_index
from fusion_tpu_torch.index.sparse import SpladeRescoreStore, sparse_rescore
from fusion_tpu_torch.models.heads import l2_normalize
from fusion_tpu_torch.ops.dense_topk import fused_dense_topk
from fusion_tpu_torch.ops.mips import matmul_f32
from fusion_tpu_torch.ops.scatter_score import (
    ShardedChunkedImpactIndex,
    local_scatter_search,
    shard_chunked_impact_index,
)
from fusion_tpu_torch.ops.topk import blockwise_topk_offset
from fusion_tpu_torch.parallel.sharding import (
    INDEX_AXIS,
    Mesh,
    all_gather,
    all_reduce_sum,
    globalize,
    merge_shards,
)
from fusion_tpu_torch.serving import HybridSearcher

_merge_shards = merge_shards


class ShardedDenseLeg(NamedTuple):
    """One rank's doc-range shard of a dense corpus matrix (int8 rows +
    scales, or a bf16 matrix with unit scales)."""

    values: torch.Tensor  # int8 | bf16 [per, H]
    scales: torch.Tensor  # f32 [per]
    normalized: bool  # queries L2-normalize; rows pre-normalized at build
    n_docs: int
    docs_per_shard: int


def _shard_dense_matrix(corpus, similarity: str, n_shards: int, *, rank: int = 0, n_docs: int | None = None
                        ) -> ShardedDenseLeg:
    """Host-side repack of a dense corpus (QuantizedDenseIndex or bf16
    matrix; its first ``n_docs`` rows, the real ones) into doc-range shards,
    as the JAX package's: docs per shard rounded up to 2,048 (the fused
    kernel's doc block), a bf16 matrix L2-normalized in f32 for ``cos_sim``
    with unit scales, pad rows zero with scale 0.  Keeps shard ``rank`` on
    the corpus's device."""
    if isinstance(corpus, QuantizedDenseIndex):
        device = corpus.values.device
        vals = corpus.values.cpu().numpy()
        scales = corpus.scales.cpu().numpy().astype(np.float32)
        normalized = bool(corpus.normalized)
    else:
        device = corpus.device
        vals = corpus.float().cpu().numpy()
        normalized = similarity == "cos_sim"
        if normalized:
            norms = np.linalg.norm(vals, axis=-1, keepdims=True)
            vals = vals / np.maximum(norms, 1e-12)
        scales = np.ones(vals.shape[0], dtype=np.float32)
    if n_docs is not None:
        vals, scales = vals[:n_docs], scales[:n_docs]
    n, h = vals.shape
    per = -(-n // n_shards)
    per = -(-per // 2048) * 2048
    lo, hi = min(rank * per, n), min((rank + 1) * per, n)
    part_v = np.zeros((per, h), vals.dtype)
    part_s = np.zeros(per, np.float32)
    part_v[: hi - lo], part_s[: hi - lo] = vals[lo:hi], scales[lo:hi]
    values = torch.as_tensor(part_v, device=device)
    if vals.dtype != np.int8:
        values = values.to(torch.bfloat16)
    return ShardedDenseLeg(values=values, scales=torch.as_tensor(part_s, device=device), normalized=normalized,
                           n_docs=n, docs_per_shard=per)


def _local_dense_search(
    qf: torch.Tensor,  # f32 [Q, H]
    values: torch.Tensor,  # [per, H]
    scales: torch.Tensor,  # [per]
    lo: int,  # this shard's first global doc id
    normalized: bool,
    n_docs: int,
    k: int,
    doc_block: int,
    local_topk: str | None,
) -> RankedLists:
    """One shard's exact blockwise search (bf16 queries, f32 products × the
    row scale); ids LOCAL, pad rows masked."""
    per = values.shape[0]
    k = min(k, per)
    doc_block = min(doc_block, per)
    if normalized:
        qf = l2_normalize(qf)
    qb = qf.to(torch.bfloat16)
    offsets = torch.arange(doc_block, device=values.device)

    def block_scores(bi: int):
        start = bi * doc_block
        real_start = min(start, per - doc_block)
        blk = slice(real_start, real_start + doc_block)
        scores = matmul_f32(qb, values[blk].to(torch.bfloat16).T) * scales[blk][None, :]
        rows = real_start + offsets
        fresh = (rows >= start) & (lo + rows < n_docs)  # mask the overlap and the pad rows
        return torch.where(fresh[None, :], scores, -torch.inf), real_start

    return blockwise_topk_offset(block_scores, -(-per // doc_block), qf.shape[0], k, local_topk=local_topk)


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` without an index is the current card."""

    def index(d):
        return d.index if d.index is not None else (torch.cuda.current_device() if d.type == "cuda" else 0)

    return a.type == b.type and index(a) == index(b)


@dataclass
class ShardedHybridSearcher(HybridSearcher):
    """Serve the full hybrid pipeline with every index sharded over the mesh
    ``index`` axis, one rank per device.  Build with :meth:`from_searcher` on
    every rank; query with the inherited :meth:`search` / ``search_systems``
    (the same host surface as ``HybridSearcher``), the same batches on every
    rank."""

    mesh: Mesh | None = None
    bm25_shards: ShardedImpactIndex | None = None
    dense_leg: ShardedDenseLeg | None = None
    splade_leg: ShardedDenseLeg | None = None
    splade_shards: ShardedImpactIndex | None = None
    splade_scatter_shards: ShardedChunkedImpactIndex | None = None
    # this rank's rows of the SPLADE exact-rescore store (int16 [per, 2K]),
    # partitioned as the stage-1 SPLADE shards: with splade_rescore_depth > 0
    # each shard rescores its own candidates before the merge
    splade_rescore_shards: torch.Tensor | None = None
    splade_rescore_meta: tuple | None = None  # (vocab_size, prune_topk)
    plaid_shards: ShardedPlaidIndex | None = None
    ce_tok_shards: torch.Tensor | None = None  # this rank's [per, Ld] raw doc tokens
    ce_msk_shards: torch.Tensor | None = None  # [per, Ld]
    dense_doc_block: int = 65536
    dense_local_topk: str | None = None  # 'approx' is served by the exact select
    # 'block' = exact blockwise matmul + merge; 'fused' = K2's binned top-k
    # per shard (recall loss ≈ k²·8/docs per shard: corpus scale only)
    dense_impl: str = "block"
    plaid_cand_chunk: int = 512

    # ------------------------------------------------------------------
    @classmethod
    def from_searcher(
        cls,
        searcher: HybridSearcher,
        mesh: Mesh,
        impact_cap: int | None = None,
        ivf_cap: int | None = None,
        dense_local_topk: str | None = None,
        place: bool = True,
    ) -> "ShardedHybridSearcher":
        """Shard a built ``HybridSearcher``'s indexes over ``mesh``'s
        ``index`` axis and keep this rank's shard (host-side repacking:
        offline index work, run on every rank over the same searcher).

        BM25 → the impact-ordered inverted index (built from the postings
        if the searcher holds the dense form); DPR / SPLADE → int8 or bf16
        matrix shards, or SPLADE's impact / chunked index (with its rescore
        store); ColBERT → the compressed index + a per-shard IVF (PLAID).
        The cascade and packed rerank stages carry over; ``rerank_buckets``
        does not (the flat stage serves instead).  ``place`` (JAX's device
        placement of the stacked arrays) is checked and dropped: a rank's
        shard is already on its device."""
        if not isinstance(place, bool):
            raise ValueError(f"place must be a bool, got {place!r}")
        if not _same_device(mesh.device, searcher.device):
            raise ValueError(f"the searcher lives on {searcher.device}, the mesh's rank on {mesh.device}")
        n_shards, rank = mesh.shape[INDEX_AXIS], mesh.coords[INDEX_AXIS]
        out = cls(
            corpus_ids=searcher.corpus_ids,
            mesh=mesh,
            bm25=searcher.bm25,
            dense_model=searcher.dense_model,
            splade_model=searcher.splade_model,
            colbert_model=searcher.colbert_model,
            cross_encoder=searcher.cross_encoder,
            rerank_depth=searcher.rerank_depth,
            ce_query_length=searcher.ce_query_length,
            rerank_chunk=searcher.rerank_chunk,
            rerank_cascade=searcher.rerank_cascade,
            rerank_packed=searcher.rerank_packed,
            rerank_row_width=searcher.rerank_row_width,
            ce_doc_lens=searcher.ce_doc_lens,
            fusion_method=searcher.fusion_method,
            normalization=searcher.normalization,
            percentile_distributions=searcher.percentile_distributions,
            linear_weights=searcher.linear_weights,
            topk=searcher.topk,
            bm25_preprocess=searcher.bm25_preprocess,
            splade_query_terms=searcher.splade_query_terms,
            plaid_nprobe=searcher.plaid_nprobe,
            plaid_ncand=searcher.plaid_ncand,
            plaid_ncand_rescore=searcher.plaid_ncand_rescore,
            plaid_rescore_impl=searcher.plaid_rescore_impl,
            dense_local_topk=dense_local_topk,
            device=searcher.device,
        )
        if searcher.bm25 is not None:
            impact = searcher.bm25_impact_index
            if impact is None:
                impact = searcher.bm25.to_impact_index(cap=impact_cap or 4096)
            out.bm25_shards = shard_impact_index(impact, n_shards, rank=rank)
        if searcher.dense_corpus is not None:
            out.dense_leg = _shard_dense_matrix(searcher.dense_corpus, searcher.dense_model.similarity, n_shards,
                                                rank=rank, n_docs=searcher.dense_n_docs)
        if searcher.splade_scatter_index is not None:
            out.splade_scatter_shards = shard_chunked_impact_index(searcher.splade_scatter_index, n_shards, rank=rank)
        elif searcher.splade_impact_index is not None:
            out.splade_shards = shard_impact_index(searcher.splade_impact_index, n_shards, rank=rank)
        elif searcher.splade_corpus is not None:
            out.splade_leg = _shard_dense_matrix(searcher.splade_corpus, searcher.splade_model.similarity,
                                                 n_shards, rank=rank)
        stage1 = out.splade_scatter_shards or out.splade_shards
        if searcher.splade_rescore_store is not None and searcher.splade_rescore_depth > 0 and stage1 is not None:
            store = searcher.splade_rescore_store
            per = stage1.docs_per_shard
            rows = store.packed[rank * per : (rank + 1) * per]
            if rows.shape[0] < per:
                rows = torch.cat([rows, rows.new_zeros((per - rows.shape[0], rows.shape[1]))])
            out.splade_rescore_shards = rows.contiguous()
            out.splade_rescore_meta = (store.vocab_size, store.prune_topk)
            out.splade_rescore_depth = searcher.splade_rescore_depth
        if searcher.colbert_index is not None:
            if not isinstance(searcher.colbert_index, CompressedTokenIndex):
                raise ValueError(
                    "sharded serving uses the compressed ColBERT index (PLAID); for the uncompressed form "
                    "use ops.mips.sharded_maxsim_search_tm"
                )
            cap = ivf_cap or (searcher.colbert_ivf.cap if searcher.colbert_ivf is not None else 4096)
            out.plaid_shards = shard_plaid_index(searcher.colbert_index, n_shards, ivf_cap=cap, rank=rank)
        if searcher.ce_doc_tokens is not None and searcher.cross_encoder is not None:
            n = searcher.ce_doc_tokens.shape[0]
            per = -(-n // n_shards)

            def rows_of(t):
                part = t[rank * per : (rank + 1) * per]
                if part.shape[0] < per:
                    part = torch.cat([part, part.new_zeros((per - part.shape[0], t.shape[1]))])
                return part.contiguous()

            out.ce_tok_shards = rows_of(searcher.ce_doc_tokens)
            out.ce_msk_shards = rows_of(searcher.ce_doc_mask)
        return out

    # ------------------------------------------------------------------
    @property
    def _dense_active(self) -> bool:
        return self.dense_leg is not None

    @property
    def _splade_active(self) -> bool:
        return self.splade_model is not None and (
            self.splade_leg is not None or self.splade_shards is not None or self.splade_scatter_shards is not None
        )

    @property
    def _colbert_active(self) -> bool:
        return self.plaid_shards is not None

    @property
    def _cap_guard_index(self):
        return self.bm25_shards

    @property
    def _rerank_active(self) -> bool:
        return self.cross_encoder is not None and self.rerank_depth > 0 and self.ce_tok_shards is not None

    @property
    def _rank(self) -> int:
        return self.mesh.coords[INDEX_AXIS]

    @property
    def _n_shards(self) -> int:
        return self.mesh.shape[INDEX_AXIS]

    # -- the legs (HybridSearcher._search_batch calls them): this rank's
    # shard searched, its list merged over the mesh (global internal ids,
    # the same on every rank) --------------------------------------------
    def _merge(self, local: RankedLists, per: int) -> RankedLists:
        """Local shard ids → global ids (-1 kept), then the all-gather top-k
        merge: every leg's last step."""
        return _merge_shards(globalize(local, self._rank, per), local.scores, self.topk, self.mesh)

    def _impact_leg(self, shards: ShardedImpactIndex, terms, weights, k: int | None = None) -> RankedLists:
        per = shards.docs_per_shard
        return impact_search(terms, weights, shards.local(), k=min(self.topk, per) if k is None else k)

    def _dense_style_leg(self, leg: ShardedDenseLeg, q_embs: torch.Tensor) -> RankedLists:
        per = leg.docs_per_shard
        kl = min(self.topk, per)
        lo = self._rank * per
        if self.dense_impl == "fused":
            local = fused_dense_topk(q_embs.to(torch.float32), (leg.values, leg.scales, leg.normalized), k=kl)
            # build-pad rows on the last shard carry scale 0 and score below
            # every real doc: they surface only when the shard has fewer real
            # docs than k; give any survivor the pad convention
            bad = lo + local.ids >= leg.n_docs
            local = RankedLists(ids=torch.where(bad, -1, local.ids), scores=torch.where(bad, -torch.inf, local.scores))
        else:
            local = _local_dense_search(
                q_embs.to(torch.float32), leg.values, leg.scales, lo, leg.normalized, leg.n_docs, kl,
                self.dense_doc_block, self.dense_local_topk,
            )
        return self._merge(local, per)

    def _splade_rescore_local(self, q_full: torch.Tensor, local: RankedLists, per: int) -> RankedLists:
        """Per-shard exact rescore of the stage-1 candidates against the
        shard's stored doc vectors (local ids)."""
        vocab, kk = self.splade_rescore_meta
        store = SpladeRescoreStore(packed=self.splade_rescore_shards, n_docs=per, vocab_size=vocab, prune_topk=kk)
        return sparse_rescore(q_full, local.ids, store, k=min(self.topk, local.ids.shape[1]))

    def _bm25_leg(self, inputs: dict) -> RankedLists:
        local = self._impact_leg(self.bm25_shards, inputs["bm25_terms"], inputs["bm25_weights"].to(torch.float32))
        return self._merge(local, self.bm25_shards.docs_per_shard)

    def _dpr_leg(self, inputs: dict) -> RankedLists:
        return self._dense_style_leg(self.dense_leg, self.dense_model.embed_tokens(inputs["q_ids"], inputs["q_mask"]))

    def _splade_leg(self, inputs: dict) -> RankedLists:
        q = self.splade_model.embed_tokens(inputs["sp_ids"], inputs["sp_mask"])
        if self.splade_leg is not None:
            return self._dense_style_leg(self.splade_leg, q)
        qf = q.to(torch.float32)
        if self.splade_model.similarity == "cos_sim":
            qf = l2_normalize(qf)
        terms, weights = activations_to_query_terms(qf, self.splade_query_terms)
        rescore = self.splade_rescore_shards is not None and self.splade_rescore_depth > 0
        if self.splade_scatter_shards is not None:
            sc = self.splade_scatter_shards
            per = sc.docs_per_shard
            kl = min(self.splade_rescore_depth, per) if rescore else min(self.topk, per)
            local = local_scatter_search(terms, weights, sc.post_doc, sc.post_impact, sc.docs_per_chunk, per, kl)
        else:
            per = self.splade_shards.docs_per_shard
            kl = None
            if rescore:
                # clamp to the flattened posting width (the top-k ceiling)
                width = terms.shape[1] * self.splade_shards.post_doc.shape[-1]
                kl = min(self.splade_rescore_depth, per, width)
            local = self._impact_leg(self.splade_shards, terms, weights, kl)
        if rescore:
            local = self._splade_rescore_local(qf, local, per)
        return self._merge(local, per)

    def _colbert_leg(self, inputs: dict) -> RankedLists:
        ps = self.plaid_shards
        per = ps.docs_per_shard
        ncand = min(self.plaid_ncand, per)
        chunk = min(self.plaid_cand_chunk, ncand)
        ncand -= ncand % chunk
        kl = min(self.topk, ncand)
        nr = self.plaid_ncand_rescore
        if nr and nr < ncand:
            nr = max(nr - nr % chunk, chunk)
            kl = min(kl, nr)
        else:
            nr = 0
        q_tok = self.colbert_model.embed_tokens(inputs["cb_ids"], inputs["cb_mask"])
        local = _plaid_shard_search(q_tok, inputs["cb_mask"], ps, self.plaid_nprobe, ncand, chunk, nr,
                                    self.plaid_rescore_impl, kl)
        return self._merge(local, per)

    # ------------------------------------------------------------------
    def _owned_tokens(self, ids: torch.Tensor, with_mask: bool = True):
        """Doc tokens (and mask) of global doc ``ids`` (any shape; -1 pads)
        on every rank, int64: each rank gathers the rows it owns (zeros
        elsewhere) and an int32 sum all-reduce puts them together (each real
        id has one owner)."""
        per = self.ce_tok_shards.shape[0]
        local = ids.long() - self._rank * per
        own = ((local >= 0) & (local < per))[..., None]
        safe = local.clamp(0, per - 1)

        def owned(rows):
            return all_reduce_sum(torch.where(own, rows, 0).to(torch.int32), self.mesh).long()

        tok = owned(self.cross_encoder._token_ids(self.ce_tok_shards[safe]))
        return (tok, owned(self.ce_msk_shards[safe].long())) if with_mask else tok

    def _flat_rerank_stage(self, inputs: dict, head_ids: torch.Tensor) -> torch.Tensor:
        """The flat (or cascade) stage over the mesh: the head's tokens
        reconstructed on every rank, the forward split by query rows (rank r
        scores rows [r·⌈Q/S⌉, (r+1)·⌈Q/S⌉)), the logits all-gathered."""
        ce = self.cross_encoder
        d_ids, d_msk = self._owned_tokens(head_ids)
        d_msk = d_msk * (head_ids >= 0)[..., None]
        q, s = head_ids.shape[0], self._n_shards
        rows = -(-q // s)
        pad = torch.nn.functional.pad

        def mine(x):
            x = pad(x, (0, 0) * (x.ndim - 1) + (0, rows * s - q))
            return x[self._rank * rows : (self._rank + 1) * rows]

        args = (mine(inputs["ce_ids"]), mine(inputs["ce_mask"]), mine(d_ids), mine(d_msk))
        if self.rerank_cascade is not None:
            keep, stage1 = self.rerank_cascade
            logits = ce.rerank_tokens_cascade(*args, keep=int(keep), stage1_tokens=int(stage1),
                                              pair_chunk=self.rerank_chunk)
        else:
            logits = ce.rerank_tokens(*args, pair_chunk=self.rerank_chunk)
        return all_gather(logits, self.mesh).reshape(rows * s, -1)[:q]

    def _packed_rerank_stage(self, inputs: dict, head_ids: torch.Tensor) -> torch.Tensor:
        """The packed stage over the mesh: the same host plan as one
        device's, its chunk count a multiple of S; the candidates' tokens
        reconstructed by a sum all-reduce, the rows assembled on every rank,
        rank r scoring chunks [r·nchunks/S, (r+1)·nchunks/S) (those past the
        last packed row skipped, as on one device), and the slot scatter
        summed across the ranks."""
        ce = self.cross_encoder
        heads = head_ids.cpu().numpy()
        qn, kr = heads.shape
        s = self._n_shards
        desc, tables, width, nchunks, rpc, _ = ce.plan_packed(
            heads, self.ce_doc_lens, inputs["ce_qlens"], int(inputs["ce_ids"].shape[1]),
            int(self.ce_tok_shards.shape[1]), len(self.ce_doc_lens), row_width=self.rerank_row_width,
            chunk_multiple=s,
        )
        n_rows = int(desc[2].max()) + 1 if desc.shape[1] else 0
        dev = self.ce_tok_shards.device
        desc_t = torch.as_tensor(desc, device=dev)
        tables_t = torch.as_tensor(tables, device=dev).long()
        drows = self._owned_tokens(desc_t[1], with_mask=False)  # the plan's lengths stand in for the mask
        ids, mask, seg, pos = ce.assemble_packed_rows(desc_t, inputs["ce_ids"], drows, nchunks * rpc, width,
                                                      ce._packed_consts)
        buf = torch.zeros(qn * kr + 1, dtype=torch.float32, device=dev)
        units = nchunks // s
        for c in range(self._rank * units, (self._rank + 1) * units):
            if c * rpc >= n_rows:
                break
            rows = slice(c * rpc, min((c + 1) * rpc, n_rows))
            tb = tables_t[c]
            buf[tb[:, 2]] = ce.packed_score_tokens(ids[rows], mask[rows], pos[rows], seg[rows], tb[:, 0], tb[:, 1])
        # every real slot is written on one rank (zeros elsewhere); the
        # fillers' spill slot Q·Kr is dropped
        buf = all_reduce_sum(buf, self.mesh)
        return buf[: qn * kr].reshape(qn, kr)
