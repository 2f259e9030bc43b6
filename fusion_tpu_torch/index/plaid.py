"""PLAID-style search over the residual-compressed ColBERT index.

  stage 0  centroid interaction: one [Q·Lq, D] × [D, C] product per chunk of
           query tokens scores every centroid against every query token;
  stage 1  probing: each query token keeps its top-``nprobe`` centroids (an
           exact select, the lower centroid id first on ties); their IVF rows
           flatten to (doc, query token, probe score) entries, one stable
           sort by a combined int32 (doc, token) key groups them, a suffix
           max takes each (doc, token)'s best probe, a segmented sum adds
           the tokens per doc, and the best ``ncand`` docs per query are the
           candidates;
  (prune)  optionally, MaxSim against each candidate token's centroid only
           cuts the candidates to ``ncand_rescore``;
  stage 2  exact rescore: gather the candidates' compressed rows (the gather
           kernel, ``ops/gather_rows.py``), decompress, MaxSim per query over
           its own candidates, chunked over candidates.

Work scales with Q·(Lq·nprobe·ivf_cap + ncand·Ld), not with the corpus.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch

from fusion_tpu_torch.core.device import resolve_device
from fusion_tpu_torch.core.ranked import RankedLists, stable_topk
from fusion_tpu_torch.index.compression import CompressedTokenIndex, _rows, _unpack_codes
from fusion_tpu_torch.ops.gather_rows import gather_rows
from fusion_tpu_torch.ops.mips import bmm_f32, matmul_f32
from fusion_tpu_torch.ops.segscan import segmented_run_totals
from fusion_tpu_torch.ops.topk import blockwise_topk
from fusion_tpu_torch.parallel.sharding import INDEX_AXIS, default_index_rank, globalize, merge_shards
from fusion_tpu_torch.utils.profiling import span


class IVFIndex(NamedTuple):
    """Centroid → documents inverted lists (doc ids deduped per centroid)."""

    ivf_doc: torch.Tensor  # int32 [C, cap], pad = n_docs (sentinel)
    n_docs: int
    cap: int

    def nbytes(self) -> int:
        return self.ivf_doc.nbytes

    def to(self, device) -> "IVFIndex":
        return self._replace(ivf_doc=self.ivf_doc.to(device))

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        np.savez_compressed(
            os.path.join(path, "ivf_index.npz"),
            ivf_doc=self.ivf_doc.cpu().numpy(),
            meta=np.array([self.n_docs, self.cap], np.int64),
        )

    @classmethod
    def load(cls, path: str, device="cuda") -> "IVFIndex":
        device = torch.device(device)
        with np.load(os.path.join(path, "ivf_index.npz")) as z:
            n, cap = (int(x) for x in z["meta"])
            return cls(ivf_doc=torch.as_tensor(z["ivf_doc"], device=device), n_docs=n, cap=cap)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def build_ivf(
    centroid_ids,  # int32 [N, Ld] (tensor or numpy)
    mask,  # [N, Ld] (>0 = real token)
    num_centroids: int,
    cap: int = 4096,
    device=None,
) -> IVFIndex:
    """Host-side IVF build: for each centroid, the deduped ids of the docs
    whose real tokens assign to it, the first ``cap`` of them in doc order.
    The lists land on ``device``; by default where a tensor ``centroid_ids``
    lives, and on the card for numpy input (which raises without one)."""
    if device is None:
        device = centroid_ids.device if isinstance(centroid_ids, torch.Tensor) else "cuda"
    device = resolve_device(device)
    cid = _host(centroid_ids).astype(np.int64)
    n, ld = cid.shape
    doc = np.repeat(np.arange(n, dtype=np.int64), ld)
    valid = _host(mask).ravel() > 0
    pairs = np.unique(cid.ravel()[valid] * n + doc[valid])  # dedup (cid, doc)
    pc, pd = pairs // n, pairs % n
    counts = np.bincount(pc, minlength=num_centroids)
    starts = np.zeros(num_centroids + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    rank = np.arange(pc.size, dtype=np.int64) - starts[pc]
    keep = rank < cap
    ivf = np.full((num_centroids, cap), n, dtype=np.int32)
    ivf[pc[keep], rank[keep]] = pd[keep]
    return IVFIndex(ivf_doc=torch.as_tensor(ivf, device=device), n_docs=n, cap=cap)


def dedup_ivf_rows(ivf_doc: torch.Tensor, n_docs: int) -> torch.Tensor:
    """Replace duplicate doc ids within each centroid list by the sentinel
    ``n_docs`` (the lists come back sorted).  ``plaid_candidates``' suffix max
    over runs of ≤ nprobe entries holds only for duplicate-free lists:
    ``build_ivf`` makes them so; run this over lists from anywhere else."""
    s = torch.sort(ivf_doc, dim=-1).values
    dup = torch.cat([torch.zeros_like(s[..., :1], dtype=torch.bool), s[..., 1:] == s[..., :-1]], dim=-1)
    return torch.where(dup, n_docs, s).to(torch.int32)


def _probe(q_flat: torch.Tensor, cents_b: torch.Tensor, nprobe: int, chunk: int):
    """Each query token's top-``nprobe`` centroids, chunked over query tokens
    (the [chunk, C] score block is the only transient): nprobe passes of a
    first-index argmax, so equal scores keep the lower centroid id as
    ``lax.top_k`` does.  → (scores f32 [QL, nprobe], ids int64 [QL, nprobe])."""
    ql = q_flat.shape[0]
    scores = torch.empty((ql, nprobe), dtype=torch.float32, device=q_flat.device)
    ids = torch.empty((ql, nprobe), dtype=torch.int64, device=q_flat.device)
    for s in range(0, ql, chunk):
        with span("plaid.probe_matmul"):
            cs = matmul_f32(q_flat[s : s + chunk], cents_b.T)  # [chunk, C]
        with span("plaid.probe_select"):
            for j in range(nprobe):
                best = torch.argmax(cs, dim=1, keepdim=True)
                scores[s : s + chunk, j] = torch.gather(cs, 1, best)[:, 0]
                ids[s : s + chunk, j] = best[:, 0]
                cs.scatter_(1, best, -torch.inf)
    return scores, ids


def plaid_candidates(
    q_tok: torch.Tensor,  # [Q, Lq, D]
    q_mask: torch.Tensor,  # [Q, Lq]
    centroids: torch.Tensor,  # [C, D]
    ivf_doc: torch.Tensor,  # int32 [C, cap]
    n_docs: int,
    nprobe: int = 4,
    ncand: int = 4096,
    probe_chunk: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stages 0 and 1 → (candidate doc ids int32 [Q, ncand], their scores).

    Unscored slots hold the sentinel ``n_docs`` with score -inf.  Every
    select here is exact (the JAX package's ``topk_impl="exact"``).
    ``ivf_doc`` rows must be duplicate-free (see ``dedup_ivf_rows``)."""
    q, lq, d = q_tok.shape
    ql = q * lq
    dev = q_tok.device
    probe_scores, probe_cids = _probe(
        q_tok.reshape(ql, d).to(torch.bfloat16), centroids.to(torch.bfloat16), nprobe,
        min(probe_chunk, ql),
    )
    q_m = q_mask.reshape(ql).to(torch.float32)
    probe_scores = probe_scores * q_m[:, None]
    # padded query tokens contribute no candidates: a zeroed score would
    # still beat real candidates with negative probe sums
    cap = ivf_doc.shape[1]
    width = lq * nprobe * cap
    docs = torch.where((q_m > 0)[:, None, None], _rows(ivf_doc, probe_cids), n_docs).reshape(q, width)
    vals = probe_scores[:, :, None].expand(ql, nprobe, cap).reshape(q, width).to(torch.float16)
    tok_of = (torch.arange(ql, device=dev, dtype=torch.int32) % lq)[:, None, None]
    tok_of = tok_of.expand(ql, nprobe, cap).reshape(q, width)
    # ONE int32 (doc, token) key, doc-major, with an f16 payload carried by
    # the sort's permutation; the per-(doc, token) max is a suffix max over
    # its ≤ nprobe-long run, so the order within a run does not matter
    l2 = 1 << max(lq - 1, 0).bit_length()  # power-of-two token multiplier
    if n_docs * l2 >= 2**31:
        raise ValueError(f"combined (doc, token) key overflows int32: {n_docs} docs × {l2}")
    combined = torch.where(docs < n_docs, docs * l2 + tok_of, n_docs * l2)
    with span("plaid.candidate_sort"):
        combined_s, perm = torch.sort(combined, dim=1, stable=True)
        v = torch.gather(vals, 1, perm).to(torch.float32)
    docs_s = combined_s >> (l2.bit_length() - 1)
    s = 1
    while s < nprobe:
        same = combined_s == torch.cat([combined_s[:, s:], combined_s.new_full((q, s), -1)], dim=1)
        shifted = torch.cat([v[:, s:], v.new_full((q, s), -torch.inf)], dim=1)
        v = torch.where(same, torch.maximum(v, shifted), v)
        s <<= 1
    new_dt = torch.cat(
        [torch.ones((q, 1), dtype=torch.bool, device=dev), combined_s[:, 1:] != combined_s[:, :-1]],
        dim=1,
    )
    per_tok = torch.where(new_dt, v, 0.0)
    # segmented sum by DOC of the per-token maxima (runs ≤ Lq·nprobe)
    seg, is_end = segmented_run_totals(docs_s, per_tok, lq * nprobe)
    cand_scores = torch.where(is_end & (docs_s < n_docs), seg, -torch.inf)
    top_scores, pos = stable_topk(cand_scores, ncand)
    cand = torch.where(torch.isfinite(top_scores), torch.gather(docs_s, 1, pos), n_docs)
    return cand.to(torch.int32), top_scores


def _centroid_score_table(q_tok: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """bf16 [Q·C, Lq] table of every (query token · centroid) score,
    token-minor, so each candidate token's [Lq] column is one row to gather
    (the prune tier and the factored rescore read it)."""
    q, lq, d = q_tok.shape
    c = centroids.shape[0]
    q_flat = q_tok.reshape(q * lq, d).to(torch.bfloat16)
    table = matmul_f32(centroids.to(torch.bfloat16), q_flat.T).view(c, q, lq)
    return table.transpose(0, 1).to(torch.bfloat16, memory_format=torch.contiguous_format).view(q * c, lq)


def _gather_cand_rows(srcs, safe: torch.Tensor):
    """Candidate rows of every source, through ``gather_rows`` (the gather
    kernel on the card, the plain gather on the CPU)."""
    with span("plaid.gather"):
        return gather_rows(srcs, safe)


def _cand_chunk(cand: torch.Tensor, start: int, size: int, n: int):
    """(candidate slice [Q, size], its ids clamped to a real row, contiguous
    int32 for the gather): sentinels are clamped and masked by score."""
    sl = cand[:, start : start + size]
    return sl, sl.clamp(max=n - 1).to(torch.int32).contiguous()


def _plaid_centroid_prune(
    q_tok: torch.Tensor,  # [Q, Lq, D]
    q_mask: torch.Tensor,  # [Q, Lq]
    centroids: torch.Tensor,  # [C, D]
    centroid_ids: torch.Tensor,  # int32 [N, Ld]
    mask: torch.Tensor,  # [N, Ld]
    cand: torch.Tensor,  # int32 [Q, ncand] (pad = n_docs)
    ncand2: int,
    cand_chunk: int = 1024,
    cs: torch.Tensor | None = None,  # precomputed _centroid_score_table
) -> torch.Tensor:
    """Prune tier: MaxSim against each candidate token's CENTROID only (no
    codes gather, no decompression), with the same zeroed-mask semantics.
    Returns the best ``ncand2`` candidate ids per query (pad = n_docs)."""
    q, lq, _ = q_tok.shape
    n, ld = centroid_ids.shape
    c = centroids.shape[0]
    if cs is None:
        cs = _centroid_score_table(q_tok, centroids)
    ncand = cand.shape[1]
    # the chunk divides ncand, so no candidate is scored twice
    cc = math.gcd(min(cand_chunk, ncand), ncand)
    q_off = (torch.arange(q, device=cand.device) * c)[:, None, None]
    q_m = q_mask.to(torch.float32)

    def block_scores(bi: int):
        sl, safe = _cand_chunk(cand, bi * cc, cc, n)
        cid, msk = _gather_cand_rows((centroid_ids, mask), safe)
        csg = _rows(cs, cid + q_off) * msk.to(torch.bfloat16)[..., None]  # [Q, cc, Ld, Lq]
        best = csg.amax(dim=2).to(torch.float32)
        scores = (best * q_m[:, None, :]).sum(dim=-1)
        return torch.where(sl < n, scores, -torch.inf), sl

    out = blockwise_topk(block_scores, ncand // cc, q, min(ncand2, ncand))
    return torch.where(out.ids >= 0, out.ids, n).to(torch.int32)


def _ranked_or_pad(out: RankedLists) -> RankedLists:
    """Candidate pads carry -inf: their ids become PAD_ID, so fusion and
    remapping never see a sentinel as a document."""
    return RankedLists(
        ids=torch.where(torch.isfinite(out.scores), out.ids, -1).to(torch.int32), scores=out.scores
    )


def _plaid_rescore(
    q_tok: torch.Tensor,
    q_mask: torch.Tensor,
    index: CompressedTokenIndex,
    cand: torch.Tensor,
    k: int,
    cand_chunk: int,
) -> RankedLists:
    """Exact rescore, gather form: per chunk of candidates, gather their
    (centroid ids, codes, mask) rows, decompress to bf16, and take the
    masked MaxSim with bf16 queries (f32 products) per query."""
    q, ncand = cand.shape
    n, ld = index.centroid_ids.shape
    q_t = q_tok.to(torch.bfloat16).transpose(1, 2).contiguous()  # [Q, D, Lq]
    q_m = q_mask.to(torch.float32)

    def block_scores(bi: int):
        sl, safe = _cand_chunk(cand, bi * cand_chunk, cand_chunk, n)
        cid, cod, msk = _gather_cand_rows((index.centroid_ids, index.codes, index.mask), safe)
        d_tok = index.decompress(cid, cod) * msk.to(torch.bfloat16)[..., None]  # [Q, cc, Ld, D]
        cc = sl.shape[1]
        sim = bmm_f32(d_tok.reshape(q, cc * ld, -1), q_t).view(q, cc, ld, -1)
        best = sim.amax(dim=2)  # [Q, cc, Lq] (zeroed-mask semantics)
        scores = (best * q_m[:, None, :]).sum(dim=-1)
        return torch.where(sl < n, scores, -torch.inf), sl

    return _ranked_or_pad(blockwise_topk(block_scores, -(-ncand // cand_chunk), q, k))


def _plaid_rescore_factored(
    q_tok: torch.Tensor,
    q_mask: torch.Tensor,
    cs: torch.Tensor,
    index: CompressedTokenIndex,
    cand: torch.Tensor,
    k: int,
    cand_chunk: int,
) -> RankedLists:
    """Exact rescore with the centroid term factored out:
    sim(q_i, d_j) = table[cid_j][i] + q_i·r_j.  The centroid part is a row
    of the [Q·C, Lq] score table; only the residual is reconstructed.  Scores
    differ from the gather form only in bf16 rounding order."""
    q, ncand = cand.shape
    n, ld = index.centroid_ids.shape
    c = cs.shape[0] // q
    q_t = q_tok.to(torch.bfloat16).transpose(1, 2).contiguous()  # [Q, D, Lq]
    q_m = q_mask.to(torch.float32)
    bw = index.bucket_weights.to(torch.bfloat16)
    q_off = (torch.arange(q, device=cand.device) * c)[:, None, None]

    def block_scores(bi: int):
        sl, safe = _cand_chunk(cand, bi * cand_chunk, cand_chunk, n)
        cid, packed, msk = _gather_cand_rows((index.centroid_ids, index.codes, index.mask), safe)
        cc = sl.shape[1]
        csg = _rows(cs, cid + q_off)  # [Q, cc, Ld, Lq] bf16
        residual = _rows(bw, _unpack_codes(packed, index.nbits, index.dim))  # [Q, cc, Ld, D]
        r_sim = bmm_f32(residual.reshape(q, cc * ld, -1), q_t).view(q, cc, ld, -1)
        sim = (csg.to(torch.float32) + r_sim) * msk.to(torch.float32)[..., None]
        scores = (sim.amax(dim=2) * q_m[:, None, :]).sum(dim=-1)
        return torch.where(sl < n, scores, -torch.inf), sl

    return _ranked_or_pad(blockwise_topk(block_scores, -(-ncand // cand_chunk), q, k))


def plaid_search(
    q_tok: torch.Tensor,  # [Q, Lq, D]
    q_mask: torch.Tensor,  # [Q, Lq]
    index: CompressedTokenIndex,
    ivf: IVFIndex,
    k: int = 1000,
    nprobe: int = 4,
    ncand: int = 4096,
    cand_chunk: int = 512,
    ncand_rescore: int | None = 1024,
    rescore_impl: str = "gather",
) -> RankedLists:
    """Candidate generation → optional centroid-only pruning → exact
    decompressed rescore (colbert-ai PLAID's stage structure).

    ``ncand_rescore`` caps how many candidates reach the exact tier (None or
    ≥ ncand disables the prune tier).  ``rescore_impl``: 'gather' reads a
    centroid row per candidate token; 'factored' reuses the centroid-score
    table.  Each stage runs in a ``plaid.*`` span (candidates, probe_matmul,
    probe_select, candidate_sort, prune, rescore, gather): under
    ``utils.profiling.tracing()`` a ``torch.profiler`` range
    ``fusion.plaid.<stage>``, so a trace attributes the device time to it."""
    if rescore_impl not in ("gather", "factored"):
        raise ValueError(f"rescore_impl must be 'gather' or 'factored', got {rescore_impl!r}")
    # keep ncand a multiple of cand_chunk so the rescore chunks tile it
    ncand = min(ncand, max(ivf.n_docs, 1))
    cand_chunk = min(cand_chunk, ncand)
    ncand -= ncand % cand_chunk
    with span("plaid.candidates"):
        cand, _ = plaid_candidates(
            q_tok, q_mask, index.centroids, ivf.ivf_doc, ivf.n_docs, nprobe=nprobe, ncand=ncand,
        )
    q_m = q_mask.to(torch.float32)
    prune = bool(ncand_rescore and ncand_rescore < ncand)
    cs = None
    if prune or rescore_impl == "factored":
        cs = _centroid_score_table(q_tok, index.centroids)
    if prune:
        nr = max(ncand_rescore - ncand_rescore % cand_chunk, cand_chunk)
        with span("plaid.prune"):
            cand = _plaid_centroid_prune(
                q_tok, q_m, index.centroids, index.centroid_ids, index.mask, cand, ncand2=nr, cs=cs,
            )
        ncand = nr
    with span("plaid.rescore"):
        if rescore_impl == "factored":
            return _plaid_rescore_factored(
                q_tok, q_m, cs, index, cand, k=min(k, ncand), cand_chunk=cand_chunk
            )
        return _plaid_rescore(q_tok, q_m, index, cand, k=min(k, ncand), cand_chunk=cand_chunk)


# ----------------------------------------------------------------------
# sharded over a mesh (parallel/sharding.py)
# ----------------------------------------------------------------------
GATHER_IMPLS = ("auto", "xla", "pallas", "pallas_interpret")


class ShardedPlaidIndex(NamedTuple):
    """One rank's doc-range shard of (compressed index + IVF).  The
    centroid table and bucket weights are replicated; the rows and the IVF
    (over LOCAL doc ids, pad ``docs_per_shard``) are the shard's.  The JAX
    package's segmented codes form ``codes_seg`` has no counterpart (the
    gather kernel reads the u8 codes): it stays None."""

    centroids: torch.Tensor  # [C, D] (replicated)
    bucket_weights: torch.Tensor  # [2^nbits] (replicated)
    centroid_ids: torch.Tensor  # int32 [per, Ld]
    codes: torch.Tensor  # u8 [per, Ld, D·nbits/8]
    mask: torch.Tensor  # [per, Ld]
    ivf_doc: torch.Tensor  # int32 [C, cap] (local doc ids; pad = per)
    nbits: int
    n_docs: int
    docs_per_shard: int
    codes_seg: object = None

    def local(self) -> CompressedTokenIndex:
        """The shard's rows as a CompressedTokenIndex over its local docs."""
        return CompressedTokenIndex(
            centroids=self.centroids, centroid_ids=self.centroid_ids, codes=self.codes, mask=self.mask,
            bucket_weights=self.bucket_weights, nbits=self.nbits,
        )


def shard_plaid_index(
    index: CompressedTokenIndex, n_shards: int, ivf_cap: int = 4096, dma_codes: bool = True, *,
    rank: int | None = None,
) -> ShardedPlaidIndex:
    """Split a CompressedTokenIndex into doc-range shards, keep shard
    ``rank`` (default: this process's index coordinate) and build its IVF
    over its local doc ids, on the index's device (host-side, offline; the
    rows the JAX package's ``dma_codes=False`` stack holds).  ``dma_codes``
    (JAX's segmented codes form) is checked and dropped."""
    if not isinstance(dma_codes, bool):
        raise ValueError(f"dma_codes must be a bool, got {dma_codes!r}")
    rank = default_index_rank(n_shards) if rank is None else rank
    n = index.num_docs
    per = -(-n // n_shards)
    lo, hi = rank * per, min((rank + 1) * per, n)

    def rows(t: torch.Tensor) -> torch.Tensor:
        part = t[lo:hi]
        if part.shape[0] < per:  # the last shard pads with zero rows
            part = torch.cat([part, part.new_zeros((per - part.shape[0], *t.shape[1:]))])
        return part.contiguous()

    cid, mask = rows(index.centroid_ids), rows(index.mask)
    ivf = build_ivf(cid, mask, index.centroids.shape[0], cap=ivf_cap, device=cid.device)
    return ShardedPlaidIndex(
        centroids=index.centroids,
        bucket_weights=index.bucket_weights,
        centroid_ids=cid,
        codes=rows(index.codes),
        mask=mask,
        ivf_doc=ivf.ivf_doc,
        nbits=index.nbits,
        n_docs=n,
        docs_per_shard=per,
    )


def sharded_plaid_search(
    q_tok: torch.Tensor,
    q_mask: torch.Tensor,
    sharded: ShardedPlaidIndex,
    mesh,
    k: int = 1000,
    nprobe: int = 4,
    ncand: int = 4096,
    cand_chunk: int = 512,
    ncand_rescore: int | None = 1024,
    rescore_impl: str = "gather",
    gather_impl: str = "xla",
    topk_impl: str = "approx",
) -> RankedLists:
    """Index-parallel PLAID: each rank probes, prunes and rescores its
    doc-range shard (queries and centroid table replicated; the rescore's
    gathers through K4 on the card) and the per-shard top-k lists all-gather
    and merge.  ``gather_impl`` and ``topk_impl`` are checked and dropped:
    the device picks the gather, and every select is exact."""
    if gather_impl not in GATHER_IMPLS or topk_impl not in ("approx", "exact"):
        raise ValueError(f"gather_impl must be one of {GATHER_IMPLS} and topk_impl 'approx' or 'exact', "
                         f"got {gather_impl!r}, {topk_impl!r}")
    if rescore_impl not in ("gather", "factored"):
        raise ValueError(f"rescore_impl must be 'gather' or 'factored', got {rescore_impl!r}")
    per = sharded.docs_per_shard
    ncand_l = min(ncand, per)
    chunk = min(cand_chunk, ncand_l)
    ncand_l -= ncand_l % chunk
    nr = 0
    if ncand_rescore and ncand_rescore < ncand_l:
        nr = max(ncand_rescore - ncand_rescore % chunk, chunk)
    k = min(k, nr or ncand_l)
    local = _plaid_shard_search(q_tok, q_mask, sharded, nprobe, ncand_l, chunk, nr, rescore_impl, k)
    return merge_shards(globalize(local, mesh.coords[INDEX_AXIS], per), local.scores, k, mesh)


def _plaid_shard_search(q_tok, q_mask, sharded: ShardedPlaidIndex, nprobe: int, ncand: int, chunk: int,
                        nr: int, rescore_impl: str, k: int) -> RankedLists:
    """One shard's probe → (prune to ``nr`` when non-zero) → rescore, LOCAL
    ids; the sharded searcher's PLAID leg runs it too."""
    qt, qm = q_tok.to(torch.float32), q_mask.to(torch.float32)
    index = sharded.local()
    cand, _ = plaid_candidates(qt, qm, sharded.centroids, sharded.ivf_doc, sharded.docs_per_shard,
                               nprobe=nprobe, ncand=ncand)
    cs = None
    if nr or rescore_impl == "factored":
        cs = _centroid_score_table(qt, sharded.centroids)
    if nr:
        cand = _plaid_centroid_prune(qt, qm, sharded.centroids, sharded.centroid_ids, sharded.mask, cand,
                                     ncand2=nr, cs=cs)
    if rescore_impl == "factored":
        return _plaid_rescore_factored(qt, qm, cs, index, cand, k=k, cand_chunk=chunk)
    return _plaid_rescore(qt, qm, index, cand, k=k, cand_chunk=chunk)
