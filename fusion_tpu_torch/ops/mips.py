"""Exact maximum-inner-product / cosine search over a dense corpus matrix.

The corpus is scanned in blocks with a running top-k (``ops/topk.py``).  It
serves the DPR leg and the SPLADE sparse-as-dense leg.

The ``sharded_*`` functions are the index-parallel forms over a mesh
(``parallel/sharding.py``): each rank passes ITS shard of the corpus (the
JAX functions take the global array laid out over the mesh ``index`` axis),
searches it with the single-device search, turns local ids into global ones
(``local + rank·shard_n``) and all-gathers and merges the per-shard lists.
"""

from __future__ import annotations

import torch

from fusion_tpu_torch.core.ranked import RankedLists
from fusion_tpu_torch.models.heads import l2_normalize
from fusion_tpu_torch.ops.topk import blockwise_topk_offset
from fusion_tpu_torch.parallel.sharding import INDEX_AXIS, globalize, merge_shards


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M, K] × [K, N] → f32 [M, N] without rounding the result to the
    operands' dtype: a bf16 product accumulates in f32 and stays f32 (a
    plain bf16 ``torch.matmul`` would round scores to bf16 and make false
    ties).  On the card that is cuBLAS with an f32 output; on the CPU the
    operands are upcast, which gives the same exact bf16 products."""
    if a.is_cuda and a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``matmul_f32`` batched: [B, M, K] × [B, K, N] → f32 [B, M, N]."""
    if a.is_cuda and a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def dense_search(
    query_embs: torch.Tensor,
    corpus_embs: torch.Tensor,
    k: int = 1000,
    similarity: str = "cos_sim",
    doc_block: int = 65536,
    local_topk: str | None = None,
) -> RankedLists:
    """Blockwise exact search on one device. [Q,H] × [N,H] → top-k.

    ``cos_sim`` normalizes both sides in their own dtype on every call."""
    n = corpus_embs.shape[0]
    q = query_embs.shape[0]
    k = min(k, n)
    if similarity == "cos_sim":
        query_embs = l2_normalize(query_embs)
        corpus_embs = l2_normalize(corpus_embs)
    doc_block = min(doc_block, n)
    num_blocks = -(-n // doc_block)
    offsets = torch.arange(doc_block, device=corpus_embs.device)

    def block_scores(bi: int):
        start = bi * doc_block
        # the tail block is clamped to stay in bounds; mask the overlap with
        # the previous block so no document is scored into the top-k twice
        real_start = min(start, n - doc_block)
        block = corpus_embs[real_start : real_start + doc_block]
        scores = matmul_f32(query_embs, block.T)
        fresh = (real_start + offsets) >= start
        return torch.where(fresh[None, :], scores, -torch.inf), real_start

    return blockwise_topk_offset(block_scores, num_blocks, q, k, local_topk=local_topk)


def _merge_local(local: RankedLists, mesh, shard_n: int, k: int) -> RankedLists:
    return merge_shards(globalize(local, mesh.coords[INDEX_AXIS], shard_n), local.scores, k, mesh)


def sharded_dense_search(
    query_embs: torch.Tensor,
    corpus_shards: torch.Tensor,
    mesh,
    k: int = 1000,
    similarity: str = "cos_sim",
    doc_block: int = 65536,
) -> RankedLists:
    """Index-parallel exact search: ``corpus_shards`` is this rank's
    ``[N/S, H]`` rows of the corpus (every shard the same size); queries are
    replicated.  Depth ``min(k, N/S)``."""
    shard_n = corpus_shards.shape[0]
    k = min(k, shard_n)
    local = dense_search(query_embs, corpus_shards, k=k, similarity=similarity, doc_block=doc_block)
    return _merge_local(local, mesh, shard_n, k)


def sharded_maxsim_search(
    q_tokens: torch.Tensor,  # [Q, Lq, D]
    q_mask: torch.Tensor,  # [Q, Lq]
    corpus_tokens: torch.Tensor,  # this rank's [N/S, Ld, D]
    corpus_mask: torch.Tensor,  # this rank's [N/S, Ld]
    mesh,
    k: int = 1000,
    doc_block: int = 1024,
) -> RankedLists:
    """Index-parallel ColBERT search over the doc-major token matrix: each
    rank runs ``maxsim_search`` over its shard (K1 on the card, the dense
    reference on the CPU, which is JAX's ``use_pallas=False``)."""
    from fusion_tpu_torch.ops.maxsim import maxsim_search

    shard_n = corpus_tokens.shape[0]
    k = min(k, shard_n)
    local = maxsim_search(q_tokens, q_mask, corpus_tokens, corpus_mask, k=k, doc_block=doc_block)
    return _merge_local(local, mesh, shard_n, k)


def sharded_maxsim_search_tm(
    q_tokens: torch.Tensor,  # [Q, Lq, D]
    q_mask: torch.Tensor,  # [Q, Lq]
    corpus_tm: torch.Tensor,  # this rank's prepared [Ld, N/S, D]
    doc_valid: torch.Tensor,  # this rank's [N/S] bool
    mesh,
    k: int = 1000,
    use_pallas: bool | None = None,
) -> RankedLists:
    """Index-parallel MaxSim over the PREPARED token-major corpus, the
    serving layout (``prepare_token_corpus``; docs on axis 1): each rank
    streams ``maxsim_search_tm`` (K1 on the card) over its shard."""
    from fusion_tpu_torch.ops.maxsim import maxsim_search_tm

    shard_n = corpus_tm.shape[1]
    k = min(k, shard_n)
    local = maxsim_search_tm(q_tokens, q_mask, corpus_tm, doc_valid, k=k, use_pallas=use_pallas)
    return _merge_local(local, mesh, shard_n, k)


def sharded_maxsim_search_compressed(
    q_tokens: torch.Tensor,  # [Q, Lq, D]
    q_mask: torch.Tensor,  # [Q, Lq]
    index,  # this rank's CompressedTokenIndex (its docs' rows; centroids replicated)
    mesh,
    k: int = 1000,
    doc_block: int = 8192,
    use_pallas: bool | None = None,
) -> RankedLists:
    """Index-parallel search over the residual-compressed ColBERT index:
    each rank decompresses its shard block by block into K1
    (``maxsim_search_compressed``).  ``use_pallas`` is checked and dropped."""
    from fusion_tpu_torch.core.device import check_use_pallas
    from fusion_tpu_torch.index.compression import maxsim_search_compressed

    check_use_pallas(use_pallas)
    shard_n = index.num_docs
    k = min(k, shard_n)
    local = maxsim_search_compressed(q_tokens, q_mask, index, k=k, doc_block=min(doc_block, shard_n))
    return _merge_local(local, mesh, shard_n, k)


def chunked_encode_search(
    encode_fn,
    query_batches,
    corpus_embs: torch.Tensor,
    k: int = 1000,
    similarity: str = "cos_sim",
) -> RankedLists:
    """Encode each query batch (``encode_fn(batch)`` → [B, H] on the
    corpus's device) and search it; the batches' lists concatenated."""
    parts = [dense_search(encode_fn(batch), corpus_embs, k=k, similarity=similarity) for batch in query_batches]
    return RankedLists(ids=torch.cat([p.ids for p in parts]), scores=torch.cat([p.scores for p in parts]))
