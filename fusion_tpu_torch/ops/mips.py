"""Exact maximum-inner-product / cosine search over a dense corpus matrix.

The corpus is scanned in blocks with a running top-k (``ops/topk.py``).  It
serves the DPR leg and the SPLADE sparse-as-dense leg.
"""

from __future__ import annotations

import torch

from fusion_tpu_torch.core.ranked import RankedLists
from fusion_tpu_torch.models.heads import l2_normalize
from fusion_tpu_torch.ops.topk import blockwise_topk_offset


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
