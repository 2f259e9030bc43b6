"""Streaming top-k over blocked score computation.

Each score block is merged into a running ``(scores, ids)`` state with one
stable top-k over the concatenation, so the full score matrix never needs to
exist at once.  Ties keep the accumulator entry, which holds earlier blocks,
so a blocked scan ranks exactly like one top-k over all scores.
"""

from __future__ import annotations

from typing import Callable

import torch

from fusion_tpu_torch.core.ranked import RankedLists, stable_topk


def merge_topk(
    acc_scores: torch.Tensor,
    acc_ids: torch.Tensor,
    blk_scores: torch.Tensor,
    blk_ids: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge a block's scores into the running top-k.

    acc_scores/acc_ids: [Q, K]; blk_scores/blk_ids: [Q, B].  Returns new
    [Q, K] state.  Ties keep the accumulator entry (stable across blocks).
    """
    k = acc_scores.shape[-1]
    cat_scores = torch.cat([acc_scores, blk_scores], dim=-1)
    cat_ids = torch.cat([acc_ids, blk_ids], dim=-1)
    top_scores, top_pos = stable_topk(cat_scores, k)
    return top_scores, torch.gather(cat_ids, -1, top_pos)


def _init_state(num_queries: int, k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Empty running state on the device the first block was scored on."""
    return (
        torch.full((num_queries, k), -torch.inf, dtype=torch.float32, device=device),
        torch.full((num_queries, k), -1, dtype=torch.int32, device=device),
    )


def _check_local_topk(local_topk: str | None) -> None:
    if local_topk not in (None, "exact", "approx"):
        raise ValueError(f"local_topk must be None, 'exact' or 'approx', got {local_topk!r}")


def blockwise_topk(
    score_block: Callable[[int], tuple[torch.Tensor, torch.Tensor]],
    num_blocks: int,
    num_queries: int,
    k: int,
    local_topk: str | None = None,
) -> RankedLists:
    """Scan ``num_blocks`` score blocks and keep a running top-k.

    ``score_block(block_idx)`` returns ``(scores [Q, B], ids [Q, B])`` for
    that block (ids are global corpus indices; masked slots carry -inf).
    ``local_topk='exact'`` first cuts each block wider than ``2k`` to its own
    top-k, which shrinks every merge to ``[Q, 2k]`` and ranks the same.
    ``'approx'`` (the JAX package's approximate reducer) is served by the
    same exact cut: the port's result never depends on a recall target.
    """
    _check_local_topk(local_topk)
    acc_scores = acc_ids = None
    for bi in range(num_blocks):
        blk_scores, blk_ids = score_block(bi)
        if acc_scores is None:
            acc_scores, acc_ids = _init_state(num_queries, k, blk_scores.device)
        blk_scores = blk_scores.to(torch.float32)
        blk_ids = blk_ids.to(torch.int32)
        if local_topk is not None and blk_scores.shape[-1] > 2 * k:
            blk_scores, pos = stable_topk(blk_scores, k)
            blk_ids = torch.gather(blk_ids, -1, pos)
        acc_scores, acc_ids = merge_topk(acc_scores, acc_ids, blk_scores, blk_ids)
    return RankedLists(ids=acc_ids, scores=acc_scores)


def blockwise_topk_offset(
    score_block: Callable[[int], tuple[torch.Tensor, int]],
    num_blocks: int,
    num_queries: int,
    k: int,
    local_topk: str | None = None,
) -> RankedLists:
    """``blockwise_topk`` for blocks whose ids are ``start + arange(B)``:
    ``score_block(block_idx)`` returns ``(scores [Q, B], start)`` and global
    ids come from arithmetic on the kept positions; ``local_topk`` as in
    ``blockwise_topk`` ('approx' is the exact cut)."""
    _check_local_topk(local_topk)
    acc_scores = acc_ids = None
    for bi in range(num_blocks):
        blk_scores, start = score_block(bi)
        if acc_scores is None:
            acc_scores, acc_ids = _init_state(num_queries, k, blk_scores.device)
        blk_scores = blk_scores.to(torch.float32)
        if local_topk is None or blk_scores.shape[-1] <= 2 * k:
            vals = blk_scores
            pos = torch.arange(vals.shape[-1], device=vals.device).expand_as(vals)
        else:
            vals, pos = stable_topk(blk_scores, k)
        blk_ids = (pos + int(start)).to(torch.int32)
        acc_scores, acc_ids = merge_topk(acc_scores, acc_ids, vals, blk_ids)
    return RankedLists(ids=acc_ids, scores=acc_scores)
