"""Segmented run reduction over batched sorted key rows.

After a sort by key, equal keys form contiguous runs.  For runs of bounded
length, a Hillis-Steele shift-compare-add doubling loop computes every
position's within-run prefix sum in ceil(log2(max_run)) steps; the run TOTAL
lands on each run's LAST element.  Same additions in the same order as
``fusion_tpu/ops/segscan.py``, so equal inputs give bit-equal sums.
"""

from __future__ import annotations

import torch


def segmented_run_totals(
    keys: torch.Tensor, vals: torch.Tensor, max_run: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(keys [Q, L] sorted per row, vals [Q, L], run length ≤ max_run) →
    (prefix [Q, L] within-run inclusive prefix sums, is_end [Q, L] bool
    marking each run's last element, where ``prefix`` holds the run total)."""
    q, width = keys.shape
    seg = vals
    # shifts beyond the row length are no-ops: a run cannot exceed L
    max_run = min(max_run, width)
    d = 1
    while d < max_run:
        keys_shift = torch.cat([keys.new_full((q, d), -1), keys[:, :-d]], dim=1)
        seg_shift = torch.cat([seg.new_zeros((q, d)), seg[:, :-d]], dim=1)
        seg = seg + torch.where(keys_shift == keys, seg_shift, 0.0)
        d *= 2
    is_end = torch.cat(
        [keys[:, 1:] != keys[:, :-1], torch.ones((q, 1), dtype=torch.bool, device=keys.device)],
        dim=1,
    )
    return seg, is_end
