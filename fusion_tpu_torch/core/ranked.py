"""Fixed-shape ranked-list container.

A batch of ranked lists is a pair of tensors

    ids:    int32[num_queries, k]   (corpus ids, PAD_ID = empty slot)
    scores: float32[num_queries, k] (descending per row, -inf in empty slots)

Ties are ordered by position: of two equal scores the lower index ranks
first, as ``jax.lax.top_k`` orders them in the JAX package.  ``torch.topk``
gives no such order, so every top-k in this package goes through
``stable_topk``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from fusion_tpu_torch.core.device import resolve_device

# Sentinel for empty slots. Real corpus ids must be >= 0.
PAD_ID = -1

# Score of an empty slot: strictly below any real score.
PAD_SCORE = float("-inf")


def stable_topk(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` over the last axis; equal scores keep ascending index order."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@dataclasses.dataclass
class RankedLists:
    """A batch of ranked retrieval results with a fixed depth ``k``."""

    ids: torch.Tensor  # int32[Q, K]
    scores: torch.Tensor  # float32[Q, K]

    @property
    def num_queries(self) -> int:
        return self.ids.shape[0]

    @property
    def depth(self) -> int:
        return self.ids.shape[1]

    def topk(self, k: int) -> "RankedLists":
        """The top ``k`` entries of each row (rows are sorted already)."""
        return RankedLists(self.ids[:, :k], self.scores[:, :k])

    @classmethod
    def from_python(cls, results: Sequence[Sequence[tuple]], k: int | None = None, *, device="cuda") -> "RankedLists":
        """Build from per-query ``[(corpus_id, score), ...]`` lists, cut or
        padded (``PAD_ID`` / ``PAD_SCORE``) to depth ``k`` (default: the
        longest list), on ``device``."""
        q = len(results)
        k = k if k is not None else max((len(r) for r in results), default=0)
        ids = np.full((q, k), PAD_ID, dtype=np.int32)
        scores = np.full((q, k), PAD_SCORE, dtype=np.float32)
        for i, row in enumerate(results):
            row = list(row)[:k]
            if row:
                ids[i, : len(row)] = [int(c) for c, _ in row]
                scores[i, : len(row)] = [float(s) for _, s in row]
        device = resolve_device(device)
        return cls(torch.from_numpy(ids).to(device), torch.from_numpy(scores).to(device))

    def to_python(self) -> list[list[dict]]:
        """Per-query ``[{"corpus_id": id, "score": s}, ...]`` (host-side),
        pads stripped."""
        out = []
        for row_ids, row_scores in zip(self.ids.cpu().numpy(), self.scores.float().cpu().numpy()):
            valid = row_ids != PAD_ID
            out.append([{"corpus_id": int(c), "score": float(s)} for c, s in zip(row_ids[valid], row_scores[valid])])
        return out

    def id_lists(self) -> list[list[int]]:
        """Per-query ranked id lists (host-side), pads stripped."""
        return [[int(c) for c in row if c != PAD_ID] for row in self.ids.cpu().numpy()]

    def remap_ids(self, idx2id: np.ndarray) -> "RankedLists":
        """Map internal row indices to external corpus ids (``idx2id[i]`` is
        the external id of row ``i``, held as int32).  PAD entries stay PAD."""
        table = torch.as_tensor(np.asarray(idx2id).astype(np.int32), device=self.ids.device)
        safe = self.ids.clamp(0, table.shape[0] - 1).long()
        pad = torch.full_like(self.ids, PAD_ID)
        return RankedLists(torch.where(self.ids == PAD_ID, pad, table[safe]), self.scores)


def ranked_from_scores(scores: torch.Tensor, k: int) -> RankedLists:
    """Full scoring [Q, N] → ranked lists of depth ``min(k, N)``."""
    k = min(k, scores.shape[-1])
    top_scores, top_idx = stable_topk(scores, k)
    return RankedLists(top_idx.to(torch.int32), top_scores.to(torch.float32))
