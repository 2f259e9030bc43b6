"""Rank fusion over fixed-shape ranked lists.

  * Borda count (``bcf``):  score = (C - rank0 + 1) / C, C = #candidates
  * Reciprocal rank (``rrf``): 1 / (60 + rank1)
  * Normalized score fusion (``nsf``): normalize each system's scores
    (min-max / z-score / arctan / percentile-rank / normal-curve-equivalent),
    multiply by a convex weight, then sum
  * aggregation: scores summed per document over systems, sorted descending

The union aggregate is a sort by id + a windowed run sum + a stable top-k
over the concatenated (id, score) tensors, all on the lists' device.
``build_percentile_distribution`` makes the quantile tables the percentile
normalizations read (host numpy), and ``tune_fusion_weights`` grid-searches
NSF's convex weights over ``simplex_grid``.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from fusion_tpu_torch.core.ranked import PAD_ID, RankedLists, stable_topk

# sentinel that sorts after every real corpus id
_ID_SENTINEL = int(np.iinfo(np.int32).max)

FUSION_METHODS = ("bcf", "rrf", "nsf")
NORMALIZATIONS = (
    "none",
    "min-max",
    "z-score",
    "arctan",
    "percentile-rank",
    "normal-curve-equivalent",
)


def _masked_minmax(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    big = torch.where(valid, scores, -torch.inf).amax(dim=-1, keepdim=True)
    small = torch.where(valid, scores, torch.inf).amin(dim=-1, keepdim=True)
    same = big == small
    return torch.where(same, 1.0, (scores - small) / torch.where(same, 1.0, big - small))


def _masked_zscore(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    n = valid.sum(dim=-1, keepdim=True).to(scores.dtype)
    mean = torch.where(valid, scores, 0.0).sum(dim=-1, keepdim=True) / torch.clamp(n, min=1.0)
    # unbiased std (ddof=1), as torch.std in the reference
    var = torch.where(valid, (scores - mean) ** 2, 0.0).sum(dim=-1, keepdim=True) / torch.clamp(
        n - 1.0, min=1.0
    )
    std = torch.sqrt(var)
    return torch.where(std == 0.0, 0.0, (scores - mean) / torch.where(std == 0.0, 1.0, std))


def _arctan(scores: torch.Tensor) -> torch.Tensor:
    return (2.0 / math.pi) * torch.arctan(0.1 * scores)


def _percentile_rank(scores: torch.Tensor, distribution: torch.Tensor) -> torch.Tensor:
    """Nearest-quantile index / table size (searchsorted + neighbour check,
    the argmin over |distribution - score| of the reference)."""
    distr = torch.sort(distribution).values
    p = distr.shape[0]
    pos = torch.searchsorted(distr, scores.contiguous())  # first idx with distr[idx] >= s
    lo = (pos - 1).clamp(0, p - 1)
    hi = pos.clamp(0, p - 1)
    pick_lo = (distr[lo] - scores).abs() <= (distr[hi] - scores).abs()
    return torch.where(pick_lo, lo, hi).to(torch.float32) / p


def _normal_curve_equivalent(pr: torch.Tensor) -> torch.Tensor:
    return torch.special.ndtri(pr / 100.0) * 21.06 + 50.0


def transform_scores(
    ranked: RankedLists,
    transformation: str,
    percentile_distr: torch.Tensor | np.ndarray | None = None,
) -> RankedLists:
    """Apply a rank/score transformation to each row of a ranked-list batch."""
    ids, scores = ranked.ids, ranked.scores
    # -inf-scored slots carry REAL ids when a list is padded past the corpus:
    # rank-based transforms would otherwise hand those docs positive scores
    valid = (ids != PAD_ID) & torch.isfinite(scores)
    k = ids.shape[-1]
    dev = scores.device
    if transformation == "borda-count":
        c = valid.sum(dim=-1, keepdim=True).to(torch.float32)
        rank0 = torch.arange(k, dtype=torch.float32, device=dev).expand(ids.shape)
        new = (c - rank0 + 1.0) / torch.clamp(c, min=1.0)
    elif transformation == "reciprocal-rank":
        rank1 = torch.arange(1, k + 1, dtype=torch.float32, device=dev)
        new = (1.0 / (60.0 + rank1)).expand(ids.shape)
    elif transformation == "min-max":
        new = _masked_minmax(scores, valid)
    elif transformation == "z-score":
        new = _masked_zscore(scores, valid)
    elif transformation == "arctan":
        new = _arctan(scores)
    elif transformation in ("percentile-rank", "normal-curve-equivalent"):
        if percentile_distr is None:
            raise ValueError(f"{transformation} needs a quantile table")
        distr = torch.as_tensor(percentile_distr, dtype=torch.float32, device=dev)
        new = _percentile_rank(scores, distr)
        if transformation == "normal-curve-equivalent":
            new = _normal_curve_equivalent(new)
    elif transformation in (None, "none"):
        new = scores
    else:
        raise ValueError(f"unknown transformation {transformation!r}")
    return RankedLists(ids, torch.where(valid, new, 0.0).to(torch.float32))


def aggregate_scores(
    ids_cat: torch.Tensor, scores_cat: torch.Tensor, return_topk: int, max_duplicates: int
) -> RankedLists:
    """Sum scores per document id across systems and rank.

    ids_cat/scores_cat: [Q, M] concatenation over systems (pads:
    _ID_SENTINEL / 0.0).  Every doc id occurs at most once per system, so
    after a stable sort by id each run of equal ids has length ≤
    ``max_duplicates`` (the number of systems) and its total is a fixed
    shifted-window sum, taken in system order."""
    if max_duplicates < 1:
        raise ValueError(f"max_duplicates must be >= 1, got {max_duplicates}")
    sid, order = torch.sort(ids_cat, dim=-1, stable=True)
    ssc = torch.gather(scores_cat, -1, order)
    total = ssc
    rows = sid.shape[0]
    for j in range(1, max_duplicates):
        nid = torch.cat([sid[:, j:], sid.new_full((rows, j), _ID_SENTINEL - 1)], dim=-1)
        nsc = torch.cat([ssc[:, j:], ssc.new_zeros((rows, j))], dim=-1)
        total = total + torch.where(nid == sid, nsc, 0.0)
    is_first = torch.cat(
        [torch.ones((rows, 1), dtype=torch.bool, device=sid.device), sid[:, 1:] != sid[:, :-1]],
        dim=-1,
    )
    final = torch.where(is_first & (sid != _ID_SENTINEL), total, -torch.inf)
    top_scores, pos = stable_topk(final, return_topk)
    top_ids = torch.gather(sid, -1, pos)
    top_ids = torch.where(torch.isneginf(top_scores), PAD_ID, top_ids)
    return RankedLists(top_ids.to(torch.int32), top_scores.to(torch.float32))


class Aggregator:
    """Fuse ranked lists from multiple retrieval systems."""

    @classmethod
    def fuse(
        cls,
        ranked_lists: Mapping[str, RankedLists],
        method: str,
        normalization: str | None = None,
        linear_weights: Mapping[str, float] | None = None,
        percentile_distributions: Mapping[str, np.ndarray] | None = None,
        return_topk: int = 1000,
    ) -> RankedLists:
        if method not in FUSION_METHODS:
            raise ValueError(f"method must be one of {FUSION_METHODS}, got {method!r}")
        num_queries = {s: rl.num_queries for s, rl in ranked_lists.items()}
        if len(set(num_queries.values())) != 1:
            raise ValueError(f"systems ran on different query counts: {num_queries}")
        if method == "nsf" and (
            linear_weights is None or set(linear_weights) != set(ranked_lists)
        ):
            raise ValueError("linear_weights keys must match ranked_lists systems")

        transformed: list[RankedLists] = []
        for system, rl in ranked_lists.items():
            if method == "bcf":
                t = transform_scores(rl, "borda-count")
            elif method == "rrf":
                t = transform_scores(rl, "reciprocal-rank")
            else:
                distr = (percentile_distributions or {}).get(system)
                t = transform_scores(rl, normalization or "none", percentile_distr=distr)
                t = RankedLists(t.ids, t.scores * float(linear_weights[system]))
            transformed.append(t)

        ids_cat = torch.cat([t.ids for t in transformed], dim=-1)
        scores_cat = torch.cat([t.scores for t in transformed], dim=-1)
        # move pads to the sentinel id so they group into one dead run
        pad = ids_cat == PAD_ID
        ids_cat = torch.where(pad, _ID_SENTINEL, ids_cat)
        scores_cat = torch.where(pad, 0.0, scores_cat)
        k = min(return_topk, ids_cat.shape[-1])
        return aggregate_scores(ids_cat, scores_cat, k, max_duplicates=len(transformed))

    transform_scores = staticmethod(transform_scores)


def build_percentile_distribution(all_scores: np.ndarray, num_points: int = 10000) -> np.ndarray:
    """Empirical quantile table from a system's score sample: exact zeros
    and the two smallest distinct values dropped, then ``num_points + 1``
    evenly spaced quantiles (f64)."""
    s = np.asarray(all_scores, dtype=np.float64).ravel()
    s = s[s != 0.0]
    if s.size:
        s = s[~np.isin(s, np.unique(s)[:2])]
    if s.size == 0:
        return np.zeros(num_points + 1)
    return np.quantile(s, np.linspace(0, 1, num_points + 1))


def simplex_grid(systems: Sequence[str], step: float = 0.05) -> list[dict[str, float]]:
    """Every weight dict over ``systems`` on the ``step`` grid summing to 1."""
    points = np.arange(0, 1 + step, step)
    return [
        dict(zip(systems, comb))
        for comb in itertools.product(points, repeat=len(systems))
        if np.isclose(sum(comb), 1.0)
    ]


def tune_fusion_weights(
    ranked_lists: Mapping[str, RankedLists],
    labels: Sequence[Sequence[int]],
    evaluate: Callable[[RankedLists], dict],
    normalization: str = "min-max",
    percentile_distributions: Mapping[str, np.ndarray] | None = None,
    step: float = 0.05,
    select_by: str = "recall@100",
) -> tuple[dict[str, float], list[dict]]:
    """Grid-search NSF's convex weights; returns (the best weights, one row
    of weights and metrics per grid point).  ``evaluate`` maps the fused
    lists to a metric dict (``Metrics.compute_all_metrics``); the first
    point reaching the best ``select_by`` wins."""
    rows = []
    best, best_score = None, -1.0
    for weights in simplex_grid(list(ranked_lists.keys()), step):
        fused = Aggregator.fuse(
            ranked_lists,
            method="nsf",
            normalization=normalization,
            linear_weights=weights,
            percentile_distributions=percentile_distributions,
        )
        scores = evaluate(fused)
        rows.append({**{f"weight_{k}": v for k, v in weights.items()}, **scores})
        if scores.get(select_by, -1.0) > best_score:
            best_score = scores[select_by]
            best = dict(weights)
    return best, rows
