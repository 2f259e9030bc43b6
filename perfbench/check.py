"""The comparison that decides ``correct``.

The program's outputs for the checked queries (each leg's top k, the fused
list, the final list) are judged against the reference's scores:

  gap.<leg>    the widest amount by which the program's r-th document scores
               below the reference's r-th best (the reference's score of both),
               over every rank r < k, as a share of the reference's top-k
               spread (its best minus its k-th score): 0 when the program
               returned the reference's order, ties aside;
  err.<leg>    the widest gap between a score the program reported and the
               reference's score of that document, over the same spread;
  fusion       RRF recomputed from the program's own leg lists: the widest gap
               between the fused scores it reported and those, and the widest
               rank gap, in units of one list's best term 1 / 61; without a
               rerank the final list must equal the fused one;
  rerank.gap   as gap.<leg>, for the program's head order under the
               reference's logits, over the head's logit spread;
  rerank.err   the widest gap between the logit the program's head score
               implies (its sigmoid lifted above the tail) and the reference's;
  *.median     the median over the checked queries of a query's gap.<leg> or
               rerank.err: steadier than the widest, which a single query's
               near-ties or rounding set.

The final list may hold the whole reranked head and the fused tail (a
search call) or only the head's first entries (a served reply): then each
must come from the fused head, once.

An id that repeats, lies outside the corpus, or a head that is not the
fused head reads as infinite.
"""

from __future__ import annotations

import math

import numpy as np

from perfbench.reference.hybrid import RRF_K, rrf_totals


def _valid(ids: np.ndarray, n: int) -> bool:
    return bool(((ids >= 0) & (ids < n)).all()) and len(np.unique(ids)) == len(ids)


def _gap(ref_row: np.ndarray, ids: np.ndarray, k: int, spread: float) -> float:
    best = -np.sort(-ref_row)[:k]
    return max(0.0, float((best[: len(ids)] - ref_row[ids]).max())) / spread


def list_readings(ref_row: np.ndarray, ids: np.ndarray, scores: np.ndarray) -> tuple[float, float]:
    """(gap, err) of one query's list against the reference's scores."""
    n, k = ref_row.shape[0], ids.shape[0]
    if not _valid(ids, n):
        return math.inf, math.inf
    best = -np.sort(-ref_row)[:k]
    spread = float(best[0] - best[-1]) or max(abs(float(best[0])), 1e-12)
    err = float(np.abs(scores.astype(np.float64) - ref_row[ids]).max()) / spread
    return _gap(ref_row, ids, k, spread), err


def judge(out: dict, ref_scores: dict, logits_of, n_docs: int, rerank_depth: int) -> dict[str, float]:
    """Readings (the widest over the checked queries) of the program's
    outputs ``out`` ({"legs": {leg: (ids, scores)}, "fused": ..., "final":
    ...}, host arrays, one row per checked query) against the reference's
    [Q, N] leg scores; ``logits_of(head_ids)`` gives the reference's logits
    of each row's head pairs."""
    readings: dict[str, float] = {}
    for leg, (ids, scores) in out["legs"].items():
        per_query = [list_readings(ref_scores[leg][q], ids[q], scores[q]) for q in range(ids.shape[0])]
        readings[f"gap.{leg}"] = max(g for g, _ in per_query)
        readings[f"err.{leg}"] = max(e for _, e in per_query)
        readings[f"gap.{leg}.median"] = float(np.median([g for g, _ in per_query]))

    f_ids, f_scores = out["fused"]
    fin_ids, fin_scores = out["final"]
    unit = RRF_K + 1.0
    fusion = 0.0
    for q in range(f_ids.shape[0]):
        total = rrf_totals(out["legs"], q)
        if not _valid(f_ids[q], n_docs):
            fusion = math.inf
            continue
        want = np.array([total.get(int(d), 0.0) for d in f_ids[q]])
        best = np.sort(np.fromiter(total.values(), float))[::-1][: len(want)]
        fusion = max(fusion, float(np.abs(f_scores[q] - want).max()) * unit,
                     max(0.0, float((best - want).max())) * unit)
    d = rerank_depth
    if not d:
        if not (np.array_equal(fin_ids, f_ids) and np.array_equal(fin_scores, f_scores)):
            fusion = math.inf
        readings["fusion"] = fusion
        return readings
    readings["fusion"] = fusion
    # the final list holds the reranked head (all of it, then the fused
    # tail; or only its first entries, as a served reply does)
    whole = fin_ids.shape[1] == f_ids.shape[1]
    w = min(d, fin_ids.shape[1])
    head = fin_ids[:, :w]
    same = all(
        set(head[q].tolist()) <= set(f_ids[q, :d].tolist()) and len(set(head[q].tolist())) == w
        and (not whole or (np.array_equal(fin_ids[q, d:], f_ids[q, d:])
                           and np.array_equal(fin_scores[q, d:], f_scores[q, d:])))
        for q in range(head.shape[0])
    )
    if not same:
        readings["rerank.gap"] = readings["rerank.err"] = readings["rerank.err.median"] = math.inf
        return readings
    f_head = f_ids[:, :d]
    ref_all = np.asarray(logits_of(f_head), np.float64)  # the reference's logits of the fused head
    offset = f_scores[:, d : d + 1].astype(np.float64) + 1.0 if f_scores.shape[1] > d else 0.0
    sig = np.clip(fin_scores[:, :w].astype(np.float64) - offset, 1e-12, 1.0 - 1e-12)
    got = np.log(sig) - np.log1p(-sig)
    gaps, errs = [], []
    for q in range(head.shape[0]):
        pos = {int(doc): j for j, doc in enumerate(f_head[q])}
        ref = ref_all[q, [pos[int(doc)] for doc in head[q]]]
        spread = float(ref_all[q].max() - ref_all[q].min()) or 1e-12
        errs.append(float(np.abs(got[q] - ref).max()) / spread)
        best = np.sort(ref_all[q])[::-1][:w]
        gaps.append(max(0.0, float((best - ref).max())) / spread)
    readings["rerank.gap"], readings["rerank.err"] = max(gaps), max(errs)
    readings["rerank.err.median"] = float(np.median(errs))
    return readings


def verdict(readings: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """(every compared reading within its limit, {name: {value, limit}}).
    The numbers compared are those the configuration gives a limit, of
    those the cell reads (no rerank, no rerank numbers); the others are
    read and not compared."""
    table = {}
    ok = True
    for name, limit in limits.items():
        if name not in readings:
            continue
        value = readings[name]
        finite = math.isfinite(value)
        # JSON has no infinity: a reading that never came or is no list is null
        table[name] = {"value": value if finite else None, "limit": limit}
        ok = ok and finite and value <= limit
    return ok, table
