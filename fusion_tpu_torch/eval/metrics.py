"""IR evaluation metrics: recall@k, MAP@k, MRR@k, nDCG@k, R-precision and
accuracy@k over ranked id lists, as one vectorized numpy pass on the host
(the metrics read the final [Q, K] ids, which are small; retrieval and
fusion stay on the device).  The same formulas as
``fusion_tpu/eval/metrics.py``, so both packages give the same numbers:

  * recall@k       = |top-k ∩ gold| / |gold|
  * MAP@k          = sum_i [hit_i] * precision@(i+1) / |gold|
  * MRR@k          = 1 / (first hit rank), 0 if no hit in top-k
  * nDCG@k         = (rel_0 + sum_{i>=1} rel_i / log2(i+1)) /
                     (1 + sum_{i=1}^{|gold|-1} 1 / log2(i+1))
                     — a nonstandard discount with binary gains and an
                     all-relevant-at-top IDCG, kept so scores compare with
                     the paper's tables;
  * R-precision    = |top-R ∩ gold| / R with R = |gold|
  * accuracy@k     = 1 if any hit in top-k.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from fusion_tpu_torch.core.ranked import PAD_ID, RankedLists


def compute_precision_recall_f1(gold: Sequence[int], predicted: Sequence[int] | None) -> dict:
    """Set precision, recall and F1 of one query's predictions."""
    if predicted is None:
        return {"precision": 0, "recall": 0, "f1": 0}
    tp = len(set(gold) & set(predicted))
    precision = tp / len(predicted) if len(predicted) else 0
    recall = tp / len(gold) if len(gold) else 0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0
    return {"precision": precision, "recall": recall, "f1": f1}


def _pad_gold(all_ground_truths: Sequence[Sequence[int]]) -> np.ndarray:
    g = max((len(x) for x in all_ground_truths), default=1)
    g = max(g, 1)
    out = np.full((len(all_ground_truths), g), PAD_ID, dtype=np.int64)
    for i, row in enumerate(all_ground_truths):
        out[i, : len(row)] = list(row)
    return out


def _pad_results(all_results: Sequence[Sequence[int]]) -> np.ndarray:
    k = max((len(x) for x in all_results), default=1)
    k = max(k, 1)
    out = np.full((len(all_results), k), PAD_ID, dtype=np.int64)
    for i, row in enumerate(all_results):
        out[i, : len(row)] = list(row)
    return out


def relevance_matrix(ids: np.ndarray, gold: np.ndarray) -> np.ndarray:
    """Binary relevance grid: rel[q, i] = 1 iff ids[q, i] is a gold doc.

    ids: int[Q, K] ranked result ids (PAD_ID = empty), gold: int[Q, G]
    (PAD_ID padded); one broadcast compare, O(Q*K*G)."""
    hit = (ids[:, :, None] == gold[:, None, :]) & (gold[:, None, :] != PAD_ID)
    rel = hit.any(axis=-1) & (ids != PAD_ID)
    return rel.astype(np.float64)


class Metrics:
    """Batch IR metrics: every configured metric in one vectorized pass."""

    def __init__(
        self,
        recall_at_k: Sequence[int] = (),
        map_at_k: Sequence[int] = (),
        mrr_at_k: Sequence[int] = (),
        ndcg_at_k: Sequence[int] = (),
        accuracy_at_k: Sequence[int] = (),
    ):
        self.recall_at_k = list(recall_at_k)
        self.map_at_k = list(map_at_k)
        self.mrr_at_k = list(mrr_at_k)
        self.ndcg_at_k = list(ndcg_at_k)
        self.accuracy_at_k = list(accuracy_at_k)

    # ------------------------------------------------------------------
    def compute_all_metrics(
        self,
        all_ground_truths: Sequence[Sequence[int]],
        all_results: Sequence[Sequence[int]] | RankedLists,
    ) -> dict:
        """Macro-averaged metric dict over queries."""
        if isinstance(all_results, RankedLists):
            ids = all_results.ids.cpu().numpy().astype(np.int64)
        else:
            ids = _pad_results(all_results)
        gold = _pad_gold(all_ground_truths)
        return self.compute_from_arrays(ids, gold)

    def compute_from_arrays(self, ids: np.ndarray, gold: np.ndarray) -> dict:
        """Compute all configured metrics from padded id arrays."""
        per_query = self.per_query_metrics(ids, gold)
        return {name: float(vals.mean()) for name, vals in per_query.items()}

    def per_query_metrics(self, ids: np.ndarray, gold: np.ndarray) -> dict:
        """Per-query scores for every configured metric (pre macro-average)."""
        ids = np.asarray(ids)
        gold = np.asarray(gold)
        q, k_max = ids.shape
        rel = relevance_matrix(ids, gold)  # [Q, K]
        n_gold = (gold != PAD_ID).sum(axis=1)  # [Q]
        n_gold_safe = np.maximum(n_gold, 1)

        cum_rel = np.cumsum(rel, axis=1)  # [Q, K]
        positions = np.arange(1, k_max + 1, dtype=np.float64)  # 1-based ranks
        prec_at = cum_rel / positions  # precision@(i+1) per slot

        out = {}
        for k in self.recall_at_k:
            kk = min(k, k_max)
            out[f"recall@{k}"] = cum_rel[:, kk - 1] / n_gold_safe

        for k in self.map_at_k:
            kk = min(k, k_max)
            ap = (rel[:, :kk] * prec_at[:, :kk]).sum(axis=1) / n_gold_safe
            out[f"map@{k}"] = ap

        for k in self.mrr_at_k:
            kk = min(k, k_max)
            rr = (rel[:, :kk] / positions[:kk]).max(axis=1, initial=0.0)
            out[f"mrr@{k}"] = rr

        if self.ndcg_at_k:
            # position 0 undiscounted, position i >= 1 discounted by log2(i+1)
            discount = np.ones(k_max, dtype=np.float64)
            if k_max > 1:
                discount[1:] = 1.0 / np.log2(np.arange(1, k_max) + 1)
            # IDCG table: idcg[g] for g gold docs
            g_max = int(n_gold.max(initial=1))
            idcg_table = np.zeros(g_max + 1, dtype=np.float64)
            if g_max >= 1:
                idcg_table[1:] = 1.0 + np.cumsum(
                    np.concatenate([[0.0], 1.0 / np.log2(np.arange(1, g_max) + 1)])
                )
            idcg = idcg_table[n_gold]
            for k in self.ndcg_at_k:
                kk = min(k, k_max)
                dcg = (rel[:, :kk] * discount[:kk]).sum(axis=1)
                out[f"ndcg@{k}"] = np.where(idcg != 0, dcg / np.maximum(idcg, 1e-12), 0.0)

        for k in self.accuracy_at_k:
            kk = min(k, k_max)
            out[f"accuracy@{k}"] = (cum_rel[:, kk - 1] > 0).astype(np.float64)

        # R-precision: R = |gold| per query; hits in the first
        # min(R, len(results)) slots, so a short list contributes fewer hits
        r_idx = np.clip(np.minimum(n_gold, k_max) - 1, 0, k_max - 1)
        hits_at_r = np.take_along_axis(cum_rel, r_idx[:, None], axis=1)[:, 0]
        hits_at_r = np.where(np.minimum(n_gold, k_max) > 0, hits_at_r, 0.0)
        out["r-precision"] = hits_at_r / n_gold_safe
        return out

    def mean_latency_ms(self, total_seconds: float, num_queries: int) -> float:
        """Per-query latency in ms, reported beside each metric suite."""
        return (total_seconds / max(num_queries, 1)) * 1000.0
