"""Ranking files in ColBERT's TSV format (qid \t pid \t rank [\t score]):
write ``RankedLists``, read a file back, and evaluate one with
``eval/metrics.Metrics``."""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from fusion_tpu_torch.core.ranked import PAD_ID, RankedLists


def write_ranking_tsv(
    path: str,
    ranked: RankedLists,
    qids: Sequence[int],
    idx2id: np.ndarray | None = None,
    with_scores: bool = True,
) -> int:
    rl = ranked.remap_ids(idx2id) if idx2id is not None else ranked
    ids = rl.ids.cpu().numpy()
    scores = rl.scores.cpu().numpy()
    n = 0
    with open(path, "w") as f:
        for qi, qid in enumerate(qids):
            rank = 1
            for pid, score in zip(ids[qi], scores[qi]):
                if pid == PAD_ID:
                    continue
                if with_scores:
                    f.write(f"{qid}\t{int(pid)}\t{rank}\t{float(score)}\n")
                else:
                    f.write(f"{qid}\t{int(pid)}\t{rank}\n")
                rank += 1
                n += 1
    return n


def read_ranking_tsv(path: str) -> dict[int, list[int]]:
    """qid → ranked pid list (rank order preserved)."""
    out: dict[int, list[tuple[int, int]]] = {}
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3:
                continue
            qid, pid, rank = int(parts[0]), int(parts[1]), int(parts[2])
            out.setdefault(qid, []).append((rank, pid))
    return {qid: [pid for _, pid in sorted(rows)] for qid, rows in out.items()}


def evaluate_ranking_file(
    path: str,
    qrels: Mapping[int, Sequence[int]],
    recall_at_k: Sequence[int] = (5, 10, 20, 50, 100, 200, 500, 1000),
    mrr_at_k: Sequence[int] = (10,),
) -> dict:
    """Evaluate a ranking file against ``qrels``: recall@k, MRR@k and
    R-precision."""
    from fusion_tpu_torch.eval.metrics import Metrics

    ranking = read_ranking_tsv(path)
    # every JUDGED query counts: one absent from the ranking file scores 0
    # (intersecting would silently inflate the macro averages)
    qids = list(qrels.keys())
    preds = [ranking.get(q, []) for q in qids]
    labels = [list(qrels[q]) for q in qids]
    ev = Metrics(recall_at_k=recall_at_k, mrr_at_k=mrr_at_k)
    scores = ev.compute_all_metrics(labels, preds)
    scores["num_queries"] = len(qids)
    scores["num_unanswered"] = sum(1 for q in qids if q not in ranking)
    return scores
