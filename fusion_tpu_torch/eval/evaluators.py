"""Evaluation during and after training, as ``fusion_tpu/eval/evaluators.py``:

  * ``InformationRetrievalEvaluator`` — full-corpus retrieval with the
    latency split (query encoding, scoring, formatting, and the corpus
    encode as 'index build'), for bi-encoders and ColBERT (whose search
    runs MaxSim through K1 on the card);
  * ``RerankingEvaluator`` — candidate-list reranking for cross-encoders;
  * ``BestModelTracker`` — keep the best score and export the best model.

Both evaluators return their main score (map@max for retrieval, recall@10
for reranking), keep the metric dict as ``last_scores`` and append a CSV
row per call.  Times are host wall-clock, each phase ending with the
result on the host or a device synchronize.
"""

from __future__ import annotations

import os
import time
from typing import Mapping, Sequence

import numpy as np
import torch

from fusion_tpu_torch.core.ranked import RankedLists
from fusion_tpu_torch.eval.metrics import Metrics
from fusion_tpu_torch.utils.loggers import write_metrics_csv


def _sync(x) -> None:
    """Wait for the device work behind ``x`` (a tensor or a tuple of them)."""
    t = x[0] if isinstance(x, tuple) else x
    if isinstance(t, torch.Tensor) and t.is_cuda:
        torch.cuda.synchronize(t.device)


class InformationRetrievalEvaluator:
    def __init__(
        self,
        queries: Mapping[int, str],
        corpus: Mapping[int, str],
        relevant_docs: Mapping[int, Sequence[int]],
        recall_at_k: Sequence[int] = (5, 10, 20, 50, 100, 200, 500, 1000),
        map_at_k: Sequence[int] = (10, 100),
        mrr_at_k: Sequence[int] = (10, 100),
        ndcg_at_k: Sequence[int] = (10, 100),
        accuracy_at_k: Sequence[int] = (1,),
        batch_size: int = 32,
        main_score: str | None = None,
        name: str = "",
        log_callback=None,
    ):
        self.qids = list(queries.keys())
        self.query_texts = [queries[q] for q in self.qids]
        self.corpus_ids = np.asarray(list(corpus.keys()), dtype=np.int64)
        self.corpus_texts = list(corpus.values())
        self.labels = [list(relevant_docs.get(q, [])) for q in self.qids]
        self.metrics = Metrics(recall_at_k, map_at_k, mrr_at_k, ndcg_at_k, accuracy_at_k)
        self.batch_size = batch_size
        self.main_score = main_score or f"map@{max(map_at_k)}"
        self.name = name
        self.log_callback = log_callback

    def __call__(self, model, output_path: str | None = None, epoch: int = -1, steps: int = -1) -> float:
        m = self.metrics
        all_ks = [*m.recall_at_k, *m.map_at_k, *m.mrr_at_k, *m.ndcg_at_k, *m.accuracy_at_k]
        top_k = min(max(all_ks) if all_ks else 100, len(self.corpus_texts))

        t0 = time.perf_counter()
        if hasattr(model, "index"):  # ColBERT
            index = model.index(self.corpus_texts, batch_size=self.batch_size)
            _sync(index.tokens)
            t_index = time.perf_counter() - t0
            t0 = time.perf_counter()
            queries = model.encode_queries(self.query_texts, batch_size=self.batch_size)
            _sync(queries)
            t_encode = time.perf_counter() - t0
            t0 = time.perf_counter()
            ranked = model.search(queries, index, k=top_k, batch_size=self.batch_size, use_pallas=False)
        else:
            d_embs = model.encode(self.corpus_texts, query_mode=False, batch_size=self.batch_size)
            _sync(d_embs)
            t_index = time.perf_counter() - t0
            t0 = time.perf_counter()
            q_embs = model.encode(self.query_texts, query_mode=True, batch_size=self.batch_size)
            _sync(q_embs)
            t_encode = time.perf_counter() - t0
            t0 = time.perf_counter()
            ranked = model.search(q_embs, d_embs, topk=top_k, batch_size=self.batch_size)
        ranked = RankedLists(ranked.ids.cpu(), ranked.scores.cpu())
        t_score = time.perf_counter() - t0

        t0 = time.perf_counter()
        preds = ranked.remap_ids(self.corpus_ids).id_lists()
        scores = self.metrics.compute_all_metrics(self.labels, preds)
        t_format = time.perf_counter() - t0

        nq = max(len(self.qids), 1)
        scores["latency (ms/query)"] = (t_encode + t_score) / nq * 1000
        scores["encoding (ms/query)"] = t_encode / nq * 1000
        scores["scoring (ms/query)"] = t_score / nq * 1000
        scores["index build (ms/query)"] = t_index / nq * 1000
        scores["formatting (ms/query)"] = t_format / nq * 1000
        if self.log_callback is not None:
            for metric, value in scores.items():
                self.log_callback(epoch, steps, metric, value)
        if output_path:
            write_metrics_csv(os.path.join(output_path, f"ir_eval_{self.name or 'results'}.csv"),
                              [{"epoch": epoch, "steps": steps, **scores}], append=True)
        self.last_scores = scores
        return float(scores[self.main_score])


class RerankingEvaluator:
    """Cross-encoder reranking over per-query candidate pools."""

    def __init__(
        self,
        samples: Sequence[Mapping],
        mrr_at_k: Sequence[int] = (10,),
        recall_at_k: Sequence[int] = (5, 10, 20, 50, 100),
        batch_size: int = 64,
        name: str = "",
        log_callback=None,
    ):
        """``samples``: [{'query': str, 'positive': [str], 'negative': [str]}]."""
        self.samples = list(samples)
        self.metrics = Metrics(recall_at_k=recall_at_k, mrr_at_k=mrr_at_k)
        self.batch_size = batch_size
        self.name = name
        self.log_callback = log_callback

    def __call__(self, model, output_path: str | None = None, epoch: int = -1, steps: int = -1) -> float:
        all_labels, all_preds = [], []
        t0 = time.perf_counter()
        for sample in self.samples:
            if not sample["positive"] or not sample["negative"]:
                continue  # a pool without positives or negatives says nothing
            docs = list(sample["positive"]) + list(sample["negative"])
            scores = model.predict([(sample["query"], d) for d in docs], batch_size=self.batch_size)
            all_preds.append(np.argsort(-scores, kind="stable").tolist())
            all_labels.append(list(range(len(sample["positive"]))))
        elapsed = time.perf_counter() - t0

        scores = self.metrics.compute_all_metrics(all_labels, all_preds)
        scores["latency (ms/query)"] = elapsed / max(len(all_preds), 1) * 1000
        main = scores.get("recall@10", next(iter(scores.values())))
        if self.log_callback is not None:
            for metric, value in scores.items():
                self.log_callback(epoch, steps, metric, value)
        if output_path:
            write_metrics_csv(os.path.join(output_path, f"rerank_eval_{self.name or 'results'}.csv"),
                              [{"epoch": epoch, "steps": steps, **scores}], append=True)
        self.last_scores = scores
        return float(main)


class BestModelTracker:
    """An ``eval_callback`` for ``fit``: run the evaluator, keep the best
    score and save the best model under ``save_path/best``."""

    def __init__(self, evaluator, save_path: str | None = None):
        self.evaluator = evaluator
        self.save_path = save_path
        self.best_score = -np.inf
        self.best_step = -1

    def __call__(self, model, step: int) -> float:
        score = self.evaluator(model, output_path=self.save_path, steps=step)
        if score > self.best_score:
            self.best_score, self.best_step = score, step
            if self.save_path:
                model.save(os.path.join(self.save_path, "best"))
        return score
