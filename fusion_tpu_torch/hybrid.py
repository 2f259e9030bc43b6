"""End-to-end hybrid retrieval pipeline for evaluation.

``HybridPipeline`` holds a corpus and runs any subset of BM25, DPR, SPLADE
and ColBERT over it through each retriever's own search (the corpus encoded
per call), fuses the ranked lists (Borda / RRF / NSF), optionally reranks
them with monoBERT, and evaluates them with ``eval/metrics.Metrics``.
Ranked lists stay on the device as fixed-shape ``RankedLists`` until the
metrics read them.  On the card the ColBERT search runs the MaxSim kernel.

Models work on contiguous internal indices [0, N); ``idx2id`` maps them to
the corpus's external ids at the boundary.
"""

from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np

from fusion_tpu_torch.core.device import resolve_device
from fusion_tpu_torch.core.ranked import PAD_ID, RankedLists
from fusion_tpu_torch.data.preprocessor import TextPreprocessor
from fusion_tpu_torch.eval.metrics import Metrics
from fusion_tpu_torch.fusion.aggregator import Aggregator, build_percentile_distribution, transform_scores
from fusion_tpu_torch.models.bm25 import BM25Index
from fusion_tpu_torch.utils.loggers import write_metrics_csv


def run_evaluation(
    predictions: Sequence[Sequence[int]] | RankedLists,
    labels: Sequence[Sequence[int]],
    print2console: bool = True,
    logger=None,
    split: str = "dev",
) -> dict:
    """The full metric suite: recall@{5..1000}, MAP, MRR and nDCG @{10, 100}
    and R-precision."""
    evaluator = Metrics(
        recall_at_k=[5, 10, 20, 50, 100, 200, 500, 1000],
        map_at_k=[10, 100],
        mrr_at_k=[10, 100],
        ndcg_at_k=[10, 100],
    )
    scores = evaluator.compute_all_metrics(labels, predictions)
    if print2console:
        for metric, score in scores.items():
            print(f"- {metric.capitalize()}: {score:.3f}")
    if logger is not None:
        for metric, score in scores.items():
            logger.log_eval(0, 0, f"{split}/{metric}", score)
    return scores


@dataclass
class SearchResult:
    ranked: RankedLists  # internal indices
    latency_ms_per_query: float


class HybridPipeline:
    """Hold a corpus and run retrieval systems over it on ``device``."""

    def __init__(
        self, corpus: Mapping[int, str], preprocessor: TextPreprocessor | None = None, device="cuda"
    ):
        self.corpus = dict(corpus)
        self.documents = list(self.corpus.values())
        self.idx2id = np.asarray(list(self.corpus.keys()), dtype=np.int64)
        self.id2idx = {pid: i for i, pid in enumerate(self.corpus.keys())}
        self.preprocessor = preprocessor
        self.device = resolve_device(device)
        self._bm25_cache: dict = {}
        self._preprocessed_docs: list[str] | None = None

    def _preprocess(self, texts: Sequence[str]) -> list[str]:
        if self.preprocessor is None:
            self.preprocessor = TextPreprocessor(spacy_model=None)
        return self.preprocessor.preprocess(list(texts), lemmatize=True)

    def bm25_search(
        self,
        queries: Sequence[str],
        do_preprocessing: bool = True,
        k1: float = 2.5,
        b: float = 0.2,
        return_topk: int = 1000,
        variant: str = "bm25",
    ) -> SearchResult:
        """Lexical retrieval; the index is built once per (variant,
        preprocessing) and re-parameterized per call."""
        if do_preprocessing:
            if self._preprocessed_docs is None:
                self._preprocessed_docs = self._preprocess(self.documents)
            docs = self._preprocessed_docs
            queries = self._preprocess(queries)
        else:
            docs = self.documents
        key = (variant, do_preprocessing)
        if key not in self._bm25_cache:
            self._bm25_cache[key] = BM25Index.build(docs, k1=k1, b=b, variant=variant, device=self.device)
        index = self._bm25_cache[key]
        index.update_params(k1, b)
        t0 = time.perf_counter()
        ranked = index.search_all(queries, top_k=return_topk)
        dt = (time.perf_counter() - t0) / max(len(queries), 1) * 1000
        return SearchResult(ranked, dt)

    def single_vector_search(
        self, queries: Sequence[str], model, return_topk: int = 1000, batch_size: int = 64
    ) -> SearchResult:
        """Dense or SPLADE retrieval: encode the corpus once, exact top-k."""
        d_embs = model.encode(self.documents, query_mode=False, batch_size=batch_size, sort_by_length=True)
        t0 = time.perf_counter()
        ranked = model.search(queries, d_embs, topk=return_topk, batch_size=batch_size)
        dt = (time.perf_counter() - t0) / max(len(queries), 1) * 1000
        return SearchResult(ranked, dt)

    def multi_vector_search(
        self,
        queries: Sequence[str],
        model,
        return_topk: int = 1000,
        batch_size: int = 32,
        index=None,
        use_pallas: bool = True,
    ) -> SearchResult:
        """ColBERT late interaction over a token index (built here unless
        given).  ``use_pallas`` picks ``ColBERT.search``'s prepared
        token-major branch, which runs the MaxSim kernel on the card."""
        if index is None:
            index = model.index(self.documents, batch_size=batch_size)
        t0 = time.perf_counter()
        ranked = model.search(queries, index, k=return_topk, batch_size=batch_size, use_pallas=use_pallas)
        dt = (time.perf_counter() - t0) / max(len(queries), 1) * 1000
        return SearchResult(ranked, dt)

    def cross_encoder_search(
        self,
        queries: Sequence[str],
        candidates: RankedLists,
        model,
        return_topk: int = 100,
        batch_size: int = 64,
    ) -> SearchResult:
        """monoBERT rerank of the candidate lists (internal indices)."""
        t0 = time.perf_counter()
        ranked = model.rerank(queries, candidates, corpus=self.documents, top_k=return_topk, batch_size=batch_size)
        dt = (time.perf_counter() - t0) / max(len(queries), 1) * 1000
        return SearchResult(ranked, dt)

    def fuse(
        self,
        results: Mapping[str, RankedLists],
        method: str = "rrf",
        normalization: str | None = None,
        linear_weights: Mapping[str, float] | None = None,
        percentile_distributions=None,
        return_topk: int = 1000,
    ) -> RankedLists:
        """Fuse per-system lists; NSF without weights weighs systems equally."""
        if method == "nsf" and linear_weights is None:
            linear_weights = {s: 1.0 / len(results) for s in results}
        return Aggregator.fuse(
            results,
            method=method,
            normalization=normalization,
            linear_weights=linear_weights,
            percentile_distributions=percentile_distributions,
            return_topk=return_topk,
        )

    def analyze_score_distributions(
        self,
        results: Mapping[str, RankedLists],
        labels: Sequence[Sequence[int]] | None = None,
        normalization: str | None = None,
        num_points: tuple[int, ...] = (1000, 10_000, 100_000),
        output_dir: str | None = None,
        tag: str = "indomain",
        seed: int = 42,
    ) -> dict:
        """Per-system score distributions: (a) each system's pooled
        transformed scores, (b) quantile tables at several sizes (plus one
        of ``len(corpus)`` points), and (c) positive / negative labeled score
        rows (one seeded negative per positive).  For tables over the full
        score distribution, run the legs at ``return_topk=len(corpus)``
        first; top-k lists sample only its upper tail."""
        all_scores: dict[str, np.ndarray] = {}
        transformed: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        for system, rl in results.items():
            t = transform_scores(rl, normalization or "none")
            ids, scores = t.ids.cpu().numpy(), t.scores.cpu().numpy()
            transformed[system] = (ids, scores)
            all_scores[system] = scores[ids != PAD_ID]

        sizes = tuple(num_points) + (len(self.corpus),)
        distributions = {
            n_pts: {
                system: build_percentile_distribution(scores, num_points=n_pts)
                for system, scores in all_scores.items()
            }
            for n_pts in sizes
        }

        labeled = []
        if labels is not None:
            random.seed(seed)
            all_ids = list(self.corpus.keys())
            for qi, pos in enumerate(labels):
                pos_set = set(pos)
                pool = [p for p in all_ids if p not in pos_set]
                negs = random.sample(pool, k=min(len(pos), len(pool)))
                for label, pids in (("positive", pos), ("negative", negs)):
                    for pid in pids:
                        if pid not in self.id2idx:
                            continue
                        internal = self.id2idx[pid]
                        row = {"label": label}
                        for system, (ids, scores) in transformed.items():
                            hits = np.nonzero(ids[qi] == internal)[0]
                            row[system] = float(scores[qi, hits[0]]) if len(hits) else 0.0
                        labeled.append(row)

        if output_dir is not None:
            os.makedirs(output_dir, exist_ok=True)
            name = normalization or "raw"
            for n_pts, tables in distributions.items():
                rows = [{s: tables[s][i] for s in tables} for i in range(len(next(iter(tables.values()))))]
                write_metrics_csv(
                    os.path.join(output_dir, f"score_distributions_{name}_{tag}_{round(n_pts / 1e3)}k.csv"), rows
                )
            if labeled:
                write_metrics_csv(os.path.join(output_dir, f"labeled_scores_{name}_{tag}.csv"), labeled)
        return {"all_scores": all_scores, "distributions": distributions, "labeled": labeled}

    def to_external_ids(self, ranked: RankedLists) -> list[list[int]]:
        return ranked.remap_ids(self.idx2id).id_lists()

    def labels_to_internal(self, labels: Sequence[Sequence[int]]) -> list[list[int]]:
        return [[self.id2idx[i] for i in row if i in self.id2idx] for row in labels]

    def evaluate(
        self,
        ranked: RankedLists,
        labels: Sequence[Sequence[int]],
        external_labels: bool = True,
        print2console: bool = False,
        logger=None,
    ) -> dict:
        preds = self.to_external_ids(ranked) if external_labels else ranked.id_lists()
        return run_evaluation(preds, labels, print2console=print2console, logger=logger)
