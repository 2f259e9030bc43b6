"""Serving: one device-resident hybrid searcher.

``HybridSearcher`` owns prebuilt indexes for any subset of BM25, DPR, SPLADE
and ColBERT, all resident on one device, and answers a query batch with one
per-batch device function: three query-encoder forwards → score every leg
(BM25 as a dense-impact matmul, DPR and SPLADE as exact MIPS, ColBERT through
the MaxSim kernel) → fuse → top-k.  The host tokenizes and reads back [Q, k].

The offline ``build()`` encodes the corpus once per system.  Scale mode, the
int8 corpus, compressed/PLAID ColBERT, the cross-encoder rerank, int8 query
encoders, percentile normalizations and index persistence are later slices
of the port (ROADMAP.md Queue 1); asking for them raises
``NotImplementedError``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np
import torch

from fusion_tpu_torch.core.ranked import RankedLists, ranked_from_scores
from fusion_tpu_torch.fusion.aggregator import FUSION_METHODS, NORMALIZATIONS, Aggregator
from fusion_tpu_torch.models.bm25 import BM25Index
from fusion_tpu_torch.models.encoder import token_tensors
from fusion_tpu_torch.ops.maxsim import maxsim_search_tm
from fusion_tpu_torch.ops.mips import dense_search, matmul_f32

# build() options of the JAX searcher that this port does not serve yet,
# with the ROADMAP.md Queue 1 item that brings each
_NOT_PORTED = {
    "scale_mode": "the scale-mode index forms (Slice B, item 14)",
    "int8_corpus": "the int8 corpus matrices (Slice B, item 11)",
    "colbert_compressed": "the compressed ColBERT index (Slice B, item 13)",
    "colbert_plaid": "PLAID search (Slice B, item 13)",
    "cross_encoder": "the cross-encoder rerank (Slice A, item 9)",
    "encoders_int8": "int8 query encoders (Slice C, item 17)",
}
_PERCENTILE_NORMALIZATIONS = ("percentile-rank", "normal-curve-equivalent")


@dataclass
class HybridSearcher:
    """Serve hybrid retrieval over device-resident indexes.

    systems: any of
      'bm25'    — BM25Index + [V+1, N] dense impact matrix
      'dpr'     — BiEncoder(head='dense') + corpus embedding matrix
      'splade'  — BiEncoder(head='splade') + corpus activation matrix
      'colbert' — ColBERT + TokenIndex
    """

    corpus_ids: np.ndarray
    bm25: BM25Index | None = None
    bm25_impacts: torch.Tensor | None = None
    dense_model: object | None = None
    dense_corpus: torch.Tensor | None = None
    splade_model: object | None = None
    splade_corpus: torch.Tensor | None = None
    colbert_model: object | None = None
    colbert_index: object | None = None
    fusion_method: str = "rrf"
    normalization: str | None = None
    linear_weights: Mapping[str, float] | None = None
    topk: int = 1000
    # applied to queries for the lexical leg only (the neural legs take the
    # raw text)
    bm25_preprocess: object | None = None
    device: torch.device = torch.device("cpu")

    # ------------------------------------------------------------------
    @classmethod
    def build(
        cls,
        corpus: Mapping[int, str],
        bm25_docs: Sequence[str] | None = None,
        dense_model=None,
        splade_model=None,
        colbert_model=None,
        batch_size: int = 64,
        k1: float = 2.5,
        b: float = 0.2,
        fusion_method: str = "rrf",
        normalization: str | None = None,
        linear_weights: Mapping[str, float] | None = None,
        topk: int = 1000,
        bm25_preprocess=None,
        device="cpu",
        cross_encoder=None,
        colbert_compressed: bool = False,
        colbert_plaid: bool = False,
        int8_corpus: bool = False,
        scale_mode: bool = False,
        encoders_int8: bool = False,
    ) -> "HybridSearcher":
        """Encode/build every requested index once, on ``device``.  Each
        model must already live on ``device``."""
        requested = dict(
            scale_mode=scale_mode, int8_corpus=int8_corpus,
            colbert_compressed=colbert_compressed, colbert_plaid=colbert_plaid,
            cross_encoder=cross_encoder is not None, encoders_int8=encoders_int8,
        )
        for option, wanted in requested.items():
            if wanted:
                raise NotImplementedError(
                    f"{option}: {_NOT_PORTED[option]} is not ported to fusion_tpu_torch yet"
                )
        if fusion_method not in FUSION_METHODS:
            raise ValueError(f"fusion_method must be one of {FUSION_METHODS}")
        if normalization not in (None, *NORMALIZATIONS):
            raise ValueError(f"normalization must be one of {NORMALIZATIONS}")
        if fusion_method == "nsf" and normalization in _PERCENTILE_NORMALIZATIONS:
            raise NotImplementedError(
                f"normalization={normalization!r} needs per-system quantile tables "
                "(build_percentile_distributions), which are not ported to "
                "fusion_tpu_torch yet (Slice A, item 8)"
            )
        device = torch.device(device)
        for model in (dense_model, splade_model, colbert_model):
            if model is not None and model.device != device:
                raise ValueError(f"model lives on {model.device}, the searcher on {device}")

        documents = list(corpus.values())
        out = cls(
            corpus_ids=np.asarray(list(corpus.keys()), dtype=np.int64),
            dense_model=dense_model,
            splade_model=splade_model,
            colbert_model=colbert_model,
            fusion_method=fusion_method,
            normalization=normalization,
            linear_weights=linear_weights,
            topk=topk,
            bm25_preprocess=bm25_preprocess,
            device=device,
        )
        if bm25_docs is not None:
            out.bm25 = BM25Index.build(bm25_docs, k1=k1, b=b, device=device)
            out.bm25_impacts = out.bm25.build_dense_impacts()
        if dense_model is not None:
            out.dense_corpus = dense_model.encode(
                documents, query_mode=False, batch_size=batch_size, sort_by_length=True
            ).to(torch.bfloat16)
        if splade_model is not None:
            out.splade_corpus = splade_model.encode(
                documents, query_mode=False, batch_size=batch_size, sort_by_length=True
            ).to(torch.bfloat16)
        if colbert_model is not None:
            out.colbert_index = colbert_model.index(documents, batch_size=batch_size)
            out.colbert_index.prepared()  # the search layout, once, at build
        return out

    @property
    def active_systems(self) -> list[str]:
        systems = []
        if self.bm25 is not None:
            systems.append("bm25")
        if self.dense_corpus is not None:
            systems.append("dpr")
        if self.splade_corpus is not None:
            systems.append("splade")
        if self.colbert_index is not None:
            systems.append("colbert")
        return systems

    def save_indexes(self, path: str) -> None:
        raise NotImplementedError("index persistence is not ported to fusion_tpu_torch yet")

    def load_indexes(self, path: str) -> "HybridSearcher":
        raise NotImplementedError("index persistence is not ported to fusion_tpu_torch yet")

    # ------------------------------------------------------------------
    def _prepare_inputs(self, chunk: Sequence[str]) -> dict[str, torch.Tensor]:
        """Host side of a batch: tokenize queries for every active system and
        upload the token arrays."""
        inputs: dict[str, torch.Tensor] = {}
        if self.bm25 is not None:
            bm25_chunk = (
                self.bm25_preprocess(chunk) if self.bm25_preprocess is not None else chunk
            )
            terms, weights = self.bm25.encode_queries_np(bm25_chunk)
            inputs["bm25_terms"] = torch.as_tensor(terms.astype(np.int64), device=self.device)
            inputs["bm25_weights"] = torch.as_tensor(weights, device=self.device)
        # each encoder tokenizes with ITS OWN text encoder (checkpoints may
        # differ in tokenizer, prefix or max length)
        dense_te = None
        if self.dense_corpus is not None:
            dense_te = self.dense_model.text_encoder
            ids, mask = dense_te.encode(chunk, query_mode=True)
            inputs["q_ids"], inputs["q_mask"] = token_tensors(ids, mask, self.device)
        if self.splade_corpus is not None:
            te = self.splade_model.text_encoder
            if te is dense_te:
                inputs["sp_ids"], inputs["sp_mask"] = inputs["q_ids"], inputs["q_mask"]
            else:
                ids, mask = te.encode(chunk, query_mode=True)
                inputs["sp_ids"], inputs["sp_mask"] = token_tensors(ids, mask, self.device)
        if self.colbert_index is not None:
            ids, mask = self.colbert_model.text_encoder.encode(chunk, query_mode=True)
            inputs["cb_ids"], inputs["cb_mask"] = token_tensors(ids, mask, self.device)
        return inputs

    def _search_batch(self, inputs: dict[str, torch.Tensor]) -> dict[str, RankedLists]:
        """The per-batch device function: encode the queries and score every
        leg; returns the per-system ranked lists (internal ids)."""
        topk = self.topk
        results: dict[str, RankedLists] = {}
        if self.bm25 is not None:
            imp = self.bm25_impacts
            terms = inputs["bm25_terms"]
            qmat = torch.zeros((terms.shape[0], imp.shape[0]), dtype=imp.dtype, device=self.device)
            qmat.scatter_add_(1, terms, inputs["bm25_weights"].to(imp.dtype))
            results["bm25"] = ranked_from_scores(
                matmul_f32(qmat, imp), min(topk, self.bm25.n_docs)
            )
        if self.dense_corpus is not None:
            q = self.dense_model.embed_tokens(inputs["q_ids"], inputs["q_mask"])
            results["dpr"] = dense_search(
                q.to(torch.bfloat16), self.dense_corpus, k=topk,
                similarity=self.dense_model.similarity,
            )
        if self.splade_corpus is not None:
            q = self.splade_model.embed_tokens(inputs["sp_ids"], inputs["sp_mask"])
            results["splade"] = dense_search(
                q.to(torch.bfloat16), self.splade_corpus, k=topk,
                similarity=self.splade_model.similarity,
            )
        if self.colbert_index is not None:
            q_tok = self.colbert_model.embed_tokens(inputs["cb_ids"], inputs["cb_mask"])
            corpus_tm, doc_valid = self.colbert_index.prepared()
            results["colbert"] = maxsim_search_tm(
                q_tok.to(torch.bfloat16), inputs["cb_mask"].to(torch.float32),
                corpus_tm, doc_valid, k=topk,
            )
        return results

    def _fuse(self, results: dict[str, RankedLists]) -> RankedLists:
        if len(results) == 1:
            return next(iter(results.values()))
        weights = self.linear_weights or {s: 1.0 / len(results) for s in results}
        return Aggregator.fuse(
            results,
            method=self.fusion_method,
            normalization=self.normalization,
            linear_weights=weights if self.fusion_method == "nsf" else None,
            return_topk=self.topk,
        )

    def _batches(self, queries: Sequence[str], batch_size: int):
        """(inputs, real row count) per batch; the tail batch is padded with
        "" to the batch size whenever there is more than one batch."""
        for start in range(0, len(queries), batch_size):
            chunk = list(queries[start : start + batch_size])
            real = len(chunk)
            while len(chunk) < batch_size and len(queries) > batch_size:
                chunk.append("")
            yield self._prepare_inputs(chunk), real

    def search(
        self, queries: Sequence[str], batch_size: int = 32, external_ids: bool = True
    ) -> tuple[RankedLists, float]:
        """Batched hybrid search. Returns (ranked lists on the host, ms/query)."""
        out_ids, out_scores = [], []

        def fetch(pending):
            ranked, real = pending
            out_ids.append(ranked.ids[:real].cpu())
            out_scores.append(ranked.scores[:real].cpu())

        t0 = time.perf_counter()
        # one-deep pipeline: batch i is queued on the device before batch
        # i-1 is read back, so host tokenization overlaps device work
        pending = None
        for inputs, real in self._batches(queries, batch_size):
            fused = self._fuse(self._search_batch(inputs))
            if pending is not None:
                fetch(pending)
            pending = (fused, real)
        if pending is not None:
            fetch(pending)
        elapsed = time.perf_counter() - t0
        ranked = RankedLists(ids=torch.cat(out_ids), scores=torch.cat(out_scores))
        if external_ids:
            ranked = ranked.remap_ids(self.corpus_ids)
        return ranked, elapsed / max(len(queries), 1) * 1000

    def search_systems(
        self, queries: Sequence[str], batch_size: int = 32, external_ids: bool = True
    ) -> dict[str, RankedLists]:
        """Per-system ranked lists (on the host) with no fusion."""
        parts: dict[str, list[RankedLists]] = {}
        for inputs, real in self._batches(queries, batch_size):
            for system, ranked in self._search_batch(inputs).items():
                parts.setdefault(system, []).append(
                    RankedLists(ranked.ids[:real].cpu(), ranked.scores[:real].cpu())
                )
        results: dict[str, RankedLists] = {}
        for system, batches in parts.items():
            ranked = RankedLists(
                ids=torch.cat([r.ids for r in batches]),
                scores=torch.cat([r.scores for r in batches]),
            )
            results[system] = ranked.remap_ids(self.corpus_ids) if external_ids else ranked
        return results
