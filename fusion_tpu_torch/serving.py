"""Serving: one device-resident hybrid searcher.

``HybridSearcher`` owns prebuilt indexes for any subset of BM25, DPR, SPLADE
and ColBERT, all resident on one device, and answers a query batch with one
per-batch device function: three query-encoder forwards → score every leg →
fuse → top-k.  The host tokenizes and reads back [Q, k].

Two serving forms:

  * default — BM25 as a dense-impact matmul, DPR and SPLADE as exact MIPS
    over their corpus matrices (bf16, or per-row int8 with ``int8_corpus``),
    ColBERT through the MaxSim kernel;
  * ``scale_mode`` — the corpus-scale forms: BM25 and SPLADE as impact-ordered
    inverted indexes (SPLADE as the chunked index behind the scatter kernel
    once the corpus spans ≥ 2^20 docs, or on request), with SPLADE queries
    pruned to ``splade_query_terms`` and every candidate rescored exactly
    against its stored doc vector; the int8 DPR corpus goes through the
    fused binned-top-k kernel at the same size (``dense_impl``).

The offline ``build()`` encodes the corpus once per system.  Compressed /
PLAID ColBERT, the cross-encoder rerank, int8 query encoders, percentile
normalizations and index persistence are later slices of the port
(ROADMAP.md Queue 1); asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import ClassVar, Mapping, Sequence

import numpy as np
import torch

from fusion_tpu_torch.core.ranked import RankedLists, ranked_from_scores
from fusion_tpu_torch.fusion.aggregator import FUSION_METHODS, NORMALIZATIONS, Aggregator
from fusion_tpu_torch.index.dense_quant import (
    QuantizedDenseIndex,
    quantize_dense_index,
    quantized_dense_search,
)
from fusion_tpu_torch.index.inverted import (
    CAP_SAFE_DF_RATIO,
    ImpactCapTruncationWarning,
    activations_to_query_terms,
    impact_search,
    sparse_to_chunked_impact_index,
    sparse_to_impact_index,
)
from fusion_tpu_torch.index.sparse import build_rescore_store, sparse_rescore
from fusion_tpu_torch.models.bm25 import BM25Index
from fusion_tpu_torch.models.encoder import token_tensors
from fusion_tpu_torch.models.heads import l2_normalize
from fusion_tpu_torch.ops.dense_topk import fused_dense_topk
from fusion_tpu_torch.ops.maxsim import maxsim_search_tm
from fusion_tpu_torch.ops.mips import dense_search, matmul_f32
from fusion_tpu_torch.ops.scatter_score import MAX_POSTING_WIDTH, scatter_impact_search

# build() options of the JAX searcher that this port does not serve yet,
# with the ROADMAP.md Queue 1 item that brings each
_NOT_PORTED = {
    "colbert_compressed": "the compressed ColBERT index (Slice B, item 13: the next slice of the port)",
    "colbert_plaid": "PLAID search (Slice B, item 13: the next slice of the port)",
    "cross_encoder": "the cross-encoder rerank (Slice A, item 9)",
    "encoders_int8": "int8 query encoders (Slice C, item 17)",
}
_PERCENTILE_NORMALIZATIONS = ("percentile-rank", "normal-curve-equivalent")


def _quantize_impacts(impacts: torch.Tensor) -> QuantizedDenseIndex:
    """Per-doc int8 quantization of the [V+1, N] BM25 impact matrix, stored
    doc-major [N, V+1] for ``quantized_dense_search``."""
    return quantize_dense_index(impacts.T, similarity="dot_score")


def _scatter_plan(n: int, impact_cap: int, query_terms: int, docs_per_chunk: int):
    """(docs_per_chunk, cap_per_chunk) of the scatter layout: the chunk width
    shrinks until the equal-mass per-chunk cap fits the posting-width budget
    (smaller chunks → more chunks → a smaller per-chunk cap); None if no
    width from ``docs_per_chunk`` down to 2048 fits."""
    dpc = docs_per_chunk
    while dpc >= 2048:
        capc = max(-(-impact_cap // -(-n // dpc)), 4)
        if query_terms * capc <= MAX_POSTING_WIDTH:
            return dpc, capc
        dpc //= 2
    return None


@dataclass
class HybridSearcher:
    """Serve hybrid retrieval over device-resident indexes.

    systems: any of
      'bm25'    — BM25Index + [V+1, N] dense impacts (bf16 or int8), or an
                  ImpactIndex in scale mode
      'dpr'     — BiEncoder(head='dense') + corpus matrix (bf16 or int8)
      'splade'  — BiEncoder(head='splade') + corpus matrix (bf16 or int8), or
                  in scale mode an ImpactIndex / ChunkedImpactIndex with an
                  exact-rescore store
      'colbert' — ColBERT + TokenIndex
    """

    corpus_ids: np.ndarray
    bm25: BM25Index | None = None
    bm25_impacts: torch.Tensor | QuantizedDenseIndex | None = None
    bm25_impact_index: object | None = None  # ImpactIndex (scale mode)
    dense_model: object | None = None
    dense_corpus: torch.Tensor | QuantizedDenseIndex | None = None
    # 'auto' | 'exact' | 'fused': 'fused' sends the int8 DPR corpus through
    # the binned top-k kernel (ops/dense_topk.py); 'auto' takes it on the
    # card once the corpus is large enough (FUSED_DENSE_MIN_DOCS) that bin
    # collisions cost negligible recall
    dense_impl: str = "auto"
    dense_n_docs: int | None = None  # the real row count once rows are padded
    splade_model: object | None = None
    splade_corpus: torch.Tensor | QuantizedDenseIndex | None = None
    splade_impact_index: object | None = None  # ImpactIndex (scale mode)
    splade_scatter_index: object | None = None  # ChunkedImpactIndex (scale mode)
    splade_query_terms: int = 64
    # two-stage exact rescore over the capped SPLADE forms: the impact /
    # scatter index only generates ``splade_rescore_depth`` candidates and
    # each is rescored against its full stored doc vector.  0 disables.
    splade_rescore_store: object | None = None
    splade_rescore_depth: int = 0
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
    _cap_guard_warned: bool = False

    # below this, bin collisions in the binned kernels' 16-doc argmax pack
    # cost real top-k recall (loss ~ k^2 / (2 * N/16))
    FUSED_DENSE_MIN_DOCS: ClassVar[int] = 1 << 20

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
        impact_cap: int = 4096,
        splade_prune_topk: int = 128,
        splade_query_terms: int = 64,
        splade_impl: str = "auto",
        splade_rescore_depth: int | None = None,
        scatter_docs_per_chunk: int = 16_384,
        dense_impl: str = "auto",
        encoders_int8: bool = False,
    ) -> "HybridSearcher":
        """Encode/build every requested index once, on ``device``.  Each
        model must already live on ``device``.

        ``scale_mode`` switches BM25 and SPLADE to the corpus-scale inverted
        forms (``impact_cap`` postings per term; SPLADE docs pruned to
        ``splade_prune_topk`` terms, queries to ``splade_query_terms``).
        ``splade_impl`` is 'auto' (the scatter form at ≥ 2^20 docs), 'scatter'
        or 'impact'; the rescore depth defaults to 512 there.
        ``int8_corpus`` stores the DPR / SPLADE corpus matrices (and, outside
        scale mode, the BM25 impacts) as per-row symmetric int8."""
        requested = dict(
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
        if splade_impl not in ("auto", "scatter", "impact"):
            raise ValueError(f"splade_impl must be 'auto', 'scatter' or 'impact', got {splade_impl!r}")
        if dense_impl not in ("auto", "exact", "fused"):
            raise ValueError(f"dense_impl must be 'auto', 'exact' or 'fused', got {dense_impl!r}")
        device = torch.device(device)
        for model in (dense_model, splade_model, colbert_model):
            if model is not None and model.device != device:
                raise ValueError(f"model lives on {model.device}, the searcher on {device}")

        documents = list(corpus.values())
        out = cls(
            corpus_ids=np.asarray(list(corpus.keys()), dtype=np.int64),
            dense_model=dense_model,
            dense_impl=dense_impl,
            splade_model=splade_model,
            splade_query_terms=splade_query_terms,
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
            if scale_mode:
                out.bm25_impact_index = out.bm25.to_impact_index(cap=impact_cap)
            else:
                out.bm25_impacts = out.bm25.build_dense_impacts()
                if int8_corpus:
                    out.bm25_impacts = _quantize_impacts(out.bm25_impacts)
        if dense_model is not None:
            embs = dense_model.encode(
                documents, query_mode=False, batch_size=batch_size, sort_by_length=True
            ).to(torch.bfloat16)
            if int8_corpus:
                embs = quantize_dense_index(embs, similarity=dense_model.similarity)
            out.dense_corpus = embs
        if splade_model is not None:
            if scale_mode:
                out._build_splade_scale(
                    documents, batch_size, impact_cap, splade_prune_topk, splade_impl,
                    splade_rescore_depth, scatter_docs_per_chunk,
                )
            else:
                acts = splade_model.encode(
                    documents, query_mode=False, batch_size=batch_size, sort_by_length=True
                ).to(torch.bfloat16)
                if int8_corpus:
                    acts = quantize_dense_index(acts, similarity=splade_model.similarity)
                out.splade_corpus = acts
        if colbert_model is not None:
            out.colbert_index = colbert_model.index(documents, batch_size=batch_size)
            out.colbert_index.prepared()  # the search layout, once, at build
        return out

    def _build_splade_scale(
        self, documents, batch_size, impact_cap, prune_topk, splade_impl, rescore_depth,
        docs_per_chunk,
    ) -> None:
        """SPLADE's scale-mode index: the pruned fixed-K doc vectors, the
        capped impact form that generates candidates (scatter or flat), and
        the store the candidates are rescored against."""
        sp = self.splade_model.build_sparse_index(
            documents, prune_topk=prune_topk, batch_size=batch_size
        )
        n = len(documents)
        # the scatter form's per-chunk caps only make sense once the corpus
        # spans many chunks: 'auto' takes it at ≥ 2^20 docs
        use_scatter = splade_impl == "scatter" or (
            splade_impl == "auto" and n >= self.FUSED_DENSE_MIN_DOCS
        )
        plan = (
            _scatter_plan(n, impact_cap, self.splade_query_terms, docs_per_chunk)
            if use_scatter else None
        )
        if use_scatter and plan is None and splade_impl == "scatter":
            raise ValueError(
                "splade_impl='scatter' cannot fit query_terms*cap_per_chunk <= "
                f"{MAX_POSTING_WIDTH} at any chunk width for n_docs={n}, "
                f"impact_cap={impact_cap}; use splade_impl='impact' for small corpora"
            )
        if plan is not None:
            self.splade_scatter_index = sparse_to_chunked_impact_index(
                sp, docs_per_chunk=plan[0], cap_per_chunk=plan[1]
            )
        else:
            self.splade_impact_index = sparse_to_impact_index(sp, cap=impact_cap)
        # the two-stage exact rescore is the scale-mode default: the capped
        # candidate forms alone lose recall with every posting they drop
        if rescore_depth is None:
            rescore_depth = 512
        if rescore_depth:
            self.splade_rescore_store = build_rescore_store(sp)
            self.splade_rescore_depth = int(rescore_depth)

    @property
    def _splade_active(self) -> bool:
        return self.splade_model is not None and (
            self.splade_corpus is not None
            or self.splade_impact_index is not None
            or self.splade_scatter_index is not None
        )

    @property
    def active_systems(self) -> list[str]:
        systems = []
        if self.bm25 is not None:
            systems.append("bm25")
        if self.dense_corpus is not None:
            systems.append("dpr")
        if self._splade_active:
            systems.append("splade")
        if self.colbert_index is not None:
            systems.append("colbert")
        return systems

    def save_indexes(self, path: str) -> None:
        raise NotImplementedError("index persistence is not ported to fusion_tpu_torch yet")

    def load_indexes(self, path: str) -> "HybridSearcher":
        raise NotImplementedError("index persistence is not ported to fusion_tpu_torch yet")

    def _dense_fused_active(self) -> bool:
        """The DPR leg goes through the binned kernel: an int8 corpus, and
        either 'fused' or 'auto' on the card at ≥ FUSED_DENSE_MIN_DOCS."""
        if not isinstance(self.dense_corpus, QuantizedDenseIndex):
            return False
        if self.dense_impl == "fused":
            return True
        n = self.dense_n_docs or self.dense_corpus.num_docs
        return (
            self.dense_impl == "auto"
            and self.device.type == "cuda"
            and n >= self.FUSED_DENSE_MIN_DOCS
        )

    def _ensure_padded_dense(self, doc_block: int = 2048) -> None:
        """Pad the int8 corpus rows to a ``doc_block`` multiple ONCE (a pad per
        batch would copy the whole corpus).  Pad rows carry scale 0 and are
        masked by both the binned kernel (via ``n_docs``) and the exact path."""
        rows = self.dense_corpus.values.shape[0]
        if self.dense_n_docs is None:
            self.dense_n_docs = rows
        want = -(-rows // doc_block) * doc_block
        if want != rows:
            pad = torch.nn.functional.pad
            self.dense_corpus = self.dense_corpus._replace(
                values=pad(self.dense_corpus.values, (0, 0, 0, want - rows)),
                scales=pad(self.dense_corpus.scales, (0, want - rows)),
            )

    # ------------------------------------------------------------------
    def _check_impact_cap_guard(self, q_terms: np.ndarray, frac_threshold: float = 0.1) -> None:
        """Query-time cap guard: warns once per searcher when more than
        ``frac_threshold`` of real BM25 query terms hit posting lists capped
        past CAP_SAFE_DF_RATIO·cap (the signature of unpreprocessed queries
        against a capped index)."""
        idx = self.bm25_impact_index
        if self._cap_guard_warned or idx is None:
            return
        frac = idx.unsafe_query_term_frac(q_terms)
        if frac > frac_threshold:
            warnings.warn(
                f"{frac:.0%} of query terms hit posting lists truncated past "
                f"df > {CAP_SAFE_DF_RATIO}*cap (cap {idx.cap}): recall will be badly "
                "degraded. Preprocess queries (strip stopwords), raise impact_cap, or "
                "serve the exact forms.",
                ImpactCapTruncationWarning,
                stacklevel=4,
            )
            self._cap_guard_warned = True

    def _prepare_inputs(self, chunk: Sequence[str]) -> dict[str, torch.Tensor]:
        """Host side of a batch: tokenize queries for every active system and
        upload the token arrays."""
        inputs: dict[str, torch.Tensor] = {}
        if self.bm25 is not None:
            bm25_chunk = (
                self.bm25_preprocess(chunk) if self.bm25_preprocess is not None else chunk
            )
            terms, weights = self.bm25.encode_queries_np(bm25_chunk)
            self._check_impact_cap_guard(terms)
            inputs["bm25_terms"] = torch.as_tensor(terms.astype(np.int64), device=self.device)
            inputs["bm25_weights"] = torch.as_tensor(weights, device=self.device)
        # each encoder tokenizes with ITS OWN text encoder (checkpoints may
        # differ in tokenizer, prefix or max length)
        dense_te = None
        if self.dense_corpus is not None:
            dense_te = self.dense_model.text_encoder
            ids, mask = dense_te.encode(chunk, query_mode=True)
            inputs["q_ids"], inputs["q_mask"] = token_tensors(ids, mask, self.device)
        if self._splade_active:
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

    def _bm25_leg(self, inputs: dict[str, torch.Tensor]) -> RankedLists:
        terms, weights = inputs["bm25_terms"], inputs["bm25_weights"]
        topk = min(self.topk, self.bm25.n_docs)
        if self.bm25_impact_index is not None:
            return impact_search(terms, weights.to(torch.float32), self.bm25_impact_index, k=topk)
        imp = self.bm25_impacts
        if isinstance(imp, QuantizedDenseIndex):
            # the doc-major int8 form: an f32 [Q, V+1] query matrix
            qmat = torch.zeros((terms.shape[0], imp.values.shape[1]), device=self.device)
            qmat.scatter_add_(1, terms, weights.to(torch.float32))
            return quantized_dense_search(qmat, imp, k=topk)
        qmat = torch.zeros((terms.shape[0], imp.shape[0]), dtype=imp.dtype, device=self.device)
        qmat.scatter_add_(1, terms, weights.to(imp.dtype))
        return ranked_from_scores(matmul_f32(qmat, imp), topk)

    def _dpr_leg(self, inputs: dict[str, torch.Tensor]) -> RankedLists:
        q = self.dense_model.embed_tokens(inputs["q_ids"], inputs["q_mask"])
        dc = self.dense_corpus
        if self._dense_fused_active():
            self._ensure_padded_dense()
            return fused_dense_topk(
                q.to(torch.float32), self.dense_corpus,
                k=min(self.topk, self.dense_n_docs), n_docs=self.dense_n_docs,
            )
        if isinstance(dc, QuantizedDenseIndex):
            return quantized_dense_search(q.to(torch.float32), dc, k=self.topk)
        return dense_search(
            q.to(torch.bfloat16), dc, k=self.topk, similarity=self.dense_model.similarity
        )

    def _splade_leg(self, inputs: dict[str, torch.Tensor]) -> RankedLists:
        q = self.splade_model.embed_tokens(inputs["sp_ids"], inputs["sp_mask"])
        sc = self.splade_corpus
        if sc is not None:
            if isinstance(sc, QuantizedDenseIndex):
                return quantized_dense_search(q.to(torch.float32), sc, k=self.topk)
            return dense_search(
                q.to(torch.bfloat16), sc, k=self.topk, similarity=self.splade_model.similarity
            )
        q = q.to(torch.float32)
        if self.splade_model.similarity == "cos_sim":
            q = l2_normalize(q)
        q_terms, q_weights = activations_to_query_terms(q, self.splade_query_terms)
        rescore = self.splade_rescore_store is not None and self.splade_rescore_depth > 0
        # with the rescore, stage 1 only generates candidates at its depth
        k1 = self.splade_rescore_depth if rescore else self.topk
        if self.splade_scatter_index is not None:
            index = self.splade_scatter_index
            ranked = scatter_impact_search(q_terms, q_weights, index, k=min(k1, index.n_docs))
        else:
            index = self.splade_impact_index
            # clamp to the flattened posting width (the top-k ceiling)
            width = q_terms.shape[1] * index.post_doc.shape[1]
            ranked = impact_search(q_terms, q_weights, index, k=min(k1, index.n_docs, width))
        if rescore:
            ranked = sparse_rescore(
                q, ranked.ids, self.splade_rescore_store, k=min(self.topk, ranked.ids.shape[1])
            )
        return ranked

    def _search_batch(self, inputs: dict[str, torch.Tensor]) -> dict[str, RankedLists]:
        """The per-batch device function: encode the queries and score every
        leg; returns the per-system ranked lists (internal ids)."""
        results: dict[str, RankedLists] = {}
        if self.bm25 is not None:
            results["bm25"] = self._bm25_leg(inputs)
        if self.dense_corpus is not None:
            results["dpr"] = self._dpr_leg(inputs)
        if self._splade_active:
            results["splade"] = self._splade_leg(inputs)
        if self.colbert_index is not None:
            q_tok = self.colbert_model.embed_tokens(inputs["cb_ids"], inputs["cb_mask"])
            corpus_tm, doc_valid = self.colbert_index.prepared()
            results["colbert"] = maxsim_search_tm(
                q_tok.to(torch.bfloat16), inputs["cb_mask"].to(torch.float32),
                corpus_tm, doc_valid, k=self.topk,
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
