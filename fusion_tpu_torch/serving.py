"""Serving: one device-resident hybrid searcher.

``HybridSearcher`` owns prebuilt indexes for any subset of BM25, DPR, SPLADE
and ColBERT, all resident on one device, and answers a query batch with one
per-batch device function: three query-encoder forwards → score every leg →
fuse → top-k.  The host tokenizes and reads back [Q, k].

Two serving forms:

  * default — BM25 as a dense-impact matmul, DPR and SPLADE as exact MIPS
    over their corpus matrices (bf16, or per-row int8 with ``int8_corpus``),
    ColBERT through the MaxSim kernel over its bf16 token matrix;
  * ``scale_mode`` — the corpus-scale forms: BM25 and SPLADE as impact-ordered
    inverted indexes (SPLADE as the chunked index behind the scatter kernel
    once the corpus spans ≥ 2^20 docs, or on request), with SPLADE queries
    pruned to ``splade_query_terms`` and every candidate rescored exactly
    against its stored doc vector; the int8 DPR corpus goes through the
    fused binned-top-k kernel at the same size (``dense_impl``).

ColBERT at corpus scale is the residual-compressed token index
(``colbert_compressed``), searched exhaustively by block decompression into
the MaxSim kernel, or with ``colbert_plaid`` by PLAID: centroid probe → IVF
candidates → exact rescore of the candidates' rows, which the gather kernel
fetches.

With a ``cross_encoder`` (``CrossEncoder`` or ``T5CrossEncoder``) the
searcher adds the final rerank stage: the fused head of each query
(``rerank_depth`` candidates) is scored pair by pair and re-sorted above the
untouched tail (``rerank_head_merge``), in one of four forms — packed (the
default: pairs packed into fixed-width rows, planned on the host from the
head ids), flat (every pair padded to the full doc width), the flat
two-stage cascade (``rerank_cascade``: a truncated pass over every
candidate, a full-width pass over the kept ones) or length-bucketed
(``rerank_buckets``: each pair padded to the smallest rung of a doc-width
ladder that holds it).  ``quantize_encoders`` and ``set_encoder_attention``
swap the query encoders for their int8 or other-attention views.

The offline ``build()`` encodes the corpus once per system;
``save_indexes`` writes every index to one directory in the JAX package's
format and ``load_indexes`` serves such a directory, whichever package wrote
it.  NSF's percentile normalizations read per-system quantile tables
(``build_percentile_distributions``, or a saved directory's).  The public
methods take the JAX searcher's parameters in its order; ``use_pallas`` is
checked and dropped (the port picks its kernels by device).
"""

from __future__ import annotations

import os
import time
import warnings
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import ClassVar, Mapping, Sequence

import numpy as np
import torch

from fusion_tpu_torch.core.device import check_use_pallas, resolve_device
from fusion_tpu_torch.core.ranked import RankedLists, ranked_from_scores
from fusion_tpu_torch.fusion.aggregator import (
    FUSION_METHODS,
    NORMALIZATIONS,
    Aggregator,
    build_percentile_distribution,
)
from fusion_tpu_torch.index.compression import CompressedTokenIndex, maxsim_search_compressed
from fusion_tpu_torch.index.dense_quant import (
    QuantizedDenseIndex,
    quantize_dense_index,
    quantized_dense_search,
)
from fusion_tpu_torch.index.inverted import (
    CAP_SAFE_DF_RATIO,
    ChunkedImpactIndex,
    ImpactCapTruncationWarning,
    ImpactIndex,
    activations_to_query_terms,
    impact_search,
    sparse_to_chunked_impact_index,
    sparse_to_impact_index,
)
from fusion_tpu_torch.index.plaid import IVFIndex, build_ivf, plaid_search
from fusion_tpu_torch.index.sparse import SpladeRescoreStore, build_rescore_store, sparse_rescore
from fusion_tpu_torch.models.bm25 import BM25Index
from fusion_tpu_torch.models.colbert import TokenIndex
from fusion_tpu_torch.models.encoder import token_tensors
from fusion_tpu_torch.models.heads import l2_normalize
from fusion_tpu_torch.ops.dense_topk import fused_dense_topk
from fusion_tpu_torch.ops.maxsim import maxsim_search_tm
from fusion_tpu_torch.ops.mips import dense_search, matmul_f32
from fusion_tpu_torch.ops.scatter_score import MAX_POSTING_WIDTH, scatter_impact_search
from fusion_tpu_torch.utils.profiling import span

_PERCENTILE_NORMALIZATIONS = ("percentile-rank", "normal-curve-equivalent")


@contextmanager
def _timed(timings: dict | None, name: str):
    """Record the block's wall seconds under ``name`` (if collecting)."""
    t0 = time.perf_counter()
    yield
    if timings is not None:
        timings[name] = time.perf_counter() - t0


def _save_corpus_matrix(corpus, path: str, name: str) -> None:
    """An int8 corpus as its own directory; a bf16 one as f16 ``.npy``."""
    if isinstance(corpus, QuantizedDenseIndex):
        corpus.save(os.path.join(path, f"{name}_int8"))
    else:
        np.save(os.path.join(path, f"{name}_corpus.npy"), corpus.to(torch.float16).cpu().numpy())


def _load_corpus_matrix(path: str, name: str, device: torch.device):
    if os.path.exists(os.path.join(path, f"{name}_int8", "dense_int8.npz")):
        return QuantizedDenseIndex.load(os.path.join(path, f"{name}_int8"), device=device)
    npy = os.path.join(path, f"{name}_corpus.npy")
    if os.path.exists(npy):
        return torch.from_numpy(np.load(npy)).to(device).to(torch.bfloat16)
    return None


def rerank_head_merge(fused: RankedLists, head_ids: torch.Tensor, logits: torch.Tensor) -> RankedLists:
    """Re-sort the fused head by cross-encoder logits and keep the tail.

    Head scores become sigmoid(logit) (pads -inf), sorted descending with
    ties in head order, then shifted above the row's best tail score so the
    whole row stays descending; the tail beyond the rerank depth is
    unchanged."""
    kr = head_ids.shape[1]
    scores = torch.where(head_ids >= 0, torch.sigmoid(logits.float()), -torch.inf)
    head_scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
    re_ids = torch.gather(head_ids, 1, order)
    tail_ids, tail_scores = fused.ids[:, kr:], fused.scores[:, kr:]
    if tail_scores.shape[1]:
        tail0 = tail_scores[:, :1]
        offset = torch.where(torch.isfinite(tail0), tail0, 0.0) + 1.0
        head_scores = torch.where(torch.isfinite(head_scores), head_scores + offset, head_scores)
    return RankedLists(
        ids=torch.cat([re_ids, tail_ids], dim=1), scores=torch.cat([head_scores, tail_scores], dim=1)
    )


def _check_rerank_options(packed: bool, buckets, cascade) -> None:
    """The JAX searcher's two exclusions between the rerank stages."""
    if cascade is not None and buckets is not None:
        raise ValueError(
            "rerank_cascade and rerank_buckets are mutually exclusive (the bucketed stage would "
            "silently ignore the cascade): configure one"
        )
    if packed and (buckets is not None or cascade is not None):
        raise ValueError(
            "rerank_packed is mutually exclusive with rerank_buckets / rerank_cascade "
            "(the packed stage replaces them as the variable-length strategy): configure one"
        )


class CascadeTruncationWarning(UserWarning):
    """Cascade stage 1 truncates below most documents' evidence reach."""


def _check_cascade_stage1_depth(stage1_tokens: int, doc_lens, p: float = 90.0) -> None:
    """Warn when the cascade's stage 1 cuts docs below the corpus's p90
    token length: a doc whose evidence lies past the cut can miss the
    full-width pass (the JAX package measured an MRR cliff there)."""
    if doc_lens is None or len(doc_lens) == 0:
        return
    p90 = float(np.percentile(np.asarray(doc_lens), p))
    if stage1_tokens < p90:
        warnings.warn(
            f"rerank_cascade stage1_tokens={stage1_tokens} is below the corpus p{p:.0f} doc length "
            f"({p90:.0f} tokens): documents whose evidence sits past the truncation can miss the "
            f"stage-1 cut. Raise stage1_tokens to >= {int(p90)}, raise keep, or use rerank_buckets "
            "(exact).",
            CascadeTruncationWarning,
            stacklevel=3,
        )


def _resolve_cascade(rerank_cascade: tuple, doc_lens, doc_width: int) -> tuple[int, int]:
    """(keep, stage1_tokens) with stage1 0 / None / 'auto' resolved to the
    corpus p90 token length rounded up to a multiple of 16 and clamped to
    the stored doc width (the full width collapses the cascade to one flat
    pass)."""
    keep, stage1 = rerank_cascade
    if stage1 in (None, 0, "auto"):
        if doc_lens is None or len(doc_lens) == 0:
            stage1 = doc_width
        else:
            p90 = float(np.percentile(np.asarray(doc_lens), 90.0))
            stage1 = min(int(-(-p90 // 16) * 16), doc_width)
    return int(keep), int(stage1)


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
      'colbert' — ColBERT + TokenIndex, or a CompressedTokenIndex searched
                  exhaustively, or with an IVFIndex by PLAID
    and, with a cross-encoder, the 'monobert' rerank of the fused head.
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
    colbert_index: object | None = None  # TokenIndex or CompressedTokenIndex
    colbert_ivf: object | None = None  # IVFIndex → PLAID search
    plaid_nprobe: int = 4
    # candidates per query reaching the exact rescore (JAX's measured default)
    plaid_ncand: int = 1024
    # candidates left by the centroid-only prune tier; None = no prune tier
    plaid_ncand_rescore: int | None = None
    # 'gather' reconstructs every candidate token; 'factored' reuses the
    # centroid-score table and reconstructs only the residuals
    plaid_rescore_impl: str = "gather"
    cross_encoder: object | None = None  # CrossEncoder or T5CrossEncoder
    # the corpus's raw cross-encoder tokens on the device, and their host
    # token counts (the packed and bucketed stages' plans)
    ce_doc_tokens: torch.Tensor | None = None
    ce_doc_mask: torch.Tensor | None = None
    ce_doc_lens: np.ndarray | None = None
    rerank_depth: int = 0
    ce_query_length: int = 32
    rerank_chunk: int = 512  # pairs per forward of the flat stage
    # the packed stage (the build default); the flat stage otherwise
    rerank_packed: bool = True
    rerank_row_width: int | None = None  # None: ~1.5x the longest pair
    # the doc-width ladder of the length-bucketed stage (None: not bucketed)
    rerank_buckets: tuple | None = None
    # (keep, stage1_tokens) of the flat two-stage cascade; build() resolves
    # stage1 0 / None / 'auto' to the corpus p90 token length
    rerank_cascade: tuple | None = None
    fusion_method: str = "rrf"
    normalization: str | None = None
    # per-system quantile tables of the percentile normalizations: made by
    # build_percentile_distributions(), read from a saved directory, or
    # assigned from an offline HybridPipeline.analyze_score_distributions run
    percentile_distributions: Mapping[str, np.ndarray] | None = None
    linear_weights: Mapping[str, float] | None = None
    topk: int = 1000
    # applied to queries for the lexical leg only (the neural legs take the
    # raw text)
    bm25_preprocess: object | None = None
    device: torch.device = torch.device("cuda")
    _cap_guard_warned: bool = False
    # seconds per part of the compressed ColBERT build (encode, k-means,
    # compression, IVF)
    build_seconds: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)

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
        cross_encoder=None,
        rerank_depth: int = 100,
        ce_max_doc_tokens: int | None = None,
        colbert_compressed: bool = False,
        colbert_nbits: int = 2,
        batch_size: int = 64,
        k1: float = 2.5,
        b: float = 0.2,
        fusion_method: str = "rrf",
        normalization: str | None = None,
        linear_weights: Mapping[str, float] | None = None,
        topk: int = 1000,
        bm25_preprocess=None,
        int8_corpus: bool = False,
        scale_mode: bool = False,
        impact_cap: int = 4096,
        splade_prune_topk: int = 128,
        splade_query_terms: int = 64,
        splade_impl: str = "auto",
        splade_rescore_depth: int | None = None,
        scatter_docs_per_chunk: int = 16_384,
        colbert_plaid: bool = False,
        plaid_nprobe: int = 4,
        plaid_ncand: int = 1024,
        plaid_ncand_rescore: int | None = None,
        plaid_rescore_impl: str = "gather",
        plaid_gather_impl: str = "auto",
        plaid_topk_impl: str = "approx",
        ivf_cap: int = 1024,
        rerank_buckets: tuple | None = None,
        rerank_cascade: tuple | None = None,
        rerank_packed: bool | None = None,
        rerank_row_width: int | None = None,
        dense_impl: str = "auto",
        encoders_int8: bool = False,
        *,
        device="cuda",
    ) -> "HybridSearcher":
        """Encode/build every requested index once, on ``device``.  Each
        model must already live on ``device``.

        ``scale_mode`` switches BM25 and SPLADE to the corpus-scale inverted
        forms (``impact_cap`` postings per term; SPLADE docs pruned to
        ``splade_prune_topk`` terms, queries to ``splade_query_terms``).
        ``splade_impl`` is 'auto' (the scatter form at ≥ 2^20 docs), 'scatter'
        or 'impact'; the rescore depth defaults to 512 there.
        ``int8_corpus`` stores the DPR / SPLADE corpus matrices (and, outside
        scale mode, the BM25 impacts) as per-row symmetric int8.
        ``colbert_compressed`` stores ColBERT's tokens residual-compressed
        (``colbert_nbits`` per dimension); ``colbert_plaid`` adds the IVF
        (``ivf_cap`` docs per centroid) and serves the leg by PLAID with the
        ``plaid_*`` knobs; ``plaid_gather_impl`` takes only 'auto': the
        candidate-row gather runs the Hopper kernel for an index on the card
        and the plain gather on the CPU.  ``plaid_topk_impl`` ('approx' or
        'exact') is checked and dropped: every PLAID select in the port is
        exact.

        ``cross_encoder`` adds the rerank stage over each query's fused top
        ``rerank_depth``: the corpus is tokenized once into a device matrix
        of raw doc tokens (``ce_max_doc_tokens`` wide).  ``rerank_packed``
        None resolves to the packed stage (rows of ``rerank_row_width``
        tokens) unless ``rerank_buckets`` (a doc-width ladder, such as
        ``aligned_buckets``') or ``rerank_cascade`` ((keep, stage1_tokens),
        stage1 0 resolved to the corpus p90 length) asks for another; False
        serves the flat stage.  ``encoders_int8`` swaps the query encoders
        for their int8 views after the corpus is encoded (``device`` is the
        port's own, keyword-only)."""
        if rerank_packed is None:
            rerank_packed = rerank_buckets is None and rerank_cascade is None
        _check_rerank_options(rerank_packed, rerank_buckets, rerank_cascade)
        if fusion_method not in FUSION_METHODS:
            raise ValueError(f"fusion_method must be one of {FUSION_METHODS}")
        if normalization not in (None, *NORMALIZATIONS):
            raise ValueError(f"normalization must be one of {NORMALIZATIONS}")
        if splade_impl not in ("auto", "scatter", "impact"):
            raise ValueError(f"splade_impl must be 'auto', 'scatter' or 'impact', got {splade_impl!r}")
        if dense_impl not in ("auto", "exact", "fused"):
            raise ValueError(f"dense_impl must be 'auto', 'exact' or 'fused', got {dense_impl!r}")
        if colbert_plaid and not colbert_compressed:
            raise ValueError("colbert_plaid needs colbert_compressed=True: PLAID searches the compressed index")
        if plaid_gather_impl != "auto":
            raise ValueError(
                f"plaid_gather_impl={plaid_gather_impl!r}: the port picks the candidate-row "
                "gather by device ('auto': the Hopper kernel for an index on the card, the plain "
                "gather on the CPU); the JAX package's 'pallas', 'pallas_interpret' and 'xla' "
                "have no counterpart"
            )
        if plaid_topk_impl not in ("approx", "exact"):
            raise ValueError(f"plaid_topk_impl must be 'approx' or 'exact', got {plaid_topk_impl!r}")
        if plaid_rescore_impl not in ("gather", "factored"):
            raise ValueError(f"plaid_rescore_impl must be 'gather' or 'factored', got {plaid_rescore_impl!r}")
        device = resolve_device(device)
        for model in (dense_model, splade_model, colbert_model, cross_encoder):
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
            cross_encoder=cross_encoder,
            rerank_depth=rerank_depth if cross_encoder is not None else 0,
            rerank_packed=rerank_packed,
            rerank_row_width=rerank_row_width,
            plaid_nprobe=plaid_nprobe,
            plaid_ncand=plaid_ncand,
            plaid_ncand_rescore=plaid_ncand_rescore,
            plaid_rescore_impl=plaid_rescore_impl,
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
            out._build_colbert(documents, batch_size, colbert_compressed, colbert_nbits,
                               colbert_plaid, ivf_cap)
        if cross_encoder is not None:
            out.ce_doc_tokens, out.ce_doc_mask, out.ce_doc_lens = cross_encoder.prepare_corpus_tokens(
                documents, max_doc_tokens=ce_max_doc_tokens, return_lens=True
            )
            out.rerank_buckets = rerank_buckets
            if rerank_cascade is not None:
                rerank_cascade = _resolve_cascade(rerank_cascade, out.ce_doc_lens, out.ce_doc_tokens.shape[1])
                _check_cascade_stage1_depth(rerank_cascade[1], out.ce_doc_lens)
            out.rerank_cascade = rerank_cascade
        if encoders_int8:
            # the corpus was encoded by the full-precision forwards above
            out.quantize_encoders()
        return out

    def quantize_encoders(self, mode: str = "int8") -> "HybridSearcher":
        """Swap the query encoders (DPR, SPLADE, ColBERT) for their
        ``quantized`` views; the indexes keep the forwards they were built
        with."""
        for attr in ("dense_model", "splade_model", "colbert_model"):
            model = getattr(self, attr)
            if model is not None:
                setattr(self, attr, model.quantized(mode))
        return self

    def set_encoder_attention(self, impl: str) -> "HybridSearcher":
        """Swap the query encoders for their ``with_attention(impl)`` views:
        the same parameters under another attention form."""
        for attr in ("dense_model", "splade_model", "colbert_model"):
            model = getattr(self, attr)
            if model is not None and hasattr(model, "with_attention"):
                setattr(self, attr, model.with_attention(impl))
        return self

    def _build_colbert(self, documents, batch_size, compressed, nbits, plaid, ivf_cap) -> None:
        """ColBERT's index: the bf16 token matrix, or the compressed index
        (with the IVF for PLAID), timed per part into ``build_seconds``."""
        if not compressed:
            self.colbert_index = self.colbert_model.index(documents, batch_size=batch_size)
            self.colbert_index.prepared()  # the search layout, once, at build
            return
        timings: dict[str, float] = {}
        self.colbert_index = self.colbert_model.index_compressed(
            documents, batch_size=batch_size, nbits=nbits, timings=timings
        )
        if plaid:
            t0 = time.perf_counter()
            index = self.colbert_index
            self.colbert_ivf = build_ivf(
                index.centroid_ids, index.mask, index.centroids.shape[0], cap=ivf_cap
            )
            timings["ivf"] = time.perf_counter() - t0
        else:
            # the exhaustive search's token-major layout; PLAID never reads it,
            # and at corpus scale it would double the index's memory
            self.colbert_index.prepared()
        self.build_seconds = {f"colbert_{part}": s for part, s in timings.items()}

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

    # which query encodings a batch needs (the sharded searcher, whose
    # indexes live in shard fields, overrides them)
    @property
    def _dense_active(self) -> bool:
        return self.dense_corpus is not None

    @property
    def _colbert_active(self) -> bool:
        return self.colbert_index is not None

    @property
    def _cap_guard_index(self):
        """The capped lexical index the query-time guard reads (or None)."""
        return self.bm25_impact_index

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
        if self._dense_active:
            systems.append("dpr")
        if self._splade_active:
            systems.append("splade")
        if self._colbert_active:
            systems.append("colbert")
        if self._rerank_active:
            systems.append("monobert")
        return systems

    @property
    def _rerank_active(self) -> bool:
        return self.cross_encoder is not None and self.rerank_depth > 0 and self.ce_doc_tokens is not None

    # -- index persistence: one directory holds every system's files ------
    def save_indexes(self, path: str, timings: dict | None = None) -> None:
        """Write every index in the JAX package's layout and formats (the
        bf16 corpus matrices and the token index as f16).  ``timings``, if
        given, receives the seconds each component took, by file name."""
        os.makedirs(path, exist_ok=True)
        np.save(os.path.join(path, "corpus_ids.npy"), self.corpus_ids)
        dc = self.dense_corpus
        # real rows only: the binned kernel's pad rows are a layout of this
        # process, and a reloaded searcher could not tell them apart
        if isinstance(dc, QuantizedDenseIndex) and self.dense_n_docs:
            dc = dc._replace(values=dc.values[: self.dense_n_docs], scales=dc.scales[: self.dense_n_docs])
        for name, index in (
            ("bm25", self.bm25),
            ("bm25_impact", self.bm25_impact_index),
            ("dense", dc),
            ("splade", self.splade_corpus),
            ("splade_impact", self.splade_impact_index),
            ("splade_scatter", self.splade_scatter_index),
            ("splade_rescore", self.splade_rescore_store),
            ("colbert", self.colbert_index),
            ("colbert_ivf", self.colbert_ivf),
        ):
            if index is None:
                continue
            with _timed(timings, name):
                if name in ("dense", "splade"):
                    _save_corpus_matrix(index, path, name)
                else:
                    index.save(os.path.join(path, name))
        if self.ce_doc_tokens is not None:
            with _timed(timings, "ce_doc_tokens"):
                ids = self.ce_doc_tokens.cpu().numpy()
                np.savez_compressed(
                    os.path.join(path, "ce_doc_tokens.npz"),
                    # the JAX package stores uint16 ids where the port holds int16 bits
                    ids=ids.view(np.uint16) if ids.dtype == np.int16 else ids,
                    mask=self.ce_doc_mask.cpu().numpy().astype(np.int8),
                )
        if self.percentile_distributions:
            np.savez_compressed(
                os.path.join(path, "percentile_distributions.npz"),
                **{s: np.asarray(t) for s, t in self.percentile_distributions.items()},
            )

    def load_indexes(self, path: str, int8_corpus: bool = False, timings: dict | None = None) -> "HybridSearcher":
        """Serve the indexes of a directory written by either package, on
        this searcher's device.  The models stay the searcher's own.
        ``int8_corpus`` quantizes the BM25 impacts rebuilt from a non-scale
        BM25 index (the corpus matrices keep their stored form).
        ``timings``, if given, receives the seconds of each component."""
        dev = self.device
        self.corpus_ids = np.load(os.path.join(path, "corpus_ids.npy"))

        def there(*parts):
            return os.path.exists(os.path.join(path, *parts))

        has_bm25_impact = there("bm25_impact", "impact_index.npz")
        if there("bm25"):
            with _timed(timings, "bm25"):
                self.bm25 = BM25Index.load(os.path.join(path, "bm25"), device=dev)
                if not has_bm25_impact:
                    self.bm25_impacts = self.bm25.build_dense_impacts()
                    if int8_corpus:
                        self.bm25_impacts = _quantize_impacts(self.bm25_impacts)
        if has_bm25_impact:
            with _timed(timings, "bm25_impact"):
                self.bm25_impact_index = ImpactIndex.load(os.path.join(path, "bm25_impact"), device=dev)
        for name in ("dense", "splade"):
            with _timed(timings, name):
                loaded = _load_corpus_matrix(path, name, dev)
            if loaded is not None:
                setattr(self, f"{name}_corpus", loaded)
                if name == "dense":
                    self.dense_n_docs = None
            elif timings is not None:
                timings.pop(name)
        for name, file, cls, attr in (
            ("splade_impact", "impact_index.npz", ImpactIndex, "splade_impact_index"),
            ("splade_scatter", "chunked_impact_index.npz", ChunkedImpactIndex, "splade_scatter_index"),
            ("splade_rescore", "rescore_store.npz", SpladeRescoreStore, "splade_rescore_store"),
            ("colbert_ivf", "ivf_index.npz", IVFIndex, "colbert_ivf"),
        ):
            if there(name, file):
                with _timed(timings, name):
                    setattr(self, attr, cls.load(os.path.join(path, name), device=dev))
        if self.splade_rescore_store is not None and not self.splade_rescore_depth:
            self.splade_rescore_depth = 512  # the scale-mode default
        for file, cls in (("compressed_index.npz", CompressedTokenIndex), ("token_index.npz", TokenIndex)):
            if there("colbert", file):
                with _timed(timings, "colbert"):
                    self.colbert_index = cls.load(os.path.join(path, "colbert"), device=dev)
                    if self.colbert_ivf is None:  # PLAID never reads the search layout
                        self.colbert_index.prepared()
                break
        if there("ce_doc_tokens.npz"):
            with _timed(timings, "ce_doc_tokens"):
                with np.load(os.path.join(path, "ce_doc_tokens.npz")) as z:
                    ids, mask = z["ids"], z["mask"]
                if ids.dtype == np.uint16:
                    ids = ids.view(np.int16)  # the port holds uint16 ids as int16 bits
                self.ce_doc_tokens = torch.as_tensor(ids, device=dev)
                self.ce_doc_mask = torch.as_tensor(mask, device=dev)
                self.ce_doc_lens = mask.sum(axis=1).astype(np.int32)
            if self.rerank_cascade is not None:
                _check_cascade_stage1_depth(int(self.rerank_cascade[1]), self.ce_doc_lens)
        if there("percentile_distributions.npz"):
            with np.load(os.path.join(path, "percentile_distributions.npz")) as z:
                self.percentile_distributions = {s: z[s] for s in z.files}
        return self

    def build_percentile_distributions(
        self, queries: Sequence[str], num_points: int = 10_000, batch_size: int = 32, use_pallas: bool | None = None
    ) -> dict[str, np.ndarray]:
        """Per-system quantile tables from a query sample's scores: each
        system's per-query top-``self.topk`` scores, pooled.  Sets
        ``self.percentile_distributions`` and returns the tables."""
        check_use_pallas(use_pallas)
        tables = {}
        for system, ranked in self.search_systems(queries, batch_size=batch_size, external_ids=False).items():
            scores = ranked.scores.numpy()
            tables[system] = build_percentile_distribution(scores[np.isfinite(scores)], num_points=num_points)
        self.percentile_distributions = tables
        return tables

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
        idx = self._cap_guard_index
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
        upload the token arrays (spans: ``prepare``, and inside it one
        host-only ``tokenize.<system>`` per text encoder)."""
        with span("prepare"):
            inputs: dict[str, torch.Tensor] = {}
            if self.bm25 is not None:
                with span("tokenize.bm25"):
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
            if self._dense_active:
                dense_te = self.dense_model.text_encoder
                with span("tokenize.dpr"):
                    ids, mask = dense_te.encode(chunk, query_mode=True)
                inputs["q_ids"], inputs["q_mask"] = token_tensors(ids, mask, self.device)
            if self._splade_active:
                te = self.splade_model.text_encoder
                if te is dense_te:
                    inputs["sp_ids"], inputs["sp_mask"] = inputs["q_ids"], inputs["q_mask"]
                else:
                    with span("tokenize.splade"):
                        ids, mask = te.encode(chunk, query_mode=True)
                    inputs["sp_ids"], inputs["sp_mask"] = token_tensors(ids, mask, self.device)
            if self._colbert_active:
                with span("tokenize.colbert"):
                    ids, mask = self.colbert_model.text_encoder.encode(chunk, query_mode=True)
                inputs["cb_ids"], inputs["cb_mask"] = token_tensors(ids, mask, self.device)
            if self._rerank_active:
                with span("tokenize.rerank"):
                    ids, mask = self.cross_encoder.encode_queries_raw(chunk, max_query_tokens=self.ce_query_length)
                inputs["ce_ids"], inputs["ce_mask"] = token_tensors(ids, mask, self.device)
                # the packed plan's query lengths, taken while the mask is on the host
                inputs["ce_qlens"] = np.asarray(mask).sum(axis=1).astype(np.int32)
            return inputs

    def _bm25_leg(self, inputs: dict[str, torch.Tensor]) -> RankedLists:
        with span("leg.bm25"):
            terms, weights = inputs["bm25_terms"], inputs["bm25_weights"]
            topk = min(self.topk, self.bm25.n_docs)
            if self.bm25_impact_index is not None:
                return impact_search(terms, weights.to(torch.float32), self.bm25_impact_index, k=topk)
            imp = self.bm25_impacts
            if isinstance(imp, QuantizedDenseIndex):
                # the doc-major int8 form: an f32 [Q, V+1] query matrix
                return quantized_dense_search(self.bm25.query_matrix(terms, weights), imp, k=topk)
            qmat = self.bm25.query_matrix(terms, weights, dtype=imp.dtype)
            return ranked_from_scores(matmul_f32(qmat, imp), topk)

    def _dpr_leg(self, inputs: dict[str, torch.Tensor]) -> RankedLists:
        with span("leg.dpr"):
            with span("encoder.dpr"):
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
        with span("leg.splade"):
            with span("encoder.splade"):
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
        if self._dense_active:
            results["dpr"] = self._dpr_leg(inputs)
        if self._splade_active:
            results["splade"] = self._splade_leg(inputs)
        if self._colbert_active:
            results["colbert"] = self._colbert_leg(inputs)
        return results

    def _colbert_leg(self, inputs: dict[str, torch.Tensor]) -> RankedLists:
        """PLAID if there is an IVF, else the exhaustive compressed search,
        else MaxSim over the token matrix."""
        with span("leg.colbert"):
            with span("encoder.colbert"):
                q_tok = self.colbert_model.embed_tokens(inputs["cb_ids"], inputs["cb_mask"])
            q_mask = inputs["cb_mask"].to(torch.float32)
            index = self.colbert_index
            if self.colbert_ivf is not None:
                return plaid_search(
                    q_tok.to(torch.float32), q_mask, index, self.colbert_ivf, k=self.topk,
                    nprobe=self.plaid_nprobe, ncand=min(self.plaid_ncand, self.colbert_ivf.n_docs),
                    ncand_rescore=self.plaid_ncand_rescore, rescore_impl=self.plaid_rescore_impl,
                )
            if isinstance(index, CompressedTokenIndex):
                return maxsim_search_compressed(q_tok, q_mask, index, k=self.topk)
            corpus_tm, doc_valid = index.prepared()
            return maxsim_search_tm(q_tok.to(torch.bfloat16), q_mask, corpus_tm, doc_valid, k=self.topk)

    def _fuse(self, results: dict[str, RankedLists]) -> RankedLists:
        with span("fuse"):
            if len(results) == 1:
                return next(iter(results.values()))
            weights = self.linear_weights or {s: 1.0 / len(results) for s in results}
            tables = None
            if self.fusion_method == "nsf" and self.normalization in _PERCENTILE_NORMALIZATIONS:
                if not self.percentile_distributions:
                    raise ValueError(
                        f"normalization={self.normalization!r} needs per-system quantile tables: call "
                        "build_percentile_distributions() or assign .percentile_distributions from an "
                        "offline analyze_score_distributions run"
                    )
                tables = self.percentile_distributions
            return Aggregator.fuse(
                results,
                method=self.fusion_method,
                normalization=self.normalization,
                linear_weights=weights if self.fusion_method == "nsf" else None,
                percentile_distributions=tables,
                return_topk=self.topk,
            )

    def _rerank(self, inputs: dict, fused: RankedLists) -> RankedLists:
        """The rerank stage over the fused head of one batch."""
        with span("rerank"):
            _check_rerank_options(self.rerank_packed, self.rerank_buckets, self.rerank_cascade)
            kr = min(self.rerank_depth, fused.depth)
            head_ids = fused.ids[:, :kr]
            if self.rerank_buckets is not None:
                logits = self._bucketed_rerank_stage(inputs, head_ids)
            elif self.rerank_packed:
                logits = self._packed_rerank_stage(inputs, head_ids)
            else:
                logits = self._flat_rerank_stage(inputs, head_ids)
            return rerank_head_merge(fused, head_ids, logits)

    def _flat_rerank_stage(self, inputs: dict, head_ids: torch.Tensor) -> torch.Tensor:
        """Every (query, candidate) pair padded to the full doc width, all on
        the device: gather the head's doc tokens, score in chunks — in one
        pass, or in the cascade's two."""
        ce = self.cross_encoder
        safe = head_ids.clamp(0, self.ce_doc_tokens.shape[0] - 1).long()
        d_ids = ce._token_ids(self.ce_doc_tokens[safe])
        d_mask = self.ce_doc_mask[safe].long() * (head_ids >= 0)[..., None]
        if self.rerank_cascade is not None:
            keep, stage1 = self.rerank_cascade
            return ce.rerank_tokens_cascade(
                inputs["ce_ids"], inputs["ce_mask"], d_ids, d_mask, keep=int(keep),
                stage1_tokens=int(stage1), pair_chunk=self.rerank_chunk,
            )
        return ce.rerank_tokens(inputs["ce_ids"], inputs["ce_mask"], d_ids, d_mask, pair_chunk=self.rerank_chunk)

    def _bucketed_rerank_stage(self, inputs: dict, head_ids: torch.Tensor) -> torch.Tensor:
        """Each pair padded to its length bucket: the plan needs the head
        ids on the host (one [Q, depth] read-back per batch)."""
        return self.cross_encoder.rerank_tokens_bucketed(
            inputs["ce_ids"], inputs["ce_mask"], self.ce_doc_tokens, self.ce_doc_mask,
            head_ids.cpu().numpy(), self.ce_doc_lens, buckets=self.rerank_buckets,
            pair_chunk=self.rerank_chunk,
        )

    def _packed_rerank_stage(self, inputs: dict, head_ids: torch.Tensor) -> torch.Tensor:
        """Pairs packed into fixed-width rows: the plan needs the head ids on
        the host (one [Q, depth] read-back per batch), the rows are
        assembled and scored on the device."""
        return self.cross_encoder.rerank_tokens_packed(
            inputs["ce_ids"], inputs["ce_mask"], self.ce_doc_tokens, self.ce_doc_mask,
            head_ids.cpu().numpy(), self.ce_doc_lens, inputs["ce_qlens"],
            row_width=self.rerank_row_width,
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
        self,
        queries: Sequence[str],
        batch_size: int = 32,
        use_pallas: bool | None = None,
        external_ids: bool = True,
    ) -> tuple[RankedLists, float]:
        """Batched hybrid search. Returns (ranked lists on the host, ms/query).
        Each batch's read-back, and the final concatenation, run in the span
        ``search.fetch``."""
        check_use_pallas(use_pallas)
        out_ids, out_scores = [], []

        def fetch(pending):
            ranked, real = pending
            with span("search.fetch"):
                out_ids.append(ranked.ids[:real].cpu())
                out_scores.append(ranked.scores[:real].cpu())

        t0 = time.perf_counter()
        # one-deep pipeline: batch i is queued on the device before batch
        # i-1 is read back, so host tokenization overlaps device work
        pending = None
        for inputs, real in self._batches(queries, batch_size):
            fused = self._fuse(self._search_batch(inputs))
            if self._rerank_active:
                fused = self._rerank(inputs, fused)
            if pending is not None:
                fetch(pending)
            pending = (fused, real)
        if pending is not None:
            fetch(pending)
        elapsed = time.perf_counter() - t0
        with span("search.fetch"):
            ranked = RankedLists(ids=torch.cat(out_ids), scores=torch.cat(out_scores))
            if external_ids:
                ranked = ranked.remap_ids(self.corpus_ids)
        return ranked, elapsed / max(len(queries), 1) * 1000

    def search_systems(
        self,
        queries: Sequence[str],
        batch_size: int = 32,
        use_pallas: bool | None = None,
        external_ids: bool = True,
    ) -> dict[str, RankedLists]:
        """Per-system ranked lists (on the host) with no fusion or rerank."""
        check_use_pallas(use_pallas)
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
