"""BM25 / TF-IDF / ATIRE-BM25 lexical index.

  build (host, once; the C++ builder of ``native/`` or numpy):
      vocab, df[V], doc_len[N], and COO postings (term, doc, tf) sorted by
      (doc, term) and padded to a static nnz (pad term = V, pad doc = N).
  score:
      impact[e]   = idf[term_e] * tf_e*(k1+1) / (tf_e + k1*(1-b+b*dl_e/avgdl))
      score[q, d] = Σ_e qtf[q, term_e] * impact[e]

idf = log10((N-df+0.5)/(df+0.5)) for BM25; ATIRE and TF-IDF share
log10((N+1)/(df+1)).  k1 and b are arguments of the scorers, so a
hyperparameter sweep (``update_params``) rebuilds nothing.

Scoring forms:
  * ``score_gather`` — gather + segment sum over the postings, [Q, N];
  * ``score_matmul`` — per doc block, the block's postings into a dense
    [V+1, B] impact tile and one [Q, V+1] × [V+1, B] product, optionally
    through a running top-k;
  * ``build_dense_impacts`` — the [V+1, N] impact matrix once, so a query
    batch is one matmul (``search_dense``);
  * ``to_impact_index`` / ``to_sparse_index`` — the term-major impact-ordered
    and the doc-major fixed-K forms (``search_impact``, ``search_sparse``).

``search_all`` ranks every query with the gather or matmul scorer, in
batches of ``query_batch``; ``extract_negatives`` mines a ranking's
top non-positives as training negatives.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from fusion_tpu_torch import native
from fusion_tpu_torch.core.device import resolve_device
from fusion_tpu_torch.core.ranked import RankedLists, ranked_from_scores
from fusion_tpu_torch.ops.mips import matmul_f32
from fusion_tpu_torch.ops.topk import blockwise_topk_offset
from fusion_tpu_torch.utils.common import non_positives

VARIANTS = ("bm25", "atire", "tfidf")


def _compute_idf(variant: str, n_docs: int, df: np.ndarray) -> np.ndarray:
    """Per-variant inverse document frequency (see module docstring)."""
    if variant == "bm25":
        return np.log10((n_docs - df + 0.5) / (df + 0.5))
    return np.log10((n_docs + 1.0) / (df + 1.0))


def _numpy_postings(corpus: Sequence[str]):
    """The numpy posting builder: (vocab, entry_term, entry_doc, entry_tf,
    doc_len, df) in doc-major (doc, term) order, vocabulary ids in order of
    first appearance (what ``native.build_bm25_postings`` returns)."""
    n = len(corpus)
    tokens_per_doc = [doc.split() for doc in corpus]
    doc_len = np.array([len(t) for t in tokens_per_doc], dtype=np.float32)
    total = int(doc_len.sum())
    vocab: dict[str, int] = {}
    if not total:
        empty = np.zeros(0, dtype=np.int64)
        return vocab, empty, empty, np.zeros(0, dtype=np.float32), doc_len, empty
    setdefault = vocab.setdefault
    inv = np.fromiter(
        (setdefault(t, len(vocab)) for toks in tokens_per_doc for t in toks),
        dtype=np.int64,
        count=total,
    )
    v = len(vocab)
    doc_ids = np.repeat(np.arange(n, dtype=np.int64), doc_len.astype(np.int64))
    # (doc, term) pair counts; sorted int keys → doc-major COO
    uniq_pairs, counts = np.unique(doc_ids * v + inv, return_counts=True)
    entry_term = uniq_pairs % v
    return vocab, entry_term, uniq_pairs // v, counts.astype(np.float32), doc_len, np.bincount(entry_term, minlength=v)


@dataclass
class BM25Index:
    """Lexical index over a preprocessed, whitespace-tokenized corpus."""

    vocab: dict  # term -> term id
    n_docs: int
    variant: str
    k1: float
    b: float
    entry_term: torch.Tensor  # int32[nnz_pad] (pad = V)
    entry_doc: torch.Tensor  # int32[nnz_pad] (pad = n_docs)
    entry_tf: torch.Tensor  # float32[nnz_pad] (pad = 0)
    idf: torch.Tensor  # float32[V + 1] (last row = 0 for OOV/pad)
    doc_len: torch.Tensor  # float32[N]
    avgdl: float
    nnz: int = 0

    @classmethod
    def build(
        cls,
        corpus: Sequence[str],
        k1: float = 1.5,
        b: float = 0.75,
        variant: str = "bm25",
        pad_multiple: int = 1024,
        use_native: str | bool = "auto",
        *,
        device="cuda",
    ) -> "BM25Index":
        """Build from preprocessed documents (whitespace-token strings); the
        arrays then live on ``device``.

        The host pass is the C++ builder (``native/``, ``csrc/bm25_builder.cpp``)
        with ``use_native`` "auto" (when it compiles and no document holds a
        newline) or True (which raises instead of falling back), and one
        vectorized numpy pass otherwise; both give the same arrays."""
        if variant not in VARIANTS:
            raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
        if use_native not in ("auto", True, False):
            raise ValueError(f"use_native must be 'auto', True or False, got {use_native!r}")
        device = resolve_device(device)
        n = len(corpus)
        native_out = None
        if use_native in ("auto", True) and n:
            if any("\n" in d for d in corpus):
                # the builder's wire format is line-delimited
                if use_native is True:
                    raise RuntimeError(
                        "native BM25 builder cannot take documents containing "
                        "newlines — preprocess them out or use use_native='auto'"
                    )
            else:
                native_out = native.build_bm25_postings(list(corpus))
                if native_out is None and use_native is True:
                    raise RuntimeError("native BM25 builder unavailable (g++ failed; see the logged stderr)")
        logging.getLogger(__name__).info(
            "BM25 posting builder: %s (%d docs)",
            "C++ (csrc/bm25_builder.cpp)" if native_out is not None else "numpy", n,
        )
        vocab, entry_term, entry_doc, entry_tf, doc_len, df = (
            native_out if native_out is not None else _numpy_postings(corpus)
        )
        v = len(vocab)

        nnz = entry_term.shape[0]
        nnz_pad = max(pad_multiple, -(-nnz // pad_multiple) * pad_multiple)
        pad = nnz_pad - nnz
        entry_term = np.concatenate([entry_term, np.full(pad, v, dtype=np.int64)])
        entry_doc = np.concatenate([entry_doc, np.full(pad, n, dtype=np.int64)])
        entry_tf = np.concatenate([entry_tf, np.zeros(pad, dtype=np.float32)])
        idf = np.concatenate([_compute_idf(variant, n, df.astype(np.float64)), [0.0]])

        def put(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype), device=device)

        return cls(
            vocab=vocab,
            n_docs=n,
            variant=variant,
            k1=float(k1),
            b=float(b),
            entry_term=put(entry_term, np.int32),
            entry_doc=put(entry_doc, np.int32),
            entry_tf=put(entry_tf, np.float32),
            idf=put(idf, np.float32),
            doc_len=put(doc_len, np.float32),
            avgdl=float(doc_len.mean()) if n else 1.0,
            nnz=nnz,
        )

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # -- persistence: the JAX package's npz + vocab json ------------------
    def save(self, output_dir: str, name: str = "bm25_index") -> None:
        os.makedirs(output_dir, exist_ok=True)
        np.savez_compressed(
            os.path.join(output_dir, f"{name}.npz"),
            entry_term=self.entry_term.cpu().numpy(),
            entry_doc=self.entry_doc.cpu().numpy(),
            entry_tf=self.entry_tf.cpu().numpy(),
            idf=self.idf.cpu().numpy(),
            doc_len=self.doc_len.cpu().numpy(),
            meta=np.array([self.n_docs, self.nnz], dtype=np.int64),
            params=np.array([self.k1, self.b, self.avgdl], dtype=np.float64),
        )
        with open(os.path.join(output_dir, f"{name}.vocab.json"), "w") as f:
            json.dump({"variant": self.variant, "vocab": self.vocab}, f)

    @classmethod
    def load(cls, output_dir: str, name: str = "bm25_index", device="cuda") -> "BM25Index":
        device = resolve_device(device)
        with open(os.path.join(output_dir, f"{name}.vocab.json")) as f:
            vj = json.load(f)
        with np.load(os.path.join(output_dir, f"{name}.npz")) as z:
            n_docs, nnz = (int(x) for x in z["meta"])
            k1, b, avgdl = (float(x) for x in z["params"])
            arrays = {
                key: torch.as_tensor(z[key], device=device)
                for key in ("entry_term", "entry_doc", "entry_tf", "idf", "doc_len")
            }
        return cls(vocab=vj["vocab"], n_docs=n_docs, variant=vj["variant"], k1=k1, b=b,
                   avgdl=avgdl, nnz=nnz, **arrays)

    def encode_queries_np(
        self, queries: Sequence[str], max_terms: int = 64
    ) -> tuple[np.ndarray, np.ndarray]:
        """Tokenized query strings → (term ids [Q, L] int32, term counts [Q, L]).

        OOV terms map to the V pad row (idf 0).  Duplicate query terms
        accumulate in the count so each occurrence contributes."""
        v = self.vocab_size
        q_terms = np.full((len(queries), max_terms), v, dtype=np.int64)
        q_weights = np.zeros((len(queries), max_terms), dtype=np.float32)
        for qi, q in enumerate(queries):
            counts: dict[int, float] = {}
            for tok in q.split():
                tid = self.vocab.get(tok, v)
                if tid != v:
                    counts[tid] = counts.get(tid, 0.0) + 1.0
            for j, (tid, c) in enumerate(list(counts.items())[:max_terms]):
                q_terms[qi, j] = tid
                q_weights[qi, j] = c
        return q_terms.astype(np.int32), q_weights

    @property
    def device(self) -> torch.device:
        return self.entry_tf.device

    def update_params(self, k1: float, b: float) -> None:
        """Change the Okapi constants; nothing is rebuilt (the scorers compute
        the impacts per call)."""
        self.k1 = float(k1)
        self.b = float(b)

    def encode_queries(
        self, queries: Sequence[str], max_terms: int = 64
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """``encode_queries_np`` on the index's device: (term ids int64
        [Q, L], term counts f32 [Q, L])."""
        terms, weights = self.encode_queries_np(queries, max_terms=max_terms)
        return (
            torch.as_tensor(terms.astype(np.int64), device=self.device),
            torch.as_tensor(weights, device=self.device),
        )

    def _impacts(self, k1: float, b: float) -> torch.Tensor:
        """Per-posting contribution of one query occurrence of its term, in
        f32 (k1 and b enter as f32, as the JAX scorer receives them)."""
        dev = self.device
        k1 = torch.tensor(k1, dtype=torch.float32, device=dev)
        b = torch.tensor(b, dtype=torch.float32, device=dev)
        tf = self.entry_tf
        idf = self.idf[self.entry_term.long()]
        if self.variant == "tfidf":
            return idf * tf
        dl = self.doc_len[self.entry_doc.long().clamp(0, self.n_docs - 1)]
        denom = tf + k1 * (1.0 - b + b * dl / self.avgdl)
        return idf * (tf * (k1 + 1.0)) / torch.clamp(denom, min=1e-9)

    def _impacts_host(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(term, doc, impact f32) COO postings, computed on the host in f64
        from the stored f32 idf and doc lengths."""
        term = self.entry_term[: self.nnz].cpu().numpy()
        doc = self.entry_doc[: self.nnz].cpu().numpy()
        tf = self.entry_tf[: self.nnz].cpu().numpy().astype(np.float64)
        idf = self.idf.cpu().numpy().astype(np.float64)[term]
        if self.variant == "tfidf":
            impacts = idf * tf
        else:
            dl = self.doc_len.cpu().numpy().astype(np.float64)[doc]
            impacts = idf * tf * (self.k1 + 1.0) / (
                tf + self.k1 * (1.0 - self.b + self.b * dl / self.avgdl)
            )
        return term, doc, impacts.astype(np.float32)

    def to_impact_index(self, cap: int = 4096):
        """Term-major impact-ordered index (``index/inverted.py``), the
        corpus-scale BM25 form: scoring costs O(Q·terms·cap), independent of
        N.  Built on the host, placed on the index's device."""
        from fusion_tpu_torch.index.inverted import build_impact_index

        term, doc, impacts = self._impacts_host()
        return build_impact_index(
            term, doc, impacts, vocab_size=self.vocab_size, n_docs=self.n_docs, cap=cap,
            device=self.device,
        )

    def to_chunked_impact_index(self, docs_per_chunk: int = 4096, cap_per_chunk: int = 512):
        """Doc-range-chunked impact index (``index/inverted.py``'s
        ``ChunkedImpactIndex``), on the index's device."""
        from fusion_tpu_torch.index.inverted import build_chunked_impact_index

        term, doc, impacts = self._impacts_host()
        return build_chunked_impact_index(
            term, doc, impacts, vocab_size=self.vocab_size, n_docs=self.n_docs, docs_per_chunk=docs_per_chunk,
            cap_per_chunk=cap_per_chunk, device=self.device,
        )

    def build_dense_impacts(self, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """The [V+1, N] impact matrix for the current (k1, b), built on the
        index's device.  Postings are unique (doc, term) pairs, so each cell
        is written once, straight into the term-major layout; row V (OOV and
        padding) stays zero."""
        w = torch.zeros((self.vocab_size + 1, self.n_docs), dtype=dtype, device=self.device)
        real = slice(0, self.nnz)
        w[self.entry_term[real].long(), self.entry_doc[real].long()] = (
            self._impacts(self.k1, self.b)[real].to(dtype)
        )
        return w

    def query_matrix(self, q_terms: torch.Tensor, q_weights: torch.Tensor, dtype=torch.float32):
        """Dense [Q, V+1] query matrix: each query's term counts at its term
        ids (pads add into row V, whose impacts are 0)."""
        qmat = torch.zeros((q_terms.shape[0], self.vocab_size + 1), dtype=dtype, device=self.device)
        return qmat.scatter_add_(1, q_terms.long(), q_weights.to(dtype))

    def score_gather(
        self, q_terms: torch.Tensor, q_weights: torch.Tensor, k1: float, b: float,
        query_chunk: int = 64,
    ) -> torch.Tensor:
        """Dense scores f32 [Q, N]: each posting's impact times its query
        term's count, summed per doc (``query_chunk`` queries at a time bound
        the [Q, nnz] contributions)."""
        impacts = self._impacts(k1, b)
        doc = self.entry_doc.long()
        qmat = self.query_matrix(q_terms, q_weights)
        out = torch.empty((qmat.shape[0], self.n_docs), dtype=torch.float32, device=self.device)
        for s in range(0, qmat.shape[0], query_chunk):
            contrib = qmat[s : s + query_chunk, self.entry_term.long()] * impacts  # [q, nnz]
            scores = torch.zeros((contrib.shape[0], self.n_docs + 1), device=self.device)
            out[s : s + query_chunk] = scores.index_add_(1, doc, contrib)[:, : self.n_docs]
        return out

    def score_matmul(
        self,
        q_terms: torch.Tensor,
        q_weights: torch.Tensor,
        k1: float,
        b: float,
        doc_block: int = 4096,
        top_k: int | None = None,
    ) -> RankedLists | torch.Tensor:
        """Per block of ``doc_block`` docs, the block's postings (a contiguous
        run: postings are sorted by doc) into a dense f32 [V+1, B] impact tile,
        then one [Q, V+1] × [V+1, B] product.  With ``top_k``, blocks stream
        through a running top-k and the [Q, N] scores never exist at once;
        without, returns them."""
        impacts = self._impacts(k1, b)
        qmat = self.query_matrix(q_terms, q_weights)
        vp1 = self.vocab_size + 1
        num_blocks = -(-self.n_docs // doc_block)
        starts = torch.arange(num_blocks + 1, device=self.device) * doc_block
        bounds = torch.searchsorted(self.entry_doc[: self.nnz].contiguous(), starts.to(torch.int32))
        bounds = bounds.tolist()
        offsets = torch.arange(doc_block, device=self.device)

        def block_scores(bi: int):
            start = bi * doc_block
            lo, hi = bounds[bi], bounds[bi + 1]
            w = torch.zeros((vp1, doc_block), dtype=torch.float32, device=self.device)
            w.index_put_(
                (self.entry_term[lo:hi].long(), self.entry_doc[lo:hi].long() - start),
                impacts[lo:hi], accumulate=True,
            )
            scores = matmul_f32(qmat, w)
            return torch.where((start + offsets < self.n_docs)[None, :], scores, -torch.inf), start

        if top_k is not None:
            return blockwise_topk_offset(block_scores, num_blocks, qmat.shape[0], min(top_k, self.n_docs))
        return torch.cat([block_scores(bi)[0] for bi in range(num_blocks)], dim=1)[:, : self.n_docs]

    def to_sparse_index(self, prune_topk: int | None = None):
        """Doc-major fixed-K form (``index/sparse.SparseIndex``) of the
        postings with their impacts at the current (k1, b), on the index's
        device.  Exact when ``prune_topk`` is at least each doc's number of
        unique terms (the default); a smaller K keeps each doc's
        highest-impact terms."""
        from fusion_tpu_torch.index.sparse import SparseIndex

        term = self.entry_term[: self.nnz].cpu().numpy()
        doc = self.entry_doc[: self.nnz].cpu().numpy()
        impacts = self._impacts(self.k1, self.b)[: self.nnz].cpu().numpy()
        counts = np.bincount(doc, minlength=self.n_docs)
        k = int(counts.max(initial=1)) if prune_topk is None else prune_topk
        entry_term = np.full((self.n_docs, k), self.vocab_size, dtype=np.int64)
        entry_weight = np.zeros((self.n_docs, k), dtype=np.float32)
        # postings are doc-major: a posting's slot is its rank within its doc
        starts = np.zeros(self.n_docs + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        slot = np.arange(self.nnz) - starts[doc]
        if prune_topk is not None:
            # keep each doc's top-k impacts: rank within the doc by -impact
            order = np.lexsort((-impacts, doc))
            slot = np.empty(self.nnz, dtype=np.int64)
            slot[order] = np.arange(self.nnz) - starts[doc[order]]
        keep = slot < k
        entry_term[doc[keep], slot[keep]] = term[keep]
        entry_weight[doc[keep], slot[keep]] = impacts[keep]
        return SparseIndex(
            entry_term=torch.as_tensor(entry_term.astype(np.int32), device=self.device),
            entry_weight=torch.as_tensor(entry_weight, device=self.device),
            n_docs=self.n_docs,
            vocab_size=self.vocab_size,
            nnz=int(keep.sum()),
        )

    def search_impact(self, queries: Sequence[str], impact_index, top_k: int = 1000) -> RankedLists:
        """Rank against a term-major impact index (``to_impact_index``)."""
        from fusion_tpu_torch.index.inverted import impact_search

        q_terms, q_weights = self.encode_queries(list(queries))
        return impact_search(q_terms, q_weights, impact_index, k=top_k)

    def search_sparse(
        self, queries: Sequence[str], sparse_index, top_k: int = 1000, doc_block: int = 16384
    ) -> RankedLists:
        """Rank against a fixed-K impact index (``to_sparse_index``)."""
        from fusion_tpu_torch.index.sparse import lexical_query_matrix, sparse_search

        q_terms, q_weights = self.encode_queries(list(queries))
        qv = lexical_query_matrix(q_terms, q_weights, self.vocab_size)
        return sparse_search(qv, sparse_index, k=top_k, doc_block=doc_block)

    def search_dense(self, queries: Sequence[str], impacts: torch.Tensor, top_k: int = 1000) -> RankedLists:
        """Rank against a prebuilt [V+1, N] impact matrix
        (``build_dense_impacts``): one product, with the query matrix in the
        impacts' dtype and f32 scores."""
        q_terms, q_weights = self.encode_queries(list(queries))
        qmat = self.query_matrix(q_terms, q_weights, dtype=impacts.dtype)
        return ranked_from_scores(matmul_f32(qmat, impacts), min(top_k, self.n_docs))

    def search_all(
        self,
        queries: Sequence[str],
        top_k: int = 1000,
        method: str = "gather",
        query_batch: int = 256,
    ) -> RankedLists:
        """Rank every query against the corpus with the ``gather`` or
        ``matmul`` scorer, ``query_batch`` queries at a time (the tail batch
        padded with empty queries to the full batch when there is more than
        one batch, as the JAX package does); results on the index's device."""
        if method not in ("gather", "matmul"):
            raise ValueError(f"unknown scoring method {method!r}")
        top_k = min(top_k, self.n_docs)
        out_ids, out_scores = [], []
        for start in range(0, len(queries), query_batch):
            chunk = list(queries[start : start + query_batch])
            real = len(chunk)
            while len(chunk) < query_batch and len(queries) > query_batch:
                chunk.append("")
            q_terms, q_weights = self.encode_queries(chunk)
            if method == "gather":
                ranked = ranked_from_scores(self.score_gather(q_terms, q_weights, self.k1, self.b), top_k)
            else:
                ranked = self.score_matmul(q_terms, q_weights, self.k1, self.b, top_k=top_k)
            out_ids.append(ranked.ids[:real])
            out_scores.append(ranked.scores[:real])
        return RankedLists(ids=torch.cat(out_ids), scores=torch.cat(out_scores))

    def extract_negatives(
        self,
        ranked: RankedLists,
        positives: Sequence[Sequence[int]],
        num_negatives: int = 10,
        idx2id: np.ndarray | None = None,
    ) -> dict[int, list[int]]:
        """Query index → its top-ranked non-positives (external ids through
        ``idx2id`` when given)."""
        lists = ranked.remap_ids(idx2id).id_lists() if idx2id is not None else ranked.id_lists()
        return {qi: non_positives(preds, pos, num_negatives) for qi, (preds, pos) in enumerate(zip(lists, positives))}
