"""BM25 / TF-IDF / ATIRE-BM25 lexical index.

  build (host, once):
      vocab, df[V], doc_len[N], and COO postings (term, doc, tf) sorted by
      (doc, term) and padded to a static nnz (pad term = V, pad doc = N).
  score:
      impact[e]   = idf[term_e] * tf_e*(k1+1) / (tf_e + k1*(1-b+b*dl_e/avgdl))
      score[q, d] = Σ_e qtf[q, term_e] * impact[e]

idf = log10((N-df+0.5)/(df+0.5)) for BM25; ATIRE and TF-IDF share
log10((N+1)/(df+1)).  ``build_dense_impacts`` materializes the [V+1, N]
impact matrix once, so scoring a query batch is one [Q, V+1] × [V+1, N]
matmul on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

VARIANTS = ("bm25", "atire", "tfidf")


def _compute_idf(variant: str, n_docs: int, df: np.ndarray) -> np.ndarray:
    """Per-variant inverse document frequency (see module docstring)."""
    if variant == "bm25":
        return np.log10((n_docs - df + 0.5) / (df + 0.5))
    return np.log10((n_docs + 1.0) / (df + 1.0))


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
        device="cpu",
    ) -> "BM25Index":
        """Build from preprocessed documents (whitespace-token strings) with
        one vectorized numpy pass; the arrays then live on ``device``."""
        if variant not in VARIANTS:
            raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
        n = len(corpus)
        tokens_per_doc = [doc.split() for doc in corpus]
        doc_len = np.array([len(t) for t in tokens_per_doc], dtype=np.float32)
        total = int(doc_len.sum())
        vocab: dict[str, int] = {}
        if total:
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
            entry_doc = uniq_pairs // v
            entry_term = uniq_pairs % v
            entry_tf = counts.astype(np.float32)
        else:
            v = 0
            entry_term = np.zeros(0, dtype=np.int64)
            entry_doc = np.zeros(0, dtype=np.int64)
            entry_tf = np.zeros(0, dtype=np.float32)
        df = np.bincount(entry_term, minlength=v) if v else np.zeros(0, dtype=np.int64)

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

    def _impacts(self) -> torch.Tensor:
        """Per-posting contribution of one query occurrence of its term, in
        f32 (k1 and b enter as f32, as the device scorer receives them)."""
        dev = self.entry_tf.device
        k1 = torch.tensor(self.k1, dtype=torch.float32, device=dev)
        b = torch.tensor(self.b, dtype=torch.float32, device=dev)
        tf = self.entry_tf
        idf = self.idf[self.entry_term.long()]
        if self.variant == "tfidf":
            return idf * tf
        dl = self.doc_len[self.entry_doc.long().clamp(0, self.n_docs - 1)]
        denom = tf + k1 * (1.0 - b + b * dl / self.avgdl)
        return idf * (tf * (k1 + 1.0)) / torch.clamp(denom, min=1e-9)

    def build_dense_impacts(self, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """The [V+1, N] impact matrix for the current (k1, b), built on the
        index's device.  Postings are unique (doc, term) pairs, so each cell
        is written once, straight into the term-major layout; row V (OOV and
        padding) stays zero."""
        w = torch.zeros(
            (self.vocab_size + 1, self.n_docs), dtype=dtype, device=self.entry_tf.device
        )
        real = slice(0, self.nnz)
        w[self.entry_term[real].long(), self.entry_doc[real].long()] = (
            self._impacts()[real].to(dtype)
        )
        return w
