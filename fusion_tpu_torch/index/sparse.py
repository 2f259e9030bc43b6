"""Sparse (SPLADE) corpus index and the two-stage exact rescore.

  * ``SparseIndex`` — each doc's top-K pruned activations in a fixed-K
    layout, ``entry_term int32[N, K]`` (pad = vocab_size) and
    ``entry_weight f32[N, K]`` (pad = 0).  Scale mode converts it to the
    impact forms (``index/inverted.py``).
  * ``SpladeRescoreStore`` — one row per doc, ``[2K]`` = K term ids ++ K f16
    weight bits, as uint16 values in an int16 tensor (widen the terms with
    ``& 0xFFFF``; the weights are a ``view(torch.float16)``).
  * ``sparse_rescore`` — the capped impact forms only generate candidates;
    each candidate is then scored exactly against its full stored doc vector
    (the capped forms alone lose recall in proportion to the postings they
    drop).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from fusion_tpu_torch.core.ranked import RankedLists
from fusion_tpu_torch.ops.topk import blockwise_topk


class SparseIndex(NamedTuple):
    entry_term: torch.Tensor  # int32 [N, K] (pad = vocab_size)
    entry_weight: torch.Tensor  # f32 [N, K] (pad = 0)
    n_docs: int
    vocab_size: int
    nnz: int

    def nbytes(self) -> int:
        return self.entry_term.nbytes + self.entry_weight.nbytes


def build_sparse_index(
    doc_activations_iter, vocab_size: int, prune_topk: int = 128, device="cpu"
) -> SparseIndex:
    """Build from an iterator of dense activation batches [B, V] (numpy).

    Each doc keeps its ``prune_topk`` largest positive activations, padded
    to exactly K slots (term = vocab_size, weight = 0), terms ascending
    within a row (pads last)."""
    term_rows, weight_rows = [], []
    nnz = 0
    for batch in doc_activations_iter:
        batch = np.asarray(batch)
        k = min(prune_topk, batch.shape[-1])
        idx = np.argpartition(-batch, k - 1, axis=-1)[:, :k]
        vals = np.take_along_axis(batch, idx, axis=-1)
        keep = vals > 0
        idx = np.where(keep, idx, vocab_size)
        vals = np.where(keep, vals, 0.0)
        order = np.argsort(idx, axis=-1)
        term_rows.append(np.take_along_axis(idx, order, axis=-1))
        weight_rows.append(np.take_along_axis(vals, order, axis=-1).astype(np.float32))
        nnz += int(keep.sum())
    if term_rows:
        entry_term = np.concatenate(term_rows, axis=0)
        entry_weight = np.concatenate(weight_rows, axis=0)
    else:
        entry_term = np.zeros((0, prune_topk), np.int64)
        entry_weight = np.zeros((0, prune_topk), np.float32)
    return SparseIndex(
        entry_term=torch.as_tensor(np.ascontiguousarray(entry_term, dtype=np.int32), device=device),
        entry_weight=torch.as_tensor(entry_weight, device=device),
        n_docs=entry_term.shape[0],
        vocab_size=vocab_size,
        nnz=nnz,
    )


class SpladeRescoreStore(NamedTuple):
    packed: torch.Tensor  # int16 [N, 2K]: uint16 term ids ++ f16 weight bits
    n_docs: int
    vocab_size: int
    prune_topk: int  # K

    def nbytes(self) -> int:
        return self.packed.nbytes


def build_rescore_store(index: SparseIndex) -> SpladeRescoreStore:
    """Host-side build from a SparseIndex, on the index's device.  Weights
    are stored as f16; terms as uint16 (SPLADE vocabularies are ≤ 32k; pad
    slots keep weight 0, so their term id is inert)."""
    if index.vocab_size > 0xFFFF:
        raise ValueError(
            f"the rescore store packs term ids as uint16; vocab_size {index.vocab_size} "
            "does not fit"
        )
    terms = index.entry_term.cpu().numpy()
    w = index.entry_weight.cpu().numpy().astype(np.float16)
    t16 = np.minimum(terms, index.vocab_size).astype(np.uint16)
    packed = np.concatenate([t16, w.view(np.uint16)], axis=1)  # [N, 2K]
    return SpladeRescoreStore(
        packed=torch.as_tensor(packed.view(np.int16), device=index.entry_term.device),
        n_docs=terms.shape[0],
        vocab_size=index.vocab_size,
        prune_topk=terms.shape[1],
    )


def sparse_rescore(
    query_activations: torch.Tensor,  # f32 [Q, V] FULL (unpruned) activations
    cand_ids: torch.Tensor,  # int32 [Q, C] stage-1 candidates (pad -1)
    store: SpladeRescoreStore,
    k: int = 1000,
    cand_chunk: int = 4096,
) -> RankedLists:
    """Exact rescore of stage-1 candidates against their full stored doc
    vectors: gather each candidate's packed row and dot it with the query's
    dense activations (f32).  Pads and out-of-range ids score -inf and come
    back as -1."""
    q, ncand = cand_ids.shape
    kk, vocab, n_docs = store.prune_topk, store.vocab_size, store.n_docs
    qvp = torch.cat(
        [query_activations.to(torch.float32), query_activations.new_zeros((q, 1), dtype=torch.float32)],
        dim=-1,
    )  # column V (the pad term) scores 0
    # cc divides ncand: a ragged last chunk would re-score overlapping
    # candidates and duplicate doc ids
    cc = math.gcd(min(cand_chunk, ncand), ncand)

    def block_scores(bi: int):
        sl = cand_ids[:, bi * cc : (bi + 1) * cc]
        valid = (sl >= 0) & (sl < n_docs)
        rows = store.packed[sl.long().clamp(0, n_docs - 1)]  # [Q, cc, 2K]
        terms = (rows[..., :kk].to(torch.int32) & 0xFFFF).clamp(max=vocab)
        w = rows[..., kk:].view(torch.float16).to(torch.float32)
        g = torch.gather(qvp, 1, terms.reshape(q, -1).long()).view(q, cc, kk)
        scores = (g * w).sum(dim=-1)
        return torch.where(valid, scores, -torch.inf), sl

    out = blockwise_topk(block_scores, ncand // cc, q, min(k, ncand))
    return RankedLists(
        ids=torch.where(torch.isfinite(out.scores), out.ids, -1).to(torch.int32),
        scores=out.scores,
    )
