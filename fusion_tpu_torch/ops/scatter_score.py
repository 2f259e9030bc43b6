"""Sort-free sparse scoring over the chunked impact index (the SPLADE leg of
scale mode).

For each (query, doc-range chunk), every posting of the query's terms adds
``bf16(bf16(impact) · bf16(weight))`` to its doc's f32 score; a doc with
score > 0 matched at least one query term, anything else is -inf.  The dense
chunk scores then go through the dense leg's 16-doc bin maxima with the
in-bin argmax packed into the 4 low mantissa bits (``ops/dense_topk.py``),
and one stable top-k over all bins picks the result.

  * ``scatter_binmax_cuda`` — the hand-written Hopper kernel
    (``csrc/scatter_score.cu``): a real scatter-add into a shared-memory
    accumulator per (query, chunk), reading the posting rows straight from
    the index; ``scatter_binmax_cuda.launches`` counts its launches;
  * ``scatter_binmax_plain`` — the plain PyTorch version of the same function
    (gather the postings, scatter-add, bin-reduce), which a tensor on the
    CPU runs and the kernel is held to on the card;
  * ``scatter_impact_search`` — the search.

Trades, as in the JAX package: postings accumulate bf16 values in f32;
two true top-k docs sharing a 16-doc bin drop the weaker; packed scores lose
4 mantissa bits (≤ 2⁻¹⁹ relative).  The TPU kernel builds the scatter as a
factorized one-hot matmul because the TPU has no scatter; the card has one.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fusion_tpu_torch.core.ranked import RankedLists
from fusion_tpu_torch.index.inverted import CHUNK_SENTINEL
from fusion_tpu_torch.ops import _kernels
from fusion_tpu_torch.ops.dense_topk import BIN, _bin_reduce_pack, _select_topk

LANES = 128  # a chunk's docs d = hi·LANES + lo, hi < H

# Kq·capc ceiling of the serving layout: build() shrinks the chunk width
# until the equal-mass per-chunk cap fits it, so it decides the index layout
MAX_POSTING_WIDTH = 8192


def _plan(docs_per_chunk: int) -> int:
    """H (hi-half size) for a chunk width; validates the layout contract."""
    h, rem = divmod(docs_per_chunk, LANES)
    if rem or h % BIN or not (BIN <= h <= 128):
        raise ValueError(
            "scatter scoring needs docs_per_chunk = H·128 with H a multiple "
            f"of 16 in [16, 128] (got docs_per_chunk={docs_per_chunk}); "
            "build the chunked index with docs_per_chunk in {2048..16384}"
        )
    return h


def _gather_postings(
    q_terms: torch.Tensor,  # int [Q, Kq] (pad >= vocab_size)
    q_weights: torch.Tensor,  # f32 [Q, Kq]
    post_doc: torch.Tensor,  # int16 [V+1, C, capc] (uint16 bits)
    post_impact: torch.Tensor,  # f16 [V+1, C, capc]
    chunk_block: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Query-term posting rows, chunk-major: (docs int32, vals bf16)
    [Q, Cp, Kq·capc]; the chunk axis is padded to a ``chunk_block`` multiple
    with sentinel-only chunks."""
    q, kq = q_terms.shape
    vp1, c, capc = post_doc.shape
    terms = q_terms.long().clamp(0, vp1 - 1)
    docs = post_doc[terms].to(torch.int32) & 0xFFFF  # [Q, Kq, C, capc]
    vals = post_impact[terms].to(torch.bfloat16) * q_weights.to(torch.bfloat16)[..., None, None]
    docs = docs.transpose(1, 2).reshape(q, c, kq * capc)
    vals = vals.transpose(1, 2).reshape(q, c, kq * capc)
    c_pad = -(-c // chunk_block) * chunk_block
    if c_pad != c:
        docs = torch.nn.functional.pad(docs, (0, 0, 0, c_pad - c), value=CHUNK_SENTINEL)
        vals = torch.nn.functional.pad(vals, (0, 0, 0, c_pad - c))
    return docs, vals


def _chunk_scores(docs: torch.Tensor, vals: torch.Tensor, h: int) -> torch.Tensor:
    """docs int32 [..., W], vals bf16 [..., W] → dense chunk scores f32
    [..., H, 128] (doc (h, l) = h·128 + l) by a scatter-add; docs with
    hi ≥ H (the sentinel pads) are dropped, unmatched docs are -inf."""
    dpc = h * LANES
    idx = torch.where(docs < dpc, docs, dpc).long()  # one spill slot past the chunk
    dense = torch.zeros((*docs.shape[:-1], dpc + 1), dtype=torch.float32, device=docs.device)
    dense.scatter_add_(-1, idx, vals.to(torch.float32))
    scores = dense[..., :dpc]
    # impacts are positive: score > 0 ⇔ the doc shares a term with the query
    return torch.where(scores > 0, scores, -torch.inf).view(*docs.shape[:-1], h, LANES)


def scatter_binmax_plain(
    q_terms: torch.Tensor,
    q_weights: torch.Tensor,
    post_doc: torch.Tensor,
    post_impact: torch.Tensor,
    docs_per_chunk: int,
    chunk_block: int = 16,
) -> torch.Tensor:
    """Plain version of the scatter scorer → f32 [Q, C·dpc/16] packed bin
    maxima (chunk c's bin b covers its docs {s·dpc/16 + b : s < 16})."""
    h = _plan(docs_per_chunk)
    q = q_terms.shape[0]
    c = post_doc.shape[1]
    cb = max(1, min(chunk_block, c))
    docs, vals = _gather_postings(q_terms, q_weights, post_doc, post_impact, cb)
    c_pad = docs.shape[1]
    out = torch.empty((q, c_pad, docs_per_chunk // BIN), dtype=torch.float32, device=docs.device)
    for ci in range(0, c_pad, cb):
        scores = _chunk_scores(docs[:, ci : ci + cb], vals[:, ci : ci + cb], h)
        out[:, ci : ci + cb] = _bin_reduce_pack(
            scores.reshape(q, cb, docs_per_chunk), 0, 2**31 - 1
        )
    # the sentinel-only pad chunks hold no match: drop them
    return out[:, :c].reshape(q, -1)


@functools.cache
def _bind() -> ctypes.CDLL:
    lib = _kernels.load("scatter_score")
    lib.scatter_binmax.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.scatter_binmax.restype = ctypes.c_int
    lib.scatter_binmax_error_string.argtypes = [ctypes.c_int]
    lib.scatter_binmax_error_string.restype = ctypes.c_char_p
    return lib


def scatter_binmax_cuda(
    q_terms: torch.Tensor,
    q_weights: torch.Tensor,
    post_doc: torch.Tensor,
    post_impact: torch.Tensor,
    docs_per_chunk: int,
) -> torch.Tensor:
    """The Hopper kernel (``csrc/scatter_score.cu``): int32 [Q, Kq] terms and
    f32 [Q, Kq] weights against the int16 [V+1, C, capc] / f16 index rows →
    f32 [Q, C·dpc/16] packed bin maxima, on the current stream."""
    tensors = (q_terms, q_weights, post_doc, post_impact)
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError("scatter_binmax_cuda needs every tensor on one CUDA device")
    dtypes = (torch.int32, torch.float32, torch.int16, torch.float16)
    if tuple(t.dtype for t in tensors) != dtypes:
        raise TypeError(
            f"scatter_binmax_cuda takes {dtypes}, got {tuple(t.dtype for t in tensors)}"
        )
    h = _plan(docs_per_chunk)
    q, kq = q_terms.shape
    vp1, c, capc = post_doc.shape
    if q_weights.shape != (q, kq) or post_impact.shape != post_doc.shape:
        raise ValueError(
            f"shapes must be [Q, Kq] twice and [V+1, C, capc] twice, got "
            f"{[tuple(t.shape) for t in tensors]}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("scatter_binmax_cuda needs contiguous tensors")
    out = torch.empty((q, c * docs_per_chunk // BIN), dtype=torch.float32, device=q_terms.device)
    if q == 0 or c == 0:
        return out
    lib = _bind()
    rc = lib.scatter_binmax(
        q_terms.data_ptr(), q_weights.data_ptr(), post_doc.data_ptr(), post_impact.data_ptr(),
        out.data_ptr(), q, kq, vp1, c, capc, h * LANES,
        torch.cuda.current_stream(q_terms.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"scatter kernel launch failed: {lib.scatter_binmax_error_string(rc).decode()} ({rc})"
        )
    scatter_binmax_cuda.launches += 1
    return out


scatter_binmax_cuda.launches = 0


def scatter_binmax(q_terms, q_weights, post_doc, post_impact, docs_per_chunk: int) -> torch.Tensor:
    """Packed bin maxima: a tensor on the card goes to the kernel (which
    raises on what it does not take); a tensor on the CPU goes to the plain
    version."""
    if post_doc.is_cuda or q_terms.is_cuda:
        return scatter_binmax_cuda(q_terms, q_weights, post_doc, post_impact, docs_per_chunk)
    return scatter_binmax_plain(q_terms, q_weights, post_doc, post_impact, docs_per_chunk)


def scatter_impact_search(
    q_terms: torch.Tensor,
    q_weights: torch.Tensor,
    index,  # ChunkedImpactIndex
    k: int = 1000,
) -> RankedLists:
    """Sort-free search over a chunked impact index built with
    ``docs_per_chunk`` = H·128 (H a multiple of 16 ≤ 128: 2048..16384).
    Same pruning semantics as the chunked index (exact whenever every
    (term, chunk) has ≤ cap_per_chunk postings)."""
    kq = q_terms.shape[1]
    capc = index.post_doc.shape[2]
    if index.post_doc.is_cuda and kq * capc > MAX_POSTING_WIDTH:
        raise ValueError(
            f"scatter posting width Kq*capc = {kq * capc} exceeds the serving layout's "
            f"{MAX_POSTING_WIDTH}; rebuild the chunked index with a smaller cap_per_chunk "
            "(or a smaller docs_per_chunk, which lowers the equal-mass per-chunk cap)"
        )
    packed = scatter_binmax(
        q_terms.to(torch.int32).contiguous(), q_weights.to(torch.float32).contiguous(),
        index.post_doc, index.post_impact, index.docs_per_chunk,
    )
    return _select_topk(packed, index.n_docs, min(k, index.n_docs), index.docs_per_chunk)
