"""Sort-free sparse scoring over the chunked impact index (the SPLADE leg of
scale mode).

For each (query, doc-range chunk), every posting of the query's terms adds
``bf16(bf16(impact) · bf16(weight))`` to its doc's f32 score; a doc with
score > 0 matched at least one query term, anything else is -inf.  The dense
chunk scores then go through the dense leg's 16-doc bin maxima with the
in-bin argmax packed into the 4 low mantissa bits (``ops/dense_topk.py``),
and one stable top-k over all bins picks the result.

  * ``scatter_binmax_cuda`` — the hand-written Hopper kernel
    (``csrc/scatter_score.cu``): persistent blocks walk the (query, chunk)
    items, prefetch each item's posting rows from the index into a staging
    ring and scatter-add them into a shared-memory accumulator
    (``scatter_smem_bytes`` mirrors its shared-memory sizes);
    ``scatter_binmax_cuda.launches`` counts its launches;
  * ``scatter_binmax_plain`` — the plain PyTorch version of the same function
    (gather the postings, scatter-add, bin-reduce), which a tensor on the
    CPU runs and the kernel is held to on the card;
  * ``scatter_impact_search`` — the search;
  * ``scatter_pregathered_cuda`` / ``scatter_pregathered_plain`` — the same
    scoring over postings already gathered per query, chunk-major
    ``[Q, Cp, Kq·capc]`` (``_gather_postings``; the TPU's
    ``scripts/probe_scatter_kernel.py::_b3d_kernel``) or term-major
    ``[Q, Kq, Cp, capc]`` (``gather_postings_term_major``;
    ``scripts/probe_scatter_layout.py::_kernel_nt``), one kernel on K3's
    persistent design with a layout parameter, staging a chunk-major item by
    bulk copies and a term-major one by 16-byte copies
    (``pregathered_smem_bytes`` mirrors its shared-memory sizes;
    ``.launches`` counts chunk-major launches, ``.term_major_launches``
    term-major ones); ``pregathered_search`` is the search over them;
  * ``shard_chunked_impact_index``, ``local_scatter_search`` and
    ``sharded_scatter_search`` — a rank's chunk-range shard of the index
    and its search over a mesh (``parallel/sharding.py``).

Trades, as in the JAX package: postings accumulate bf16 values in f32;
two true top-k docs sharing a 16-doc bin drop the weaker; packed scores lose
4 mantissa bits (≤ 2⁻¹⁹ relative).  The TPU kernel builds the scatter as a
factorized one-hot matmul because the TPU has no scatter; the card has one.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from fusion_tpu_torch.core.device import check_use_pallas
from fusion_tpu_torch.core.ranked import RankedLists
from fusion_tpu_torch.index.inverted import CHUNK_SENTINEL
from fusion_tpu_torch.ops import _kernels
from fusion_tpu_torch.ops.dense_topk import BIN, _bin_reduce_pack, _select_topk
from fusion_tpu_torch.parallel.sharding import INDEX_AXIS, default_index_rank, globalize, merge_shards

LANES = 128  # a chunk's docs d = hi·LANES + lo, hi < H

# Kq·capc ceiling of the serving layout: build() shrinks the chunk width
# until the equal-mass per-chunk cap fits it, so it decides the index layout
MAX_POSTING_WIDTH = 8192
MAX_SMEM = 232_448  # shared memory one block may use on Hopper
SMEM_PER_TWO_BLOCKS = 115_712  # a block's share of an SM's 228 KB with two on it (1 KB each reserved)


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


def gather_postings_term_major(
    q_terms: torch.Tensor,  # int [Q, Kq] (pad >= vocab_size)
    q_weights: torch.Tensor,  # f32 [Q, Kq]
    post_doc: torch.Tensor,  # int16 [V+1, C, capc] (uint16 bits)
    post_impact: torch.Tensor,  # f16 [V+1, C, capc]
    chunk_block: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Query-term posting rows: (docs int32, vals bf16) [Q, Kq, Cp, capc];
    the chunk axis is padded to a ``chunk_block`` multiple with
    sentinel-only chunks (``scripts/probe_scatter_layout.py``'s
    ``gather_nt``)."""
    vp1, c, _ = post_doc.shape
    terms = q_terms.long().clamp(0, vp1 - 1)
    docs = post_doc[terms].to(torch.int32) & 0xFFFF
    vals = post_impact[terms].to(torch.bfloat16) * q_weights.to(torch.bfloat16)[..., None, None]
    c_pad = -(-c // chunk_block) * chunk_block
    if c_pad != c:
        docs = torch.nn.functional.pad(docs, (0, 0, 0, c_pad - c), value=CHUNK_SENTINEL)
        vals = torch.nn.functional.pad(vals, (0, 0, 0, c_pad - c))
    return docs, vals


def _gather_postings(
    q_terms: torch.Tensor,
    q_weights: torch.Tensor,
    post_doc: torch.Tensor,
    post_impact: torch.Tensor,
    chunk_block: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The same rows chunk-major: (docs int32, vals bf16) [Q, Cp, Kq·capc]."""
    docs, vals = gather_postings_term_major(q_terms, q_weights, post_doc, post_impact, chunk_block)
    q, kq, c_pad, capc = docs.shape
    return (
        docs.transpose(1, 2).reshape(q, c_pad, kq * capc),
        vals.transpose(1, 2).reshape(q, c_pad, kq * capc),
    )


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


def scatter_row_slot(capc: int) -> int:
    """Bytes of one staged posting row of the scatter kernel: ``2·capc``
    rounded up to 16, plus 16 where rows do not start on 16-byte boundaries
    (``capc % 8``), since a row is copied as the 16-byte span around it."""
    return -(-2 * capc // 16) * 16 + (16 if capc % 8 else 0)


def scatter_smem_bytes(kq: int, capc: int, docs_per_chunk: int) -> tuple[int, int]:
    """(ring slots, shared-memory bytes) of one block of the scatter kernel
    (``csrc/scatter_score.cu``, mirrored): the ``docs_per_chunk``-float
    accumulator, ring slots of one (query, chunk) item's staged rows (``Kq``
    doc-id rows and ``Kq`` impact rows, and a byte per row: its offset in its
    16-byte span) and the query's f32 weights.  3 slots where two blocks
    still fit an SM, else 2; 0 slots (with the bytes of 2) where not even
    one block fits."""
    item = 2 * kq * scatter_row_slot(capc)
    return _ring(lambda depth: 4 * docs_per_chunk + depth * (item + kq) + 4 * kq)


def _ring(size) -> tuple[int, int]:
    """(ring slots, bytes) by the kernels' rule: 3 slots where two blocks
    still fit an SM, else 2; 0 slots (with the bytes of 2) where not even
    one block fits."""
    if size(3) <= SMEM_PER_TWO_BLOCKS:
        return 3, size(3)
    return (2 if size(2) <= MAX_SMEM else 0), size(2)


def pregathered_smem_bytes(kq: int, capc: int, docs_per_chunk: int, layout: str) -> tuple[int, int]:
    """(ring slots, shared-memory bytes) of one block of the pre-gathered
    kernel (``csrc/scatter_score.cu``, ``scatter_runs_kernel``, mirrored):
    the ``docs_per_chunk``-float accumulator and ring slots of one
    (query, chunk) item — the spans of its runs' int32 docs, then of their
    bf16 values (one run of ``Kq·capc`` chunk-major, ``Kq`` runs of ``capc``
    term-major; ``pregathered_run_slots``), the slot's 8-byte mbarrier and
    two offset bytes per run.  Slots as ``scatter_smem_bytes``."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    runs, length = (1, kq * capc) if layout == "chunk_major" else (kq, capc)
    doc, val = pregathered_run_slots(length)
    return _ring(lambda depth: 4 * docs_per_chunk + depth * (runs * (doc + val) + 8 + 2 * runs))


def pregathered_run_slots(length: int) -> tuple[int, int]:
    """Slot bytes of one run's int32 docs and of its bf16 values: each is
    staged as the 16-byte-aligned span around it, rounded up to 16 bytes,
    plus 16 where the run may start inside a 16-byte word (docs where
    ``length % 4``, values where ``length % 8``)."""
    return (-(-4 * length // 16) * 16 + (16 if length % 4 else 0),
            -(-2 * length // 16) * 16 + (16 if length % 8 else 0))


@functools.cache
def _bind() -> ctypes.CDLL:
    lib = _kernels.load("scatter_score")
    lib.scatter_binmax.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.scatter_binmax.restype = ctypes.c_int
    lib.scatter_pregathered.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.scatter_pregathered.restype = ctypes.c_int
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
    if (post_doc.data_ptr() | post_impact.data_ptr()) % 16:
        raise ValueError("scatter_binmax_cuda needs 16-byte aligned index rows")
    depth, smem = scatter_smem_bytes(kq, capc, docs_per_chunk)
    if depth == 0:
        raise ValueError(
            f"Kq·capc = {kq * capc} postings per item: two staging slots beside the "
            f"{docs_per_chunk}-doc accumulator need {smem} bytes of shared memory (at most {MAX_SMEM})"
        )
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


LAYOUTS = ("chunk_major", "term_major")


def scatter_pregathered_plain(
    docs: torch.Tensor,
    vals: torch.Tensor,
    docs_per_chunk: int,
    layout: str = "chunk_major",
    chunk_block: int = 16,
) -> torch.Tensor:
    """Plain version of the pre-gathered scorer: int32 docs and bf16 values,
    chunk-major [Q, Cp, W] or term-major [Q, Kq, Cp, capc] → f32
    [Q, Cp·dpc/16] packed bin maxima (pad chunks included, all -inf)."""
    h = _plan(docs_per_chunk)
    if layout == "term_major":
        q, kq, c_pad, capc = docs.shape
        docs = docs.permute(0, 2, 1, 3).reshape(q, c_pad, kq * capc)
        vals = vals.permute(0, 2, 1, 3).reshape(q, c_pad, kq * capc)
    elif layout != "chunk_major":
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    q, c_pad, _ = docs.shape
    out = torch.empty((q, c_pad, docs_per_chunk // BIN), dtype=torch.float32, device=docs.device)
    for ci in range(0, c_pad, chunk_block):
        scores = _chunk_scores(docs[:, ci : ci + chunk_block], vals[:, ci : ci + chunk_block], h)
        out[:, ci : ci + chunk_block] = _bin_reduce_pack(
            scores.reshape(q, -1, docs_per_chunk), 0, 2**31 - 1
        )
    return out.reshape(q, -1)


def scatter_pregathered_cuda(
    docs: torch.Tensor, vals: torch.Tensor, docs_per_chunk: int, layout: str = "chunk_major"
) -> torch.Tensor:
    """The Hopper kernel (``csrc/scatter_score.cu``, ``scatter_pregathered``):
    int32 docs and bf16 values, chunk-major [Q, Cp, W] or term-major
    [Q, Kq, Cp, capc] → f32 [Q, Cp·dpc/16] packed bin maxima, on the current
    stream.  A layout whose item does not fit one block's shared memory
    twice over (``pregathered_smem_bytes``) is refused before anything is
    built or launched."""
    h = _plan(docs_per_chunk)
    if layout == "chunk_major" and docs.dim() == 3:
        q, c_pad, w = docs.shape
        kq, capc = 1, w
    elif layout == "term_major" and docs.dim() == 4:
        q, kq, c_pad, capc = docs.shape
    else:
        raise ValueError(f"layout {layout!r} (one of {LAYOUTS}) does not fit docs of shape {tuple(docs.shape)}")
    depth, smem = pregathered_smem_bytes(kq, capc, docs_per_chunk, layout)
    if depth == 0:
        raise ValueError(
            f"{kq * capc} postings per item ({layout}): two staging slots beside the "
            f"{docs_per_chunk}-doc accumulator need {smem} bytes of shared memory (at most {MAX_SMEM})"
        )
    if not (docs.is_cuda and vals.is_cuda) or docs.device != vals.device:
        raise ValueError("scatter_pregathered_cuda needs both tensors on one CUDA device")
    if docs.dtype != torch.int32 or vals.dtype != torch.bfloat16:
        raise TypeError(f"scatter_pregathered_cuda takes int32 docs and bf16 values, got {docs.dtype}, {vals.dtype}")
    if vals.shape != docs.shape or not (docs.is_contiguous() and vals.is_contiguous()):
        raise ValueError("scatter_pregathered_cuda needs contiguous docs and values of one shape")
    if (docs.data_ptr() | vals.data_ptr()) % 16:
        raise ValueError("scatter_pregathered_cuda needs 16-byte aligned docs and values")
    out = torch.empty((q, c_pad * docs_per_chunk // BIN), dtype=torch.float32, device=docs.device)
    if q == 0 or c_pad == 0 or kq * capc == 0:
        return out.fill_(-torch.inf)
    lib = _bind()
    rc = lib.scatter_pregathered(
        docs.data_ptr(), vals.data_ptr(), out.data_ptr(), q, c_pad, kq, capc, h * LANES,
        LAYOUTS.index(layout), torch.cuda.current_stream(docs.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"pre-gathered scatter kernel launch failed: {lib.scatter_binmax_error_string(rc).decode()} ({rc})"
        )
    if layout == "chunk_major":
        scatter_pregathered_cuda.launches += 1
    else:
        scatter_pregathered_cuda.term_major_launches += 1
    return out


scatter_pregathered_cuda.launches = 0
scatter_pregathered_cuda.term_major_launches = 0


def pregathered_search(
    docs: torch.Tensor,
    vals: torch.Tensor,
    n_docs: int,
    docs_per_chunk: int,
    k: int = 1000,
    layout: str = "chunk_major",
) -> RankedLists:
    """Search over pre-gathered postings: the kernel for tensors on the card,
    the plain version on the CPU, then the stable top-k of the bins."""
    if docs.is_cuda:
        packed = scatter_pregathered_cuda(docs, vals, docs_per_chunk, layout)
    else:
        packed = scatter_pregathered_plain(docs, vals, docs_per_chunk, layout)
    return _select_topk(packed, n_docs, min(k, n_docs), docs_per_chunk)


class ShardedChunkedImpactIndex(NamedTuple):
    """One rank's chunk-range shard of a ChunkedImpactIndex
    (``shard_chunked_impact_index``).  Chunks are contiguous doc ranges, so
    shard r owns docs [r·docs_per_shard, (r+1)·docs_per_shard)."""

    post_doc: torch.Tensor  # int16 [V+1, C/S, capc] (uint16 local ids, pad 0xFFFF)
    post_impact: torch.Tensor  # f16 [V+1, C/S, capc]
    n_docs: int
    docs_per_chunk: int
    docs_per_shard: int
    vocab_size: int
    cap_per_chunk: int


def shard_chunked_impact_index(index, n_shards: int, *, rank: int | None = None) -> ShardedChunkedImpactIndex:
    """Split a ChunkedImpactIndex chunk-wise into ``n_shards`` doc-range
    shards and keep shard ``rank`` (default: this process's index
    coordinate) on the index's device.  The chunk axis pads with
    sentinel-only chunks to divide evenly: the host repack of the JAX
    package, whose ``[S, V+1, C/S, capc]`` stack holds these rows."""
    rank = default_index_rank(n_shards) if rank is None else rank
    docs = index.post_doc.cpu().numpy()
    imps = index.post_impact.cpu().numpy()
    vp1, c, capc = docs.shape
    per_c = -(-c // n_shards)
    lo, hi = rank * per_c, min((rank + 1) * per_c, c)
    d_s = np.full((vp1, per_c, capc), CHUNK_SENTINEL, dtype=np.uint16).view(np.int16)
    i_s = np.zeros((vp1, per_c, capc), dtype=np.float16)
    d_s[:, : max(hi - lo, 0)] = docs[:, lo:hi]
    i_s[:, : max(hi - lo, 0)] = imps[:, lo:hi]
    device = index.post_doc.device
    return ShardedChunkedImpactIndex(
        post_doc=torch.as_tensor(d_s, device=device),
        post_impact=torch.as_tensor(i_s, device=device),
        n_docs=index.n_docs,
        docs_per_chunk=index.docs_per_chunk,
        docs_per_shard=per_c * index.docs_per_chunk,
        vocab_size=index.vocab_size,
        cap_per_chunk=index.cap_per_chunk,
    )


def local_scatter_search(
    q_terms: torch.Tensor,
    q_weights: torch.Tensor,
    post_doc: torch.Tensor,  # int16 [V+1, Cl, capc] (one shard's chunks)
    post_impact: torch.Tensor,
    docs_per_chunk: int,
    docs_per_shard: int,
    k: int,
    chunk_block: int = 16,
    use_pallas: bool | None = None,
    recall_target: float = 0.99,
) -> RankedLists:
    """One shard's scatter search with LOCAL doc ids (pad slots -1): K3 for
    tensors on the card, its plain version on the CPU.  ``chunk_block`` (the
    TPU kernel's grid step), ``use_pallas`` and ``recall_target`` are checked
    and dropped: the port's select is exact."""
    check_use_pallas(use_pallas)
    if chunk_block < 1 or not 0.0 < recall_target <= 1.0:
        raise ValueError(f"chunk_block must be >= 1 and recall_target in (0, 1], got {chunk_block}, {recall_target}")
    packed = scatter_binmax(
        q_terms.to(torch.int32).contiguous(), q_weights.to(torch.float32).contiguous(),
        post_doc.contiguous(), post_impact.contiguous(), docs_per_chunk,
    )
    return _select_topk(packed, docs_per_shard, min(k, docs_per_shard), docs_per_chunk)


def sharded_scatter_search(
    q_terms: torch.Tensor,
    q_weights: torch.Tensor,
    index: ShardedChunkedImpactIndex,
    mesh,
    k: int = 1000,
    chunk_block: int = 16,
    use_pallas: bool | None = None,
    recall_target: float = 0.99,
) -> RankedLists:
    """Index-parallel scatter search: each rank scores its chunk-range shard
    (queries replicated) and the per-shard top-k lists all-gather and merge.
    Depth ``min(k, docs_per_shard)``."""
    per = index.docs_per_shard
    k = min(k, per)
    local = local_scatter_search(
        q_terms, q_weights, index.post_doc, index.post_impact, index.docs_per_chunk, per, k,
        chunk_block=chunk_block, use_pallas=use_pallas, recall_target=recall_target,
    )
    return merge_shards(globalize(local, mesh.coords[INDEX_AXIS], per), local.scores, k, mesh)
