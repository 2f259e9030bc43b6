"""Fused matmul + binned top-k for corpus-scale dense search (the DPR leg of
scale mode).

One pass over the int8 corpus computes, per doc block of B docs (2048, 4096
or 8192 on the card),

    scores[Q, B] = (q_bf16 · blockᵀ) * scales     (dead rows → _DEAD)
    bin max over 16 strided docs (bin lane l of a block = docs {s·B/16 + l})
    in-bin argmax offset packed into the score's 4 low mantissa bits
      → f32 [Q, N/16]

then one stable top-k over the bin maxima, and the doc ids come back
arithmetically from the bin position and the packed offset.

  * ``binmax_cuda``  — the hand-written Hopper kernel (``csrc/dense_topk.cu``)
    for tensors on the card; ``binmax_cuda.launches`` counts its launches of
    K2 (with the dead-row term) and ``binmax_cuda.nomask_launches`` those of
    the variant without it (``dead_rows=False``: ``scripts/probe_dense.py``'s
    ``_binmax_nomask``, where a pad row of scale 0 scores ±0.0);
  * ``binmax_plain`` — the plain PyTorch version of the same function (what a
    tensor on the CPU runs; the kernel is held to it on the card);
  * ``fused_dense_topk`` — the search: normalize, bin-max, select.

Trades, as in the JAX package: two true top-k docs sharing a 16-doc bin drop
the weaker (E[misses] ≈ k²·8/N per query), and scores lose their 4 low
mantissa bits (≤ 2⁻¹⁹ relative).  Where the JAX package selects with
``approx_max_k``, the port takes the exact stable top-k, which is what
``approx_max_k`` computes off the TPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fusion_tpu_torch.core.device import check_use_pallas
from fusion_tpu_torch.core.ranked import RankedLists, stable_topk
from fusion_tpu_torch.models.heads import l2_normalize
from fusion_tpu_torch.ops import _kernels
from fusion_tpu_torch.ops.mips import matmul_f32

BIN = 16  # docs per bin; bin lane l of a block covers docs {s·lanes + l}

# score of dead rows (scale ≤ 0: build pads and all-zero docs): below any
# real score, finite so the mantissa packing stays defined, and recognized in
# _select_topk so dead rows come back as (-1, -inf)
_DEAD = -3.0e38

# the serving doc block: 16 strided sub-tiles of 128 docs
KERNEL_DOC_BLOCK = 2048
# the doc blocks the kernel takes (template instances of one body)
KERNEL_DOC_BLOCKS = (2048, 4096, 8192)


def _apply_scales(raw: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """[Q, B] raw dots × [B] scales; dead rows (scale ≤ 0) pushed to
    ``_DEAD``.  Pad rows carry scale 0 and would otherwise score exactly 0.0
    and displace real docs of negative similarity from their bin."""
    dead = (s <= 0.0).to(torch.float32)
    return raw * s[None, :] + dead[None, :] * _DEAD


def _bin_reduce_pack(scores: torch.Tensor, doc0, n_docs: int) -> torch.Tensor:
    """[..., B] f32 scores → [..., B/16] bin maxima with the in-bin argmax
    offset packed into the 4 low mantissa bits.

    Strict ``>`` over the 16 strided sub-slices, so ties keep the LOWEST
    offset.  Docs at global id ``doc0 + position`` ≥ ``n_docs`` are masked to
    -inf; ``doc0`` is an int or a tensor that broadcasts against [..., B/16]
    (one start per block when several blocks are reduced at once)."""
    lanes = scores.shape[-1] // BIN
    lane_idx = torch.arange(lanes, device=scores.device)
    m = torch.full((*scores.shape[:-1], lanes), -torch.inf, device=scores.device)
    offs = torch.zeros(m.shape, dtype=torch.int32, device=scores.device)
    for s in range(BIN):
        chunk = scores[..., s * lanes : (s + 1) * lanes]
        valid = doc0 + s * lanes + lane_idx < n_docs
        chunk = torch.where(valid, chunk, -torch.inf)
        upd = chunk > m
        m = torch.where(upd, chunk, m)
        offs = torch.where(upd, s, offs)
    packed = ((m.view(torch.int32) & -16) | offs).view(torch.float32)
    # -inf with OR-ed mantissa bits would read back as NaN: keep pads -inf
    return torch.where(torch.isfinite(m), packed, -torch.inf)


def _unpack(packed_vals: torch.Tensor, bin_pos: torch.Tensor, doc_block: int):
    """(packed score, bin position) → (clean score, global doc id)."""
    lanes = doc_block // BIN
    bits = packed_vals.view(torch.int32)
    offs = (bits & 0xF).to(torch.int64)
    clean = (bits & -16).view(torch.float32)
    ids = (bin_pos // lanes) * doc_block + offs * lanes + bin_pos % lanes
    finite = torch.isfinite(packed_vals)
    return torch.where(finite, clean, -torch.inf), torch.where(finite, ids, -1)


def _select_topk(packed: torch.Tensor, n_docs: int, k: int, doc_block: int) -> RankedLists:
    """Stable top-k over the packed bin maxima; pads back to k columns when
    the corpus has fewer bins than k (one candidate per bin is the binned
    search's ceiling: small corpora belong on the exact path)."""
    k = min(k, n_docs)
    k_bins = min(k, packed.shape[-1])
    vals, pos = stable_topk(packed, k_bins)
    scores, ids = _unpack(vals, pos, doc_block)
    # dead rows surface only when a bin holds nothing else: normalize them to
    # the pad convention
    dead = scores <= _DEAD * 0.5
    scores = torch.where(dead, -torch.inf, scores)
    ids = torch.where(dead, -1, ids)
    if k_bins < k:
        q = packed.shape[0]
        scores = torch.cat([scores, scores.new_full((q, k - k_bins), -torch.inf)], dim=-1)
        ids = torch.cat([ids, ids.new_full((q, k - k_bins), -1)], dim=-1)
    return RankedLists(ids=ids.to(torch.int32), scores=scores)


def binmax_plain(
    q: torch.Tensor,
    values: torch.Tensor,
    scales: torch.Tensor,
    n_docs: int,
    doc_block: int = KERNEL_DOC_BLOCK,
    rows_per_step: int = 65536,
    dead_rows: bool = True,
) -> torch.Tensor:
    """Plain version of the binned scorer: bf16 [Q, H] queries × int8 (or
    bf16) [N_pad, H] rows with f32 [N_pad] scales → f32 [Q, N_pad/16] packed
    bin maxima.  Several blocks share one f32-accumulated matmul, then the
    bin reduction runs on all of them at once.  ``dead_rows=False`` leaves
    out the dead-row term (scores are ``raw · scale``)."""
    n_pad = values.shape[0]
    nq = q.shape[0]
    qb = q.to(torch.bfloat16)
    step = max(1, rows_per_step // doc_block) * doc_block
    out = torch.empty((nq, n_pad // BIN), dtype=torch.float32, device=q.device)
    for start in range(0, n_pad, step):
        vals = values[start : start + step]
        nb = vals.shape[0] // doc_block
        raw = matmul_f32(qb, vals.to(torch.bfloat16).T)
        s = scales[start : start + step]
        scores = _apply_scales(raw, s) if dead_rows else raw * s[None, :]
        scores = scores.view(nq, nb, doc_block)
        doc0 = start + doc_block * torch.arange(nb, device=q.device)[:, None]
        packed = _bin_reduce_pack(scores, doc0, n_docs)  # [Q, nb, lanes]
        out[:, start // BIN : (start + vals.shape[0]) // BIN] = packed.reshape(nq, -1)
    return out


@functools.cache
def _bind() -> ctypes.CDLL:
    lib = _kernels.load("dense_topk")
    lib.dense_binmax.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    lib.dense_binmax.restype = ctypes.c_int
    lib.dense_binmax_error_string.argtypes = [ctypes.c_int]
    lib.dense_binmax_error_string.restype = ctypes.c_char_p
    return lib


def binmax_cuda(
    q: torch.Tensor,
    values: torch.Tensor,
    scales: torch.Tensor,
    n_docs: int,
    doc_block: int = KERNEL_DOC_BLOCK,
    dead_rows: bool = True,
) -> torch.Tensor:
    """The Hopper kernel (``csrc/dense_topk.cu``): bf16 [Q, H] × int8
    [N_pad, H] with f32 [N_pad] scales → f32 [Q, N_pad/16] packed bin maxima,
    on the current stream.  Takes doc_block 2048, 4096 or 8192, N_pad a
    multiple of it, H a multiple of 16 in [16, 1024]; ``dead_rows=False``
    runs the variant without the dead-row term."""
    tensors = (q, values, scales)
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError("binmax_cuda needs every tensor on one CUDA device")
    if q.dtype != torch.bfloat16 or values.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(
            f"binmax_cuda takes bf16 queries, int8 rows and f32 scales, got "
            f"{q.dtype}, {values.dtype} and {scales.dtype}"
        )
    n_pad, h = values.shape
    if q.dim() != 2 or q.shape[1] != h or scales.shape != (n_pad,):
        raise ValueError(
            f"shapes must be [Q, H], [N, H] and [N], got {tuple(q.shape)}, "
            f"{tuple(values.shape)} and {tuple(scales.shape)}"
        )
    if doc_block not in KERNEL_DOC_BLOCKS or n_pad % doc_block:
        raise ValueError(
            f"the kernel takes doc_block in {KERNEL_DOC_BLOCKS} and rows padded to it, "
            f"got doc_block {doc_block} and {n_pad} rows"
        )
    if h % 16 or not 16 <= h <= 1024:
        raise ValueError(f"need H a multiple of 16 in [16, 1024], got {h}")
    if not all(t.is_contiguous() for t in tensors) or (q.data_ptr() | values.data_ptr()) % 16:
        raise ValueError("binmax_cuda needs contiguous tensors and 16-byte aligned rows")
    out = torch.empty((q.shape[0], n_pad // BIN), dtype=torch.float32, device=q.device)
    if q.shape[0] == 0 or n_pad == 0:
        return out
    lib = _bind()
    rc = lib.dense_binmax(
        q.data_ptr(), values.data_ptr(), scales.data_ptr(), out.data_ptr(),
        q.shape[0], h, n_pad // doc_block, doc_block, int(dead_rows), n_docs,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"dense_topk kernel launch failed: {lib.dense_binmax_error_string(rc).decode()} ({rc})"
        )
    if dead_rows:
        binmax_cuda.launches += 1
    else:
        binmax_cuda.nomask_launches += 1
    return out


binmax_cuda.launches = 0
binmax_cuda.nomask_launches = 0


def binmax(
    q, values, scales, n_docs: int, doc_block: int = KERNEL_DOC_BLOCK, dead_rows: bool = True
) -> torch.Tensor:
    """Packed bin maxima: a tensor on the card goes to the kernel (which
    raises on what it does not take); a tensor on the CPU goes to the plain
    version."""
    if values.is_cuda or q.is_cuda:
        return binmax_cuda(q, values, scales, n_docs, doc_block, dead_rows)
    return binmax_plain(q, values, scales, n_docs, doc_block, dead_rows=dead_rows)


def fused_dense_topk(
    query_embs: torch.Tensor,
    index,  # QuantizedDenseIndex or (values, scales, normalized)
    k: int = 1000,
    doc_block: int = KERNEL_DOC_BLOCK,
    recall_target: float = 0.99,
    use_pallas: bool | None = None,
    n_docs: int | None = None,
    *,
    dead_rows: bool = True,
) -> RankedLists:
    """Corpus-scale dense search through the binned scorer.

    Rows should already be padded to a ``doc_block`` multiple (otherwise
    this pads a COPY); pass the real row count as ``n_docs`` so pad rows are
    masked.  Scores come back with 4 mantissa bits cleared.
    ``dead_rows=False`` scores with the no-mask variant.  JAX's
    ``recall_target`` (of its approximate final select) and ``use_pallas``
    are checked and dropped: the port's select is exact, and the device
    picks the kernel or its plain version."""
    if not 0.0 < recall_target <= 1.0:
        raise ValueError(f"recall_target must be in (0, 1], got {recall_target!r}")
    check_use_pallas(use_pallas)
    values, scales, normalized = tuple(index)
    if n_docs is None:
        n_docs = values.shape[0]
    rows = values.shape[0]
    n_pad = -(-rows // doc_block) * doc_block
    if n_pad != rows:
        values = torch.nn.functional.pad(values, (0, 0, 0, n_pad - rows))
        scales = torch.nn.functional.pad(scales, (0, n_pad - rows))
    qf = query_embs.to(torch.float32)
    if normalized:
        qf = l2_normalize(qf)
    packed = binmax(qf.to(torch.bfloat16), values, scales, n_docs, doc_block, dead_rows)
    return _select_topk(packed, n_docs, k, doc_block)
