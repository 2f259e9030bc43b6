"""Candidate-row gather: ``out[q, j] = src[idx[q, j]]`` for several sources
that share one index (PLAID's prune and rescore tiers gather the centroid
ids, packed codes and mask rows of every candidate).

  * ``gather_rows_cuda`` — the hand-written Hopper kernel
    (``csrc/gather_rows.cu``): one launch for all sources, one warp per row,
    16-byte copies where the row width and alignment allow, 64-bit offsets;
    ``gather_rows_cuda.launches`` counts its launches;
  * ``gather_rows_plain`` — the plain PyTorch version (``src[idx]`` per
    source), which a tensor on the CPU runs and the kernel is held to on the
    card;
  * ``gather_rows`` — the entry point: a tensor on the card goes to the
    kernel, a tensor on the CPU to the plain version.

Each source may have rank > 2 (the trailing dims are the row) and any dtype;
``idx`` is int32 ``[Q, K]`` with values already in ``[0, N)``.  An index out
of range is the caller's bug: the kernel does not check it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence

import torch

from fusion_tpu_torch.ops import _kernels

MAX_SOURCES = 8  # sources per launch (csrc/gather_rows.cu kMaxSrcs)


def gather_rows_plain(srcs: Sequence[torch.Tensor], idx: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Plain version: ``src[idx]`` per source → ``[Q, K, *row]`` each."""
    flat = idx.reshape(-1)
    return tuple(
        torch.index_select(s, 0, flat).reshape(*idx.shape, *s.shape[1:]) for s in srcs
    )


@functools.cache
def _bind() -> ctypes.CDLL:
    lib = _kernels.load("gather_rows")
    lib.gather_rows.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    lib.gather_rows.restype = ctypes.c_int
    lib.gather_rows_error_string.argtypes = [ctypes.c_int]
    lib.gather_rows_error_string.restype = ctypes.c_char_p
    return lib


def gather_rows_cuda(srcs: Sequence[torch.Tensor], idx: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The Hopper gather kernel (``csrc/gather_rows.cu``) on the current
    stream: contiguous sources with a common row count N on one CUDA device,
    int32 contiguous ``idx [Q, K]`` on the same device → one ``[Q, K, *row]``
    tensor per source."""
    srcs = tuple(srcs)
    if not 1 <= len(srcs) <= MAX_SOURCES:
        raise ValueError(f"gather_rows_cuda takes 1 to {MAX_SOURCES} sources, got {len(srcs)}")
    if not idx.is_cuda or any(s.device != idx.device for s in srcs):
        raise ValueError("gather_rows_cuda needs idx and every source on one CUDA device")
    if idx.dtype != torch.int32 or idx.dim() != 2 or not idx.is_contiguous():
        raise ValueError(
            f"idx must be a contiguous int32 [Q, K] tensor, got {idx.dtype} {tuple(idx.shape)}"
        )
    if any(s.dim() < 1 or not s.is_contiguous() for s in srcs):
        raise ValueError("gather_rows_cuda needs contiguous sources of rank >= 1")
    if len({s.shape[0] for s in srcs}) != 1:
        raise ValueError(f"sources must share their row count, got {[tuple(s.shape) for s in srcs]}")
    outs = tuple(
        torch.empty((*idx.shape, *s.shape[1:]), dtype=s.dtype, device=idx.device) for s in srcs
    )
    if idx.numel() == 0:
        return outs
    n = len(srcs)
    lib = _bind()
    rc = lib.gather_rows(
        n,
        (ctypes.c_void_p * n)(*(s.data_ptr() for s in srcs)),
        (ctypes.c_void_p * n)(*(o.data_ptr() for o in outs)),
        (ctypes.c_longlong * n)(*(math.prod(s.shape[1:]) * s.element_size() for s in srcs)),
        idx.data_ptr(), idx.numel(), torch.cuda.current_stream(idx.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"gather_rows kernel launch failed: {lib.gather_rows_error_string(rc).decode()} ({rc})"
        )
    gather_rows_cuda.launches += 1
    return outs


gather_rows_cuda.launches = 0


def gather_rows(srcs: Sequence[torch.Tensor], idx: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Gather the same rows from every source.  A tensor on the card goes to
    the kernel (which raises on what it does not take); a tensor on the CPU
    goes to the plain version."""
    if idx.is_cuda or any(s.is_cuda for s in srcs):
        return gather_rows_cuda(srcs, idx)
    return gather_rows_plain(srcs, idx)
