"""Masked multi-head attention, the encoder's ``flash`` form:
``softmax(q·kᵀ · scale + bias) · v`` per head, with ``bias`` 0 on the keys a
query may attend and -1e9 elsewhere.  A query attends the keys whose
``attention_mask`` is set and, for packed rows (``segment_ids`` given), that
lie in its own segment.

  * ``masked_attention_cuda`` — the hand-written Hopper kernel
    (``csrc/attention.cu``; bf16 on the tensor cores, f32 on scalar FMAs,
    head dim 64, forward only); ``masked_attention_cuda.launches`` counts its
    launches;
  * ``masked_attention_plain`` — the plain PyTorch version, which a tensor
    on the CPU runs and the kernel is held to on the card: the logits of the
    compute-dtype ``q``, ``k`` in f32, the f32 bias, the f32 softmax cast to
    the compute dtype, times ``v``.  That is the encoder's ``einsum`` form,
    which is also what the JAX package's ``flash`` computes off a TPU;
  * ``masked_attention`` — the entry point: a tensor on the card goes to the
    kernel, a tensor on the CPU to the plain version.

``q``, ``k``, ``v`` are ``[B, L, heads, hd]`` (views of the fused qkv
projection serve as they are: only the last dim must be contiguous), the
output is a contiguous ``[B, L, heads, hd]``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fusion_tpu_torch.ops import _kernels

HEAD_DIM = 64  # the kernel's head dim (csrc/attention.cu kHd)
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def allowed_keys(attention_mask: torch.Tensor, segment_ids: torch.Tensor | None) -> torch.Tensor:
    """The keys each query may attend: ``[B, 1, 1, L]`` from the key mask, or
    the block-diagonal ``[B, 1, L, L]`` of packed rows."""
    if segment_ids is None:
        return attention_mask[:, None, None, :] > 0
    return ((segment_ids[:, None, :] == segment_ids[:, :, None]) & (attention_mask[:, None, :] > 0))[:, None]


def masked_attention_plain(q, k, v, attention_mask, segment_ids, scale: float) -> torch.Tensor:
    """Plain version: f32 logits, the -1e9 f32 bias off the allowed keys, f32
    softmax cast to ``q``'s dtype, then ``· v`` → ``[B, L, heads, hd]``."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    bias = torch.where(allowed_keys(attention_mask, segment_ids), 0.0, -1e9).to(torch.float32)
    probs = torch.softmax(logits + bias, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


@functools.cache
def _bind() -> ctypes.CDLL:
    lib = _kernels.load("attention")
    lib.masked_attention.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    lib.masked_attention.restype = ctypes.c_int
    lib.masked_attention_error_string.argtypes = [ctypes.c_int]
    lib.masked_attention_error_string.restype = ctypes.c_char_p
    return lib


def masked_attention_cuda(q, k, v, attention_mask, segment_ids, scale: float) -> torch.Tensor:
    """The Hopper kernel (``csrc/attention.cu``) on the current stream: bf16
    or f32 ``q``, ``k``, ``v`` of one shape ``[B, L, heads, 64]`` on one CUDA
    device, each with a contiguous last dim and 16-byte aligned rows; the
    masks ``[B, L]`` on the same device.  Forward only: it raises where a
    gradient would be needed."""
    tensors = (q, k, v, attention_mask) + (() if segment_ids is None else (segment_ids,))
    if not q.is_cuda or any(t.device != q.device for t in tensors):
        raise ValueError("masked_attention_cuda needs every tensor on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"masked_attention_cuda takes bf16 or f32 q, k, v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"q, k, v must share one [B, L, heads, {HEAD_DIM}] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, length, heads, hd = q.shape
    if attention_mask.shape != (b, length) or (segment_ids is not None and segment_ids.shape != (b, length)):
        raise ValueError(f"the masks must be [B, L] = [{b}, {length}]")
    unit = 16 // q.element_size()  # elements in a 16-byte load
    for t in (q, k, v):
        if t.stride(-1) != 1 or any(s % unit for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"masked_attention_cuda needs a contiguous last dim and 16-byte aligned rows, "
                             f"got strides {t.stride()}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("masked_attention_cuda has no backward kernel: train with the einsum forms")
    out = torch.empty((b, length, heads, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    mask = attention_mask.to(torch.int32).contiguous()
    seg = None if segment_ids is None else segment_ids.to(torch.int32).contiguous()
    lib = _bind()
    rc = lib.masked_attention(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), mask.data_ptr(),
        None if seg is None else seg.data_ptr(),
        (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3]),
        b, length, heads, hd, scale, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"masked_attention kernel launch failed: {lib.masked_attention_error_string(rc).decode()} ({rc})"
        )
    masked_attention_cuda.launches += 1
    return out


masked_attention_cuda.launches = 0


def masked_attention(q, k, v, attention_mask, segment_ids, scale: float) -> torch.Tensor:
    """Masked attention of ``q``, ``k``, ``v`` [B, L, heads, hd].  A tensor on
    the card goes to the kernel (which raises on what it does not take); a
    tensor on the CPU goes to the plain version."""
    if q.is_cuda:
        return masked_attention_cuda(q, k, v, attention_mask, segment_ids, scale)
    return masked_attention_plain(q, k, v, attention_mask, segment_ids, scale)
