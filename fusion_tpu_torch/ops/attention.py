"""Masked multi-head attention, the encoder's ``flash`` form:
``softmax(q·kᵀ · scale + bias) · v`` per head, with ``bias`` 0 on the keys a
query may attend and -1e9 elsewhere.  A query attends the keys whose
``attention_mask`` is set and, for packed rows (``segment_ids`` given), that
lie in its own segment.

  * ``masked_attention_cuda`` — the hand-written Hopper kernel
    (``csrc/attention.cu``; bf16 by wgmma with TMA staging, f32 on scalar
    FMAs, head dim 64); with ``residuals=True`` it also returns each query
    row's f32 ``m`` (max of its biased logits) and ``l`` (sum of
    ``exp(logit - m)``), ``[B, heads, L]``; ``masked_attention_cuda.launches``
    counts its launches;
  * ``masked_attention_backward_cuda`` — the backward's hand-written
    kernels (the D pass, dK/dV over the query tiles, dQ over the key
    tiles), writing ``dq``, ``dk``, ``dv`` into one ``[B, L, 3, heads, hd]``
    buffer; its ``launches`` counts its calls (each launches all three);
  * ``tensor_map`` and ``grids`` — what the bf16 kernels are launched with,
    kept here so that the CPU tests reach them: each operand's TMA map
    (dims, byte strides, box) from its strided view, and each kernel's
    grid;
  * ``masked_attention_plain`` / ``masked_attention_backward_plain`` — the
    plain PyTorch versions, which a tensor on the CPU runs and the kernels
    are held to on the card.  The forward: the logits of the compute-dtype
    ``q``, ``k`` in f32, the f32 bias, the f32 softmax cast to the compute
    dtype, times ``v`` (the encoder's ``einsum`` form, which is also what
    the JAX package's ``flash`` computes off a TPU).  The backward, from
    the residuals: ``P = exp(s - m) / l`` in f32, ``D = rowsum(dO∘O)``,
    ``dV = P·dO``, ``dP = dO·Vᵀ``, ``dS = P∘(dP - D)``, ``dQ = dS·K·scale``,
    ``dK = dSᵀ·Q·scale``, with ``P`` and ``dS`` in the compute dtype as the
    products' operands;
  * ``MaskedAttention`` — the ``torch.autograd.Function`` joining them: on
    the card its forward runs the kernel in residual mode and its backward
    the backward kernels, on the CPU the two plain versions;
  * ``masked_attention`` — the entry point: a tensor on the card goes to the
    kernel, a tensor on the CPU to the plain version, through
    ``MaskedAttention`` where a gradient is needed.

``q``, ``k``, ``v`` are ``[B, L, heads, hd]`` (views of the fused qkv
projection serve as they are: only the last dim must be contiguous), the
output is a contiguous ``[B, L, heads, hd]``.  The gradients of ``q``,
``k``, ``v`` are the three planes of one contiguous ``[B, L, 3, heads, hd]``
buffer, which ``split_qkv`` hands back whole to the projection.
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


def _biased_logits(q, k, attention_mask, segment_ids, scale: float) -> torch.Tensor:
    """f32 ``q·kᵀ · scale`` plus the f32 -1e9 bias off the allowed keys →
    ``[B, heads, L, L]``."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    bias = torch.where(allowed_keys(attention_mask, segment_ids), 0.0, -1e9).to(torch.float32)
    return logits + bias


def masked_attention_plain(q, k, v, attention_mask, segment_ids, scale: float, residuals: bool = False):
    """Plain version: f32 logits, the -1e9 f32 bias off the allowed keys, f32
    softmax cast to ``q``'s dtype, then ``· v`` → ``[B, L, heads, hd]``; with
    ``residuals``, ``(out, m, l)``: each query row's max of its biased logits
    and sum of ``exp(logit - m)``, f32 ``[B, heads, L]``."""
    z = _biased_logits(q, k, attention_mask, segment_ids, scale)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(z, dim=-1).to(q.dtype), v)
    if not residuals:
        return out
    m = z.amax(dim=-1)
    return out, m, torch.exp(z - m[..., None]).sum(dim=-1)


def masked_attention_backward_plain(q, k, v, out, m, l, d_out, attention_mask, segment_ids, scale: float):
    """Plain version of the backward from the forward's output and residuals
    ``m``, ``l`` → ``(dq, dk, dv)`` in ``q``'s dtype, step by step: ``P =
    exp(s - m) / l`` (f32), ``D = rowsum(dO∘O)`` (f32), ``dV = P·dO`` with
    ``P`` in the compute dtype, ``dP = dO·Vᵀ`` (f32), ``dS = P∘(dP - D)``,
    ``dQ = dS·K·scale`` and ``dK = dSᵀ·Q·scale`` with ``dS`` in the compute
    dtype, summed in f32."""
    dt = q.dtype
    p = torch.exp(_biased_logits(q, k, attention_mask, segment_ids, scale) - m[..., None]) / l[..., None]
    d = (d_out.float() * out.float()).sum(-1).transpose(1, 2)  # [B, heads, L]
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt), d_out)
    dp = torch.einsum("bqhd,bkhd->bhqk", d_out.float(), v.float())
    ds = (p * (dp - d[..., None])).to(dt).float()
    dq = (torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale).to(dt)
    dk = (torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale).to(dt)
    return dq, dk, dv


TILE = 64  # rows of one TMA box and of a block's own tile, bf16 and f32 (csrc/attention.cu kTile, kRows)
MAX_BF16_LENGTH = 8192  # the bf16 kernels' bound on L (csrc/attention.cu kMaxLength)
_ROWDOT_THREADS = 256  # csrc/attention.cu kRowdotThreads


@functools.cache
def _bind() -> ctypes.CDLL:
    lib = _kernels.load("attention")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.masked_attention.argtypes = [i, p, p, p, p, p, p, p, p, p, p, ll, i, i, i, f, ll, p]
    lib.masked_attention.restype = ctypes.c_int
    lib.masked_attention_rowdot.argtypes = [i, p, p, p, p, ll, i, i, ll, p]
    lib.masked_attention_rowdot.restype = ctypes.c_int
    lib.masked_attention_backward.argtypes = [i, p, p, p, p, p, p, p, p, p, p, p, p, ll, i, i, i, f, ll, p]
    lib.masked_attention_backward.restype = ctypes.c_int
    lib.masked_attention_error_string.argtypes = [ctypes.c_int]
    lib.masked_attention_error_string.restype = ctypes.c_char_p
    return lib


def tensor_map(t: torch.Tensor) -> tuple[tuple[int, ...], tuple[int, ...], tuple[int, ...]]:
    """The TMA tensor map of a bf16 ``[B, L, heads, 64]`` view, as the bf16
    kernels encode it: ``(dims, byte strides, box)`` with dims ``(64, heads,
    L, B)`` innermost first, the byte strides of dims 1..3 (head, position,
    batch), and a box of one head's ``TILE`` rows.  Rows past L read as
    zeros and are not written.  A dim of extent 1 is never stepped, so its
    stride is taken as the extent of the dims inside it.  Raises where TMA
    cannot take the view: a last dim that is not contiguous, a base address
    or a stride that is not a multiple of 16 bytes, or a stride of 2^40
    bytes or more."""
    b, length, heads, hd = t.shape
    es = t.element_size()
    if t.stride(-1) != 1:
        raise ValueError(f"a tensor map needs a contiguous last dim, got strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError("a tensor map needs a 16-byte aligned base address")
    dims = (hd, heads, length, b)
    strides, inner = [], hd * es
    for extent, stride in zip(dims[1:], (t.stride(2), t.stride(1), t.stride(0))):
        step = inner if extent == 1 else stride * es
        if step % 16 or not 0 < step < 2**40:
            raise ValueError(f"TMA takes byte strides that are multiples of 16 below 2^40, got {step} "
                             f"(element strides {t.stride()})")
        strides.append(step)
        inner = step * extent
    return dims, tuple(strides), (hd, 1, TILE, 1)


def _maps(*views) -> ctypes.Array:
    """The 11 fields of each view's tensor map, back to back."""
    fields = [x for t in views for part in tensor_map(t) for x in part]
    return (ctypes.c_longlong * len(fields))(*fields)


def grids(dtype: torch.dtype, b: int, length: int, heads: int) -> dict[str, tuple[int, int]]:
    """(blocks, threads per block) of each kernel of ``csrc/attention.cu`` for
    ``[b, length, heads, 64]`` operands: the forward, the backward's dQ and
    dK/dV kernels, and the D pass.  bf16: a block per (row, head, 64 rows),
    a consumer and a producer warpgroup; f32: a block of four warps per
    (row, head, 64 rows).  The kernels refuse another grid."""
    tiles = (b * heads * -(-length // TILE), 256 if dtype == torch.bfloat16 else 128)
    lanes = HEAD_DIM * torch.finfo(dtype).bits // 8 // 16
    rowdot = (-(-b * length * heads * lanes // _ROWDOT_THREADS), _ROWDOT_THREADS)
    return {"forward": tiles, "dq": tiles, "dkv": tiles, "rowdot": rowdot}


def _check_operands(name, q, k, v, attention_mask, segment_ids, *more) -> None:
    """Raise on what the kernels do not take: one CUDA device, bf16 or f32
    ``q``, ``k``, ``v`` (and ``more``, each of their shape and dtype) of one
    shape ``[B, L, heads, 64]`` with a contiguous last dim and 16-byte
    aligned rows, masks ``[B, L]``, and L <= MAX_BF16_LENGTH in bf16."""
    tensors = (q, k, v, attention_mask, *more) + (() if segment_ids is None else (segment_ids,))
    if not q.is_cuda or any(t.device != q.device for t in tensors):
        raise ValueError(f"{name} needs every tensor on one CUDA device")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v, *more)):
        raise ValueError(f"{name} takes bf16 or f32 q, k, v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or q.shape[-1] != HEAD_DIM or any(t.shape != q.shape for t in (k, v, *more)):
        raise ValueError(f"q, k, v must share one [B, L, heads, {HEAD_DIM}] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, length = q.shape[:2]
    if attention_mask.shape != (b, length) or (segment_ids is not None and segment_ids.shape != (b, length)):
        raise ValueError(f"the masks must be [B, L] = [{b}, {length}]")
    if q.dtype == torch.bfloat16 and length > MAX_BF16_LENGTH:
        raise ValueError(f"{name} takes bf16 rows of at most {MAX_BF16_LENGTH} tokens, got {length}")
    unit = 16 // q.element_size()  # elements in a 16-byte load
    for t in (q, k, v, *more):
        if t.stride(-1) != 1 or any(s % unit for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous last dim and 16-byte aligned rows, got strides {t.stride()}")


def kernel_masks(attention_mask, segment_ids):
    """The masks as the kernels read them: contiguous int32 ``[B, L]`` (no
    copy where they already are, so a caller that converts once serves
    every layer's launch)."""
    mask = attention_mask.to(torch.int32).contiguous()
    return mask, None if segment_ids is None else segment_ids.to(torch.int32).contiguous()


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: {lib.masked_attention_error_string(rc).decode()} ({rc})")


def masked_attention_cuda(q, k, v, attention_mask, segment_ids, scale: float, residuals: bool = False):
    """The Hopper kernel (``csrc/attention.cu``) on the current stream: bf16
    or f32 ``q``, ``k``, ``v`` of one shape ``[B, L, heads, 64]`` on one CUDA
    device, each with a contiguous last dim and 16-byte aligned rows; the
    masks ``[B, L]`` on the same device.  With ``residuals``, ``(out, m,
    l)`` as ``masked_attention_plain`` gives them.  It computes no gradient:
    ``MaskedAttention`` is the differentiable form, and a call here with a
    gradient needed raises."""
    _check_operands("masked_attention_cuda", q, k, v, attention_mask, segment_ids)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("masked_attention_cuda computes no gradient: call masked_attention (MaskedAttention)")
    b, length, heads, hd = q.shape
    out = torch.empty((b, length, heads, hd), dtype=q.dtype, device=q.device)
    stats = torch.empty((2, b, heads, length), dtype=torch.float32, device=q.device) if residuals else None
    if out.numel() == 0:
        return (out, *stats) if residuals else out
    maps = _maps(q, k, v, out) if q.dtype == torch.bfloat16 else None
    mask, seg = kernel_masks(attention_mask, segment_ids)
    lib = _bind()
    rc = lib.masked_attention(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if stats is None else stats[0].data_ptr(), None if stats is None else stats[1].data_ptr(),
        mask.data_ptr(), None if seg is None else seg.data_ptr(),
        (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3]), maps,
        b, length, heads, hd, scale, grids(q.dtype, b, length, heads)["forward"][0],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(lib, rc, "masked_attention")
    masked_attention_cuda.launches += 1
    return (out, *stats) if residuals else out


masked_attention_cuda.launches = 0


def rowdot_cuda(d_out: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The backward's D = rowsum(dO∘O) by its kernel (``csrc/attention.cu``
    ``rowdot_kernel``): ``d_out`` and ``out`` [B, L, heads, 64] of one dtype
    on the card (``out`` made contiguous, ``d_out`` with a contiguous last
    dim and 16-byte aligned rows) → f32 ``[B, heads, L]``, the products
    summed in f32 without the f32 copies of the two tensors."""
    out = out.contiguous()
    b, length, heads, hd = out.shape
    d = torch.empty((b, heads, length), dtype=torch.float32, device=out.device)
    if d.numel() == 0:
        return d
    lib = _bind()
    rc = lib.masked_attention_rowdot(
        _DTYPES[out.dtype], d_out.data_ptr(), out.data_ptr(), d.data_ptr(),
        (ctypes.c_longlong * 3)(*d_out.stride()[:3]), b, length, heads, grids(out.dtype, b, length, heads)["rowdot"][0],
        torch.cuda.current_stream(out.device).cuda_stream,
    )
    _raise_on(lib, rc, "masked_attention_rowdot")
    return d


def masked_attention_backward_cuda(q, k, v, out, m, l, d_out, attention_mask, segment_ids, scale: float):
    """The backward kernels (``csrc/attention.cu``) on the current stream:
    the operands as ``masked_attention_cuda`` takes them, its output ``out``
    and residuals ``m``, ``l``, the output's gradient ``d_out`` → ``(dq, dk,
    dv)``, the three planes of one contiguous ``[B, L, 3, heads, 64]``
    buffer.  ``D = rowsum(dO∘O)`` is the first of its three launches
    (``rowdot_cuda``), as JAX computes it outside its two kernels."""
    d_out = d_out if d_out.stride(-1) == 1 and d_out.data_ptr() % 16 == 0 else d_out.contiguous()
    _check_operands("masked_attention_backward_cuda", q, k, v, attention_mask, segment_ids, out, d_out)
    b, length, heads, hd = q.shape
    if m.shape != (b, heads, length) or l.shape != m.shape:
        raise ValueError(f"the residuals must be [B, heads, L] = [{b}, {heads}, {length}]")
    dqkv = torch.empty((b, length, 3, heads, hd), dtype=q.dtype, device=q.device)
    if dqkv.numel() == 0:
        return dqkv.unbind(2)
    maps = _maps(q, k, v, d_out, *dqkv.unbind(2)) if q.dtype == torch.bfloat16 else None
    d = rowdot_cuda(d_out, out)
    m, l = m.float().contiguous(), l.float().contiguous()
    mask, seg = kernel_masks(attention_mask, segment_ids)
    lib = _bind()
    rc = lib.masked_attention_backward(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), d_out.data_ptr(), m.data_ptr(), l.data_ptr(),
        d.data_ptr(), mask.data_ptr(), None if seg is None else seg.data_ptr(), dqkv.data_ptr(),
        (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *d_out.stride()[:3]), maps,
        b, length, heads, hd, scale, grids(q.dtype, b, length, heads)["dq"][0],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(lib, rc, "masked_attention_backward")
    masked_attention_backward_cuda.launches += 1
    return dqkv.unbind(2)


masked_attention_backward_cuda.launches = 0


class MaskedAttention(torch.autograd.Function):
    """Differentiable masked attention of ``q``, ``k``, ``v`` [B, L, heads,
    hd]: the forward saves its output and residuals ``m``, ``l``; the
    backward recomputes ``P`` from them.  The device alone picks the
    backend: the kernels for tensors on the card (a failed build or launch
    raises), the plain versions for tensors on the CPU.  Under
    ``torch.utils.checkpoint`` the recompute runs this forward again and
    saves the same residuals."""

    @staticmethod
    def forward(ctx, q, k, v, attention_mask, segment_ids, scale: float):
        fwd = masked_attention_cuda if q.is_cuda else masked_attention_plain
        out, m, l = fwd(q, k, v, attention_mask, segment_ids, scale, residuals=True)
        ctx.save_for_backward(q, k, v, out, m, l, attention_mask, segment_ids)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, m, l, attention_mask, segment_ids = ctx.saved_tensors
        if q.is_cuda:
            dq, dk, dv = masked_attention_backward_cuda(q, k, v, out, m, l, d_out, attention_mask, segment_ids,
                                                        ctx.scale)
        else:  # one [B, L, 3, heads, hd] buffer, as the kernels write it
            grads = masked_attention_backward_plain(q, k, v, out, m, l, d_out, attention_mask, segment_ids, ctx.scale)
            dq, dk, dv = torch.stack(grads, dim=2).unbind(2)
        return dq, dk, dv, None, None, None


class _SplitQKV(torch.autograd.Function):
    """``qkv.unbind(2)`` whose backward hands back the one buffer that the
    attention backward writes the three gradients into (no copy), and
    stacks them otherwise."""

    @staticmethod
    def forward(ctx, qkv):
        return qkv.unbind(2)

    @staticmethod
    def backward(ctx, dq, dk, dv):
        base = dq._base
        if (base is not None and dk._base is base and dv._base is base and base.dim() == 5
                and base.is_contiguous() and base.shape[2] == 3 and base.shape[:2] == dq.shape[:2]
                and base.shape[3:] == dq.shape[2:]
                and [t.data_ptr() for t in (dq, dk, dv)] == [base[:, :, i].data_ptr() for i in range(3)]):
            return base
        return torch.stack((dq, dk, dv), dim=2)


def split_qkv(qkv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``q``, ``k``, ``v`` views of the fused projection ``qkv`` [B, L, 3,
    heads, hd]; where a gradient is needed, one whose backward passes the
    attention backward's ``[B, L, 3, heads, hd]`` gradient on whole."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _SplitQKV.apply(qkv)
    return qkv.unbind(2)


def masked_attention(q, k, v, attention_mask, segment_ids, scale: float) -> torch.Tensor:
    """Masked attention of ``q``, ``k``, ``v`` [B, L, heads, hd].  A tensor on
    the card goes to the kernel (which raises on what it does not take); a
    tensor on the CPU goes to the plain version; where a gradient is
    needed, through ``MaskedAttention``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return MaskedAttention.apply(q, k, v, attention_mask, segment_ids, scale)
    if q.is_cuda:
        return masked_attention_cuda(q, k, v, attention_mask, segment_ids, scale)
    return masked_attention_plain(q, k, v, attention_mask, segment_ids, scale)
