"""Side-by-side times of builds of the masked-attention kernels, forward (FA) and backward (FA-bwd), on one NVIDIA GPU.

Each variant is a source file with the C interface of ``csrc/attention.cu``
and optional ``-D`` macros, given as ``NAME=PATH`` or
``NAME=PATH:MACRO,MACRO``: an older revision of the file (``git show
REV:fusion_tpu_torch/csrc/attention.cu > _scratch/old.cu``), or a copy with
changes.  Three interfaces are told apart by the symbols a build exports:

  * the current one (``masked_attention_rowdot``): bf16 operands by TMA
    tensor maps (``ops/attention.tensor_map``) and the grid of
    ``ops/attention.grids``; its backward is the D pass and the two
    kernels;
  * the previous one (``masked_attention_backward`` alone): pointers and
    strides; its backward is the torch reduction for D (as
    ``ops/attention.py`` formed it then) and its two kernels;
  * older builds without a backward, timed on the forward alone.

Every variant is built at once (one ``nvcc`` each, from a copy of its own,
as ``scatter_ab`` builds), its outputs held to the first variant's within
``chip_smoke.py``'s tolerances (ATTN_TOL for the forward, ATTN_BWD_TOL for
dq, dk, dv: a redesign sums in another order), and timed at the serving
shapes: packed rerank rows ([128, 256, 12, 64] bf16, pairs of 20-60 tokens
with segment ids) and one layer's doc call of the ColBERT bench step
([1024, 256, 12, 64] bf16, every token real): CUDA-event medians of single
calls over rounds that take the variants in order and then in reverse, so
drift hits all alike.  The backward takes one set of residuals, the first
variant's.

Run on the card (one JSON line; each variant's ptxas report on stderr):
    python -m fusion_tpu_torch.tools.attention_ab old=_scratch/old.cu new=fusion_tpu_torch/csrc/attention.cu
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from fusion_tpu_torch.ops import attention as att
from fusion_tpu_torch.tools import scatter_ab

P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
TOL = {"forward": (3e-2, 1e-2), "backward": (3e-2, 1e-2)}  # chip_smoke.py's ATTN_TOL / ATTN_BWD_TOL, bf16


def _stream():
    return torch.cuda.current_stream().cuda_stream


def bind(name: str):
    """The variant's ``(forward, backward)``: ``forward(q, k, v, mask, seg,
    scale, residuals=False)`` as ``masked_attention_cuda``,
    ``backward(q, k, v, out, m, l, d_out, mask, seg, scale) -> (dq, dk,
    dv)`` as ``masked_attention_backward_cuda`` (None for a build without
    one)."""
    lib = ctypes.CDLL(str(scatter_ab.BUILD_DIR / f"lib{name}.so"))
    current = hasattr(lib, "masked_attention_rowdot")
    has_bwd = hasattr(lib, "masked_attention_backward")
    fwd_args = [I, P, P, P, P] + [P, P] * has_bwd + [P, P, P]
    bwd_args = [I] + [P] * 10 + [P]
    if current:
        fwd_args, bwd_args = fwd_args + [P], bwd_args + [P]  # the tensor maps
        lib.masked_attention_rowdot.argtypes = [I, P, P, P, P, LL, I, I, LL, P]
    lib.masked_attention.argtypes = fwd_args + [LL, I, I, I, F] + [LL] * current + [P]
    if has_bwd:
        lib.masked_attention_backward.argtypes = bwd_args + [LL, I, I, I, F] + [LL] * current + [P]

    def blocks(which, b, length, heads):
        return [att.grids(torch.bfloat16, b, length, heads)[which][0]] if current else []

    def forward(q, k, v, mask, seg, scale, residuals=False):
        b, length, heads, hd = q.shape
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        st = torch.empty((2, b, heads, length), dtype=torch.float32, device=q.device) if residuals else None
        m, s = att.kernel_masks(mask, seg)
        rc = lib.masked_attention(
            0, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *([None if st is None else st[0].data_ptr(), None if st is None else st[1].data_ptr()] * has_bwd),
            m.data_ptr(), None if s is None else s.data_ptr(),
            (LL * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3]), *([att._maps(q, k, v, out)] * current),
            b, length, heads, hd, scale, *blocks("forward", b, length, heads), _stream())
        if rc != 0:
            raise RuntimeError(f"{name}: masked_attention launch failed ({rc})")
        return (out, st[0], st[1]) if residuals else out

    def backward(q, k, v, out, m, l, d_out, mask, seg, scale):
        b, length, heads, hd = q.shape
        dqkv = torch.empty((b, length, 3, heads, hd), dtype=q.dtype, device=q.device)
        if current:
            d = torch.empty((b, heads, length), dtype=torch.float32, device=q.device)
            rc = lib.masked_attention_rowdot(0, d_out.data_ptr(), out.data_ptr(), d.data_ptr(),
                                             (LL * 3)(*d_out.stride()[:3]), b, length, heads,
                                             att.grids(q.dtype, b, length, heads)["rowdot"][0], _stream())
            if rc != 0:
                raise RuntimeError(f"{name}: masked_attention_rowdot launch failed ({rc})")
        else:
            d = (d_out.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        ms, s = att.kernel_masks(mask, seg)
        rc = lib.masked_attention_backward(
            0, q.data_ptr(), k.data_ptr(), v.data_ptr(), d_out.data_ptr(), m.data_ptr(), l.data_ptr(), d.data_ptr(),
            ms.data_ptr(), None if s is None else s.data_ptr(), dqkv.data_ptr(),
            (LL * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *d_out.stride()[:3]),
            *([att._maps(q, k, v, d_out, *dqkv.unbind(2))] * current),
            b, length, heads, hd, scale, *blocks("dq", b, length, heads), _stream())
        if rc != 0:
            raise RuntimeError(f"{name}: masked_attention_backward launch failed ({rc})")
        return dqkv.unbind(2)

    return forward, backward if has_bwd else None


def packed_rows(b: int, length: int, seed: int, device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """(mask, segment ids) [b, length] of packed rows: pairs of 20-60 tokens
    back to back from segment 1, the tail padding (segment 0, mask 0)."""
    gen = torch.Generator().manual_seed(seed)
    seg = torch.zeros((b, length), dtype=torch.int32)
    for r in range(b):
        col, p = 0, 1
        while length - col >= 20:
            ln = min(int(torch.randint(20, 61, (1,), generator=gen)), length - col)
            seg[r, col : col + ln] = p
            col, p = col + ln, p + 1
    return (seg > 0).int().to(device), seg.to(device)


def shapes(seed: int = 1) -> dict:
    """name → (q, k, v views of one fused qkv, key mask, segment ids or None,
    the output's gradient) at the two shapes."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for name, (b, mask, s) in {"packed": (128, *packed_rows(128, 256, seed)),
                               "bench_doc": (1024, torch.ones((1024, 256), dtype=torch.int32, device="cuda"),
                                             None)}.items():
        qkv = torch.randn((b, 256, 3, 12, 64), generator=gen, device="cuda").bfloat16()
        d_out = torch.randn((b, 256, 12, 64), generator=gen, device="cuda").bfloat16()
        out[name] = (*qkv.unbind(2), mask, s, d_out)
    return out


def _within(got, want, tol) -> bool:
    atol, rtol = tol
    return bool(((got.float() - want.float()).abs() <= atol + rtol * want.float().abs()).all())


def _event_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def run(variants: list[str], rounds: int = 4, runs: int = 5) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the attention A/B measures the card: no CUDA device is available")
    specs = [scatter_ab.parse_variant(v) for v in variants]
    with ThreadPoolExecutor(len(specs)) as pool:
        logs = list(pool.map(lambda s: scatter_ab.build(*s), specs))
    fns = {name: bind(name) for name, _, _ in specs}
    first = specs[0][0]
    times: dict[str, list[float]] = {}
    within = {}
    with torch.no_grad():
        for case, (q, k, v, mask, seg, d_out) in shapes().items():
            fwd0, bwd0 = fns[first]
            want = fwd0(q, k, v, mask, seg, 0.125)
            out, m, l = fwd0(q, k, v, mask, seg, 0.125, residuals=True)
            want_b = bwd0(q, k, v, out, m, l, d_out, mask, seg, 0.125) if bwd0 else None
            calls = {}
            for name, (fwd, bwd) in fns.items():
                within[f"{name}/{case}/forward"] = _within(fwd(q, k, v, mask, seg, 0.125), want, TOL["forward"])
                calls[f"{name}/{case}/forward"] = lambda fwd=fwd: fwd(q, k, v, mask, seg, 0.125)
                if bwd and want_b:
                    got = bwd(q, k, v, out, m, l, d_out, mask, seg, 0.125)
                    within[f"{name}/{case}/backward"] = all(_within(g, w, TOL["backward"])
                                                            for g, w in zip(got, want_b))
                    calls[f"{name}/{case}/backward"] = lambda bwd=bwd: bwd(q, k, v, out, m, l, d_out, mask, seg,
                                                                           0.125)
            order = list(calls)
            for r in range(rounds):
                for key in order if r % 2 == 0 else order[::-1]:
                    for _ in range(runs):
                        times.setdefault(key, []).append(_event_ms(calls[key]))
            del want, out, m, l, want_b, calls
            torch.cuda.empty_cache()
    for (name, _, _), log in zip(specs, logs):
        print(f"== {name}\n{log}", file=sys.stderr, flush=True)
    return {"metric": "attention_ab", "detail": {
        "variants": {name: f"{path} {' '.join(d)}".strip() for name, path, d in specs},
        "ms": {k: statistics.median(v) for k, v in times.items()},
        "within_tol_of_first": within, "tol": TOL, "calls": rounds * runs,
        "device": torch.cuda.get_device_name(0)}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="+", help="NAME=PATH[:MACRO,...]")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: the attention A/B measures the card", file=sys.stderr)
        return 1
    print(json.dumps(run(args.variants, args.rounds, args.runs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
