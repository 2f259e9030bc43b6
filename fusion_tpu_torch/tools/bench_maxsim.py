"""MaxSim kernel-family bench on one NVIDIA GPU: every MaxSim kernel of the
port at one shape, each against a blocked einsum reference.

The counterpart of ``scripts/bench_maxsim.py`` and ``scripts/bench_maxsim2.py``,
whose TPU variants map onto the port's two kernels:

  * K1 (``maxsim_maxima_cuda``) — the serving kernel, doc-major maxima;
  * K1-v1 (``maxsim_fused_cuda``, strict mask) — ``maxsim_scores_pallas``'s
    kernel, over a realistic mask (40-128 valid tokens per doc, every 997th
    doc fully masked);
  * fused, zeroed (``maxsim_fused_cuda`` without a mask) — ``_kernel_fusedsum``;
  * K1-v2 f32 (``maxsim_maxima_v2_cuda``) — ``_kernel_f32max`` and
    ``_kernel_dotgen`` (and the TPU kernel in interpret mode);
  * K1-v2 bf16 — ``_maxsim_v2_kernel_3d`` compiled, ``_kernel_bf16max`` (both
    benches) and ``_kernel_dotgen_bf16``;
  * K1-v2 f32 with ``tchunk`` doc tokens per ring stage — ``_kernel_chunked``.

For reference it also times cuBLAS's bf16 matmul of the same multiply-adds
(``[Ld·N, D] × [D, QL]``, f32 out, in row blocks, no max): a library product
of the same FLOPs, not the same function.

Inputs are seeded bf16 normals (queries [Q, Lq, D], a token-major corpus
[Ld, N, D] whose masked tokens are zero).  Times are device times: each of
``runs`` calls sits between two CUDA events queued behind a short device
sleep, so no host time falls inside; the median is reported.  Errors are the
largest |kernel - reference| against a blocked f32 einsum of the same
semantics, within 1e-2 + 1e-3·|ref| (plus one bf16 ulp of the reference for
the bf16 reduce).  ``bound_ms`` is the least time an H100 SXM could take:
the larger of the multiply-adds at 989 TFLOP/s (dense bf16) and the bytes
(each input read once, each output written once) at 3.35 TB/s.

Run on the card (one JSON line):
    python -m fusion_tpu_torch.tools.bench_maxsim [--q 32] [--lq 32] [--n 28032]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch

from fusion_tpu_torch.ops import maxsim

# H100 SXM peaks (NVIDIA's data sheet, dense): bf16 tensor cores, f32
# outside them, HBM3
PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_BYTES = 989e12, 67e12, 3.35e12
TOL = (1e-2, 1e-3)  # atol, rtol: bf16 products summed in f32 in another order


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    """(least time in ms on an H100 SXM, what bounds it): ``flops`` at
    ``peak_flops`` against ``nbytes`` at 3.35 TB/s, whichever is larger."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    return torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 8)


def device_ms(fn, runs: int, sleep_cycles: int = 2_000_000) -> float:
    """Median device time (ms) of ``fn()`` over ``runs`` calls, each between
    two CUDA events enqueued behind a ~1 ms device sleep."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def make_inputs(q: int, lq: int, n: int, ld: int, d: int, seed: int, device="cuda"):
    """(q_flat bf16 [Q·Lq, D], q_mask f32 [Q, Lq] of ones, corpus_tm bf16
    [Ld, N, D] with masked tokens zero, mask_tm f32 [Ld, N])."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q_flat = torch.randn(q * lq, d, device=device, generator=gen).to(torch.bfloat16)
    valid = torch.randint(min(40, ld), ld + 1, (n,), device=device, generator=gen)
    mask_tm = (torch.arange(ld, device=device)[:, None] < valid[None, :]).float()
    mask_tm[:, ::997] = 0.0  # a few fully masked docs
    corpus_tm = torch.empty((ld, n, d), dtype=torch.bfloat16, device=device)
    for t in range(ld):
        corpus_tm[t] = (torch.randn(n, d, device=device, generator=gen) * mask_tm[t, :, None]).to(torch.bfloat16)
    return q_flat, torch.ones((q, lq), device=device), corpus_tm, mask_tm


def reference(q_flat, q_mask, corpus_tm, mask_tm, doc_block: int = 1024):
    """Blocked f32 einsum: (zeroed maxima [QL, N], zeroed scores [Q, N],
    strict scores [Q, N])."""
    ld, n, _ = corpus_tm.shape
    q, lq = q_mask.shape
    qf = q_flat.float()
    maxima = torch.empty((q * lq, n), device=q_flat.device)
    strict = torch.empty((q * lq, n), device=q_flat.device)
    for s in range(0, n, doc_block):
        sims = torch.einsum("tbd,jd->jtb", corpus_tm[:, s : s + doc_block].float(), qf)
        maxima[:, s : s + sims.shape[2]] = sims.amax(dim=1)
        keep = mask_tm[None, :, s : s + doc_block] > 0
        strict[:, s : s + sims.shape[2]] = torch.where(keep, sims, maxsim._NEG).amax(dim=1).clamp(min=maxsim._NEG)

    def qsum(m):
        return (m.T.reshape(n, q, lq) * q_mask[None]).sum(dim=-1).T

    return maxima, qsum(maxima), qsum(strict)


def library_matmul(q_flat, corpus_tm, rows: int = 1 << 17):
    """cuBLAS bf16 [Ld·N, D] × [D, QL] → f32, in row blocks (no max)."""
    flat = corpus_tm.reshape(-1, corpus_tm.shape[2])
    qt = q_flat.T
    for s in range(0, flat.shape[0], rows):
        torch.mm(flat[s : s + rows], qt, out_dtype=torch.float32)


def run(q: int = 32, lq: int = 32, n: int = 28_032, ld: int = 128, d: int = 128, runs: int = 10,
        seed: int = 0, tchunks=(2, 4, 8)) -> dict:
    """Time and check every variant at one shape; returns the record."""
    if not torch.cuda.is_available():
        raise RuntimeError("the MaxSim bench measures the card: no CUDA device is available")
    q_flat, q_mask, corpus_tm, mask_tm = make_inputs(q, lq, n, ld, d, seed)
    ref_maxima, ref_zeroed, ref_strict = reference(q_flat, q_mask, corpus_tm, mask_tm)
    ql = q * lq
    flops = 2.0 * ql * n * ld * d
    in_bytes = corpus_tm.nbytes + q_flat.nbytes
    v2 = maxsim.maxsim_maxima_v2_cuda
    variants = [
        # name, replaces, counter, call, reference, extra bytes read, bytes written, bf16 reduce
        ("K1", "fusion_tpu/ops/maxsim.py:225 _maxsim_kernel_T", maxsim.maxsim_maxima_cuda,
         lambda: maxsim.maxsim_maxima_cuda(q_flat, corpus_tm), ref_maxima.T, 0, 4 * ql * n, False),
        ("K1-v1 strict", "fusion_tpu/ops/maxsim.py:67 _maxsim_kernel", maxsim.maxsim_fused_cuda,
         lambda: maxsim.maxsim_fused_cuda(q_flat, q_mask, corpus_tm, mask_tm), ref_strict,
         mask_tm.nbytes + q_mask.nbytes, 4 * q * n, False),
        ("fused zeroed", "scripts/bench_maxsim.py:55 _kernel_fusedsum", maxsim.maxsim_fused_cuda,
         lambda: maxsim.maxsim_fused_cuda(q_flat, q_mask, corpus_tm), ref_zeroed,
         q_mask.nbytes, 4 * q * n, False),
        ("K1-v2 f32", "scripts/bench_maxsim.py:239 _kernel_f32max; scripts/bench_maxsim2.py:25 "
         "_kernel_dotgen", v2, lambda: v2(q_flat, corpus_tm, "f32"), ref_maxima, 0, 4 * ql * n, False),
        ("K1-v2 bf16", "fusion_tpu/ops/maxsim.py:148 _maxsim_v2_kernel_3d; scripts/bench_maxsim.py:26 "
         "and scripts/bench_maxsim2.py:15 _kernel_bf16max; scripts/bench_maxsim2.py:34 "
         "_kernel_dotgen_bf16", v2, lambda: v2(q_flat, corpus_tm, "bf16"), ref_maxima, 0, 4 * ql * n, True),
    ] + [
        (f"K1-v2 f32 tchunk {t}", "scripts/bench_maxsim.py:37 _kernel_chunked", v2,
         lambda t=t: v2(q_flat, corpus_tm, "f32", t), ref_maxima, 0, 4 * ql * n, False)
        for t in tchunks if maxsim.maxima_stages(d, t) >= 1
    ]
    atol, rtol = TOL
    out = []
    for name, replaces, counter, call, ref, extra_in, out_bytes, bf16 in variants:
        got = call()
        torch.cuda.synchronize()
        err = (got - ref).abs()
        allowed = atol + rtol * ref.abs() + (bf16_ulp(ref) if bf16 else 0.0)
        before = counter.launches
        ms = device_ms(call, runs)
        bound_ms, bound_by = bound(flops, in_bytes + extra_in + out_bytes)
        out.append({
            "name": name, "replaces": replaces, "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "ms_over_bound": ms / bound_ms, "max_abs_err": err.max().item(),
            "within_bound": bool((err <= allowed).all()), "launches": counter.launches - before,
        })
        del got, err, allowed
    lib_ms = device_ms(lambda: library_matmul(q_flat, corpus_tm), runs)
    kernels = [v for v in out if v["within_bound"]]
    return {
        "device": torch.cuda.get_device_name(0),
        "shape": {"Q": q, "Lq": lq, "QL": ql, "N": n, "Ld": ld, "D": d},
        "runs": runs,
        "variants": out,
        "library_matmul_same_flops_ms": lib_ms,
        "fastest": min(kernels, key=lambda v: v["ms"])["name"] if kernels else None,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--q", type=int, default=32)
    ap.add_argument("--lq", type=int, default=32)
    ap.add_argument("--n", type=int, default=28_032)
    ap.add_argument("--ld", type=int, default=128)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: the MaxSim bench measures the card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    record = run(args.q, args.lq, args.n, args.ld, args.d, args.runs, args.seed)
    print(json.dumps(record), flush=True)
    return 0 if all(v["within_bound"] and v["launches"] > 0 for v in record["variants"]) else 1


if __name__ == "__main__":
    sys.exit(main())
