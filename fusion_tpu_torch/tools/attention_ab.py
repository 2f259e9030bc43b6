"""Side-by-side times of builds of the masked-attention forward (FA) on one NVIDIA GPU.

Each variant is a source file with the C interface of ``csrc/attention.cu``
(``masked_attention``), given as ``NAME=PATH``: an older revision of the
file (``git show REV:fusion_tpu_torch/csrc/attention.cu > _scratch/old.cu``)
or a copy with changes.  A build that also exports
``masked_attention_backward`` takes the residual pointers of the current
interface (passed null: the inference call); an older one takes the
interface without them.  Every variant is built at once (one ``nvcc`` each,
from a copy of its own, as ``scatter_ab`` builds), checked bit-equal to the
first variant's output, and timed at the serving shapes: packed rerank rows
([128, 256, 12, 64] bf16, pairs of 20-60 tokens with segment ids) and one
layer's doc call of the ColBERT bench step ([1024, 256, 12, 64] bf16, every
token real): CUDA-event medians of single calls over rounds that take the
variants in order and then in reverse, so drift hits all alike.

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

from fusion_tpu_torch.ops.attention import _masks
from fusion_tpu_torch.tools import scatter_ab

P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def bind(name: str):
    """The variant's forward as ``f(q, k, v, mask, seg, scale) -> out``."""
    lib = ctypes.CDLL(str(scatter_ab.BUILD_DIR / f"lib{name}.so"))
    residual_args = hasattr(lib, "masked_attention_backward")
    lib.masked_attention.argtypes = [I, P, P, P, P] + [P, P] * residual_args + [P, P, P, LL, I, I, I,
                                                                                 ctypes.c_float, P]
    lib.masked_attention.restype = I

    def call(q, k, v, mask, seg, scale):
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        m, s = _masks(mask, seg)
        rc = lib.masked_attention(
            0 if q.dtype == torch.bfloat16 else 1, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *([None, None] if residual_args else []), m.data_ptr(), None if s is None else s.data_ptr(),
            (LL * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3]), q.shape[0], q.shape[1], q.shape[2],
            q.shape[3], scale, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name}: masked_attention launch failed ({rc})")
        return out

    return call


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
    """name → (q, k, v views of one fused qkv, key mask, segment ids or None)
    at the two shapes."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for name, (b, mask, s) in {"packed": (128, *packed_rows(128, 256, seed)),
                               "bench_doc": (1024, torch.ones((1024, 256), dtype=torch.int32, device="cuda"),
                                             None)}.items():
        qkv = torch.randn((b, 256, 3, 12, 64), generator=gen, device="cuda").bfloat16()
        out[name] = (*qkv.unbind(2), mask, s)
    return out


def run(variants: list[str], rounds: int = 4, runs: int = 5) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the attention A/B measures the card: no CUDA device is available")
    specs = [scatter_ab.parse_variant(v) for v in variants]
    with ThreadPoolExecutor(len(specs)) as pool:
        logs = list(pool.map(lambda s: scatter_ab.build(*s), specs))
    fns = {name: bind(name) for name, _, _ in specs}
    cases = shapes()
    first = specs[0][0]
    times: dict[str, list[float]] = {}
    bit_equal = {}
    with torch.no_grad():
        for case, args in cases.items():
            want = fns[first](*args, 0.125)
            for name, fn in fns.items():
                bit_equal[f"{name}/{case}"] = bool(torch.equal(fn(*args, 0.125), want))
            order = list(fns)
            for r in range(rounds):
                for name in order if r % 2 == 0 else order[::-1]:
                    for _ in range(runs):
                        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                        start.record()
                        fns[name](*args, 0.125)
                        end.record()
                        torch.cuda.synchronize()
                        times.setdefault(f"{name}/{case}", []).append(start.elapsed_time(end))
    for (name, _, _), log in zip(specs, logs):
        print(f"== {name}\n{log}", file=sys.stderr, flush=True)
    return {"metric": "attention_ab", "detail": {
        "variants": {name: path for name, path, _ in specs}, "ms": {k: statistics.median(v) for k, v in times.items()},
        "bit_equal_to_first": bit_equal, "calls": rounds * runs, "device": torch.cuda.get_device_name(0)}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="+", help="NAME=PATH")
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
