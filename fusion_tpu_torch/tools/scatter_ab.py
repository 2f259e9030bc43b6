"""Side-by-side device times of builds of the scatter kernels on one NVIDIA GPU.

Each variant is a source file with the C interface of
``csrc/scatter_score.cu`` (``scatter_pregathered``, ``scatter_binmax``) and
optional ``-D`` macros, given as ``NAME=PATH`` or ``NAME=PATH:MACRO,MACRO``:
an older revision of the file, or a copy with parts compiled out.  Every
variant is built at once (one ``nvcc`` each, the package's flags, ``-I`` the
package's ``csrc/``) and then, at the probe shape
(``probe_scatter_layout.synth_index``: Q 64, Kq 64, 544 chunks of 16,384,
capc 32), held to the plain versions (a variant with parts compiled out
shows as not within the tolerance: it is timed all the same) and timed:
P5 (chunk-major), P4 (term-major) and K3, the median device time of
``--runs`` calls (``bench_maxsim.device_ms``), over rounds that take the
variants in order and then in reverse, so drift hits all alike.

Run on the card (one JSON line; each variant's ptxas report on stderr):
    python -m fusion_tpu_torch.tools.scatter_ab old=old.cu new=fusion_tpu_torch/csrc/scatter_score.cu
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from fusion_tpu_torch.ops import _kernels, scatter_score
from fusion_tpu_torch.tools.bench_maxsim import device_ms
from fusion_tpu_torch.tools.probe_scatter_layout import synth_index

BUILD_DIR = _kernels.BUILD_DIR / "ab"
TOL = (1e-6, 1e-5)  # atol, rtol: chip_smoke.py's K3_TOL


def parse_variant(spec: str) -> tuple[str, str, list[str]]:
    """``NAME=PATH[:MACRO,...]`` → (name, path, ["-DMACRO", ...])."""
    name, _, rest = spec.partition("=")
    path, _, macros = rest.partition(":")
    if not name or not path:
        raise ValueError(f"a variant is NAME=PATH[:MACRO,...], got {spec!r}")
    return name, path, [f"-D{m}" for m in macros.split(",") if m]


def build(name: str, path: str, defines: list[str]) -> str:
    """Compiles one variant into ``BUILD_DIR/lib<name>.so``; returns the
    compiler's report.  The source is compiled from a copy of its own,
    ``BUILD_DIR/<name>.cu``: nvcc names a file's anonymous namespace after its
    path, so two libraries built from one path would share the static
    variables of their functions in one process."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / f"{name}.cu"
    shutil.copyfile(path, src)
    proc = subprocess.run(
        [_kernels._nvcc(), *_kernels.NVCC_FLAGS, f"-I{_kernels.CSRC_DIR}", *defines,
         "-o", str(BUILD_DIR / f"lib{name}.so"), str(src)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {path} {defines}:\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout + proc.stderr


def bind(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
    lib.scatter_pregathered.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.scatter_binmax.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return lib


def within(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Packed bins against the plain version's: the -inf pattern and the
    scores with their 4 packed bits cleared."""
    fin = torch.isfinite(want)
    clean = lambda x: (x.view(torch.int32) & -16).view(torch.float32)  # noqa: E731
    diff = torch.where(fin, (clean(got) - clean(want)).abs(), 0.0)
    tol = TOL[0] + TOL[1] * torch.where(fin, clean(want).abs(), 0.0)
    return {"pattern_equal": bool((torch.isfinite(got) == fin).all()), "max_abs_err": diff.max().item(),
            "within_tol": bool((diff <= tol).all())}


def run(variants: list[str], rounds: int = 2, runs: int = 10) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the scatter A/B measures the card: no CUDA device is available")
    specs = [parse_variant(v) for v in variants]
    with ThreadPoolExecutor(len(specs)) as pool:
        logs = list(pool.map(lambda s: build(*s), specs))
    libs = [bind(name) for name, _, _ in specs]
    dpc = 16_384
    index, qt, qw = synth_index()
    pd, pi = index.post_doc, index.post_impact
    stream = torch.cuda.current_stream().cuda_stream
    ops = {"chunk_major": scatter_score._gather_postings(qt, qw, pd, pi, 16),
           "term_major": scatter_score.gather_postings_term_major(qt, qw, pd, pi, 16)}

    def calls(lib):
        out = torch.empty((qt.shape[0], ops["chunk_major"][0].shape[1] * dpc // 16), device="cuda")
        fns = {}
        for layout, (docs, vals) in ops.items():
            q, kq, cp, capc = (docs.shape[0], 1, *docs.shape[1:]) if docs.dim() == 3 else docs.shape
            fns[layout] = lambda d=docs, v=vals, q=q, kq=kq, cp=cp, capc=capc, lay=layout: (
                lib.scatter_pregathered(d.data_ptr(), v.data_ptr(), out.data_ptr(), q, cp, kq, capc, dpc,
                                        scatter_score.LAYOUTS.index(lay), stream), out)
        fns["K3"] = lambda: (lib.scatter_binmax(qt.data_ptr(), qw.data_ptr(), pd.data_ptr(), pi.data_ptr(),
                                                out.data_ptr(), qt.shape[0], qt.shape[1], pd.shape[0],
                                                pd.shape[1], pd.shape[2], dpc, stream), out)
        return fns

    fns = {name: calls(lib) for (name, _, _), lib in zip(specs, libs)}
    want = {lay: scatter_score.scatter_pregathered_plain(*ops[lay], dpc, lay) for lay in ops}
    want["K3"] = scatter_score.scatter_binmax_plain(qt, qw, pd, pi, dpc)[:, : want["chunk_major"].shape[1]]
    checks = {}
    for name, per in fns.items():
        for kind, fn in per.items():
            rc, out = fn()
            if rc != 0:
                raise RuntimeError(f"{name} {kind}: launch failed ({rc})")
            n = want[kind].shape[1]
            checks[f"{name}/{kind}"] = within(out[:, :n], want[kind])
    del want
    times: dict[str, list[float]] = {}
    order = list(fns)
    for r in range(rounds):
        for name in order if r % 2 == 0 else order[::-1]:
            for kind, fn in fns[name].items():
                times.setdefault(f"{name}/{kind}", []).append(device_ms(fn, runs))
    for (name, _, _), log in zip(specs, logs):
        print(f"== {name}\n{log}", file=sys.stderr, flush=True)
    return {"metric": "scatter_ab", "detail": {
        "variants": {name: [path, defines] for name, path, defines in specs}, "device_ms": times,
        "checks": checks, "runs": runs, "device": torch.cuda.get_device_name(0)}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="+", help="NAME=PATH[:MACRO,...]")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--runs", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: the scatter A/B measures the card", file=sys.stderr)
        return 1
    print(json.dumps(run(args.variants, args.rounds, args.runs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
