"""Run one cell of the benchmark and print its result line.

    python -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``, from process start to the first timed query): the
inputs from the seed, the program's searcher over them, the cell's shapes
warmed.  Then the window, ``--seconds`` long, with the traffic mix's loop;
with ``--trace 1`` its first calls run under the profiler, the spans and
the kernel events.  After the window: the peak memory is read, the
program's state freed, and the checked queries judged against the plain
reference (``check.py``).  The last line of standard output is the result
(JSON); the numbers compared, each beside its limit, close standard error
and the result line.  Without a card, or with fewer than the cell asks
for, it exits 2 and prints no result; with JAX or the JAX package loaded
once the window has closed, 3.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the program's build and kernel caches live at fixed paths inside the
# checkout, so only a cell's first run there builds (the port's own kernels
# build into fusion_tpu_torch/_build/)
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "perfbench", ".cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "perfbench", ".cache", "torch_extensions")

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "fusion_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole (``fusion_tpu_torch`` is not
    ``fusion_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device="cuda", t0: float | None = None,
             keep: bool = False, variant: str | None = None) -> dict:
    import numpy as np
    import torch

    from perfbench import check, trace as tracing
    from perfbench.corpus import make_inputs
    from perfbench.reference.hybrid import HybridReference

    t0 = T0 if t0 is None else t0
    cfg, mix = cell["cfg"], cell["mix"]
    on_card = torch.device(device).type == "cuda"
    system_mod = importlib.import_module(f"perfbench.systems.{cfg['system']}")
    loop_mod = importlib.import_module(f"perfbench.loops.{mix['loop']}")

    inputs = make_inputs(cfg, mix, seed, device)
    system = system_mod.build(cfg, mix, inputs, device)
    if variant is not None:  # the control: one of the program's own lower-precision paths
        system = getattr(system_mod, variant)(system)
    loop = loop_mod.Loop(system, inputs, cfg, mix, seed)
    loop.warm()
    if trace:
        # the profiler's first use pays its start-up: here, not in the window
        with torch.profiler.profile(activities=_activities(torch, on_card)):
            loop.warm()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    tracer = profiler = None
    if trace:
        tracer = tracing.Tracer(system_mod.span_targets(system), system_mod.kernel_counters())
        tracer.install()
        profiler = torch.profiler.profile(activities=_activities(torch, on_card))
    res = loop.window(seconds, tracer, profiler)
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    metrics = {}
    e2e = {**res["e2e"], "peak_device_gib": peak / 2**30, "setup_s": setup_s}
    record = None
    if trace:
        record = tracing.reduce(profiler, tracer, res["traced_s"]) if on_card else {"window_s": res["traced_s"]}
        tracer.uninstall()
        record.update(loop.trace_record(res, record))
        summary = {k: v for k, v in record.items() if k not in ("breakdown", "kernel_shapes")}
        summary["kernel_shapes"] = {k: sorted(set(v)) for k, v in record.get("kernel_shapes", {}).items()}
        print("trace record: " + json.dumps(summary, default=str), file=sys.stderr, flush=True)
        for m in cell["per_layer"]:
            value = tracing_read(m["name"], record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    # the program's state goes before the reference runs
    del system, loop, profiler, tracer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = HybridReference(cfg, inputs, device)
    rows = res["check_rows"]
    if len(rows):
        ref_scores = {leg: s.double().cpu().numpy() for leg, s in ref.leg_scores(rows).items()}
        readings = check.judge(res["out"], ref_scores, lambda head: ref.cross_logits(rows, head).cpu().numpy(),
                               inputs.n_docs, mix.get("rerank_depth", 0))
    else:  # no answer to check came back: nothing is correct
        ref_scores, readings = {}, {name: math.inf for name in cfg["check"]["limits"]}
    ok, table = check.verdict(readings, cfg["check"]["limits"])
    out = {
        "correct": bool(ok and res["failed"] == 0 and res.get("unchecked", 0) == 0),
        "attempted": res["attempted"],
        "failed": res["failed"],
        "metrics": metrics,
        "device": device_info(torch, on_card, peak, record),
    }
    if record and "breakdown" in record:
        out["breakdown"] = record["breakdown"]
    out["checks"] = table
    if keep:
        out["_keep"] = {"inputs": inputs, "rows": rows, "ref": ref, "ref_scores": ref_scores, "res": res,
                        "readings": readings}
    return out


def _activities(torch, on_card: bool) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def tracing_read(name: str, record: dict):
    from perfbench.spec import reader

    value = reader(name)(record)
    return None if value is None or not math.isfinite(value) else float(value)


def device_info(torch, on_card: bool, peak: int, record: dict | None) -> dict:
    info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    if record and "busy_s" in record:
        info["busy_s"] = record["busy_s"]
        info["window_s"] = record["window_s"]
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA device(s), found {have}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"perfbench: modules that must not load in a run were loaded: {found}", file=sys.stderr)
        return 3
    for name, row in out["checks"].items():
        print(f"check {name}: {row['value']!r} (limit {row['limit']!r})", file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
