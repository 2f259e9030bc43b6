"""The readings that set the limits of ``correct``: the program's over many
seeds (the lower readings) and the control's (the upper ones).

    python -m perfbench.control --workload <cell> --seeds 11 12 13 --control-seeds 11 12 13 --seconds 3
        --variants int8_path int8_rerank --variant-seeds 21 22 23   (one command line)

For each seed: a run of the cell as ``perfbench.run`` makes it (a short
window, no trace) gives the program's readings; for each control seed the
reference computed in float8 e4m3 (``precision="fp8"``, one step below the
configuration's bfloat16) is put in the program's place on the same
checked queries and judged by the same comparison; each ``--faults`` name
(``faults.planted``) runs the program with that answer altered on every
``--seeds`` seed.  One JSON line per run;
``--variants`` (default ``int8_path``) runs the program with each of its own
lower-precision paths switched on (``systems.<kind>.<variant>``) on every
``--variant-seeds`` seed: ``int8_path`` is the control where the program has
such a path, ``int8_rerank`` the cross-encoder's int8 view alone.  The last
line holds the widest program reading and the least reading of each control.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys

from perfbench.run import T0  # noqa: F401 - starts the set-up clock


def control_readings(kept: dict, cfg: dict, mix: dict, device) -> dict[str, float]:
    import torch

    from perfbench import check
    from perfbench.reference.hybrid import HybridReference

    rows, ref = kept["rows"], kept["ref"]
    ctrl = HybridReference(cfg, kept["inputs"], device, precision="fp8")
    out = ctrl.search(rows, mix.get("rerank_depth", 0))
    if "topk" in mix:  # a served reply holds the final list's first entries only
        out["final"] = tuple(a[:, : mix["topk"]] for a in out["final"])
    readings = check.judge(out, kept["ref_scores"], lambda head: ref.cross_logits(rows, head).cpu().numpy(),
                           kept["inputs"].n_docs, mix.get("rerank_depth", 0))
    del ctrl
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return readings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--faults", nargs="*", default=[], help="faults.planted names, each run on every --seeds seed")
    ap.add_argument("--variants", nargs="*", default=["int8_path"],
                    help="systems.<kind> functions that switch on one of the program's own lower-precision paths")
    ap.add_argument("--variant-seeds", type=int, nargs="*", default=[],
                    help="seeds on which each --variants path runs")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import time

    from perfbench import spec
    from perfbench.run import run_cell

    cell = spec.cell(args.workload)
    lower: dict[str, float] = {}
    upper: dict[str, float] = {}
    upper_variant: dict[str, dict[str, float]] = {v: {} for v in args.variants}
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t_seed = time.perf_counter()
        out = run_cell(cell, seed, args.seconds, False, device=args.device, t0=time.perf_counter(),
                       keep=True)
        kept = out.pop("_keep")
        line = {"seed": seed, "correct": out["correct"], "program": kept["readings"],
                "seconds": time.perf_counter() - t_seed}
        if seed in args.seeds:
            for k, v in kept["readings"].items():
                lower[k] = max(lower.get(k, 0.0), v)
        if seed in args.control_seeds:
            ctrl = control_readings(kept, cell["cfg"], cell["mix"], args.device)
            line["control"] = ctrl
            for k, v in ctrl.items():
                upper[k] = min(upper.get(k, math.inf), v)
        print(json.dumps(line, default=float), flush=True)
        del kept, out
        gc.collect()
    for variant in args.variants:
        for seed in args.variant_seeds:
            t_seed = time.perf_counter()
            out = run_cell(cell, seed, args.seconds, False, device=args.device, t0=time.perf_counter(), keep=True,
                           variant=variant)
            kept = out.pop("_keep")
            print(json.dumps({"seed": seed, "variant": variant, "correct": out["correct"],
                              "readings": kept["readings"], "seconds": time.perf_counter() - t_seed},
                             default=float), flush=True)
            for k, v in kept["readings"].items():
                upper_variant[variant][k] = min(upper_variant[variant].get(k, math.inf), v)
            del kept, out
            gc.collect()

    from perfbench.faults import planted

    for fault in args.faults:
        for seed in args.seeds:
            t_seed = time.perf_counter()
            with planted(fault):
                out = run_cell(cell, seed, args.seconds, False, device=args.device, t0=time.perf_counter(),
                               keep=True)
            kept = out.pop("_keep")
            print(json.dumps({"seed": seed, "fault": fault, "correct": out["correct"], "readings": kept["readings"],
                              "seconds": time.perf_counter() - t_seed}, default=float), flush=True)
            del kept, out
            gc.collect()
    print(json.dumps({"workload": args.workload, "lower": lower, "upper_fp8_reference": upper,
                      **{f"upper_{v}": u for v, u in upper_variant.items()}}, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
