"""The serve cell's knee: the highest offered rate the server sustains
without a growing backlog, found once by a sweep on the card.

    python -m perfbench.sweep --workload lleqa-serve-open --rates 23 25 27 29 31 [--seconds 40] [--write]

Each rate runs the cell (``run_cell``, its open loop at that rate) for
``--seconds``; a rate is sustained when no request failed and the median
latency of the requests due in the window's last quarter is at most 1.25
times that of its first quarter.  One JSON line per rate, then the knee and
0.8 of it, the rate the cell runs at (``--write`` puts it in the mix file).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from perfbench.run import T0  # noqa: F401 - imported first, as a run is
from perfbench.spec import HERE

GROWTH = 1.25  # last quarter's median latency over the first's, at most


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=2800000000)
    ap.add_argument("--write", action="store_true")
    args = ap.parse_args(argv)

    from perfbench import spec
    from perfbench.run import run_cell

    cell = spec.cell(args.workload)
    sustained = []
    for rate in args.rates:
        c = {**cell, "mix": {**cell["mix"], "rate": rate}}
        out = run_cell(c, args.seed + int(rate * 10), args.seconds, False, t0=time.perf_counter(), keep=True)
        res = out.pop("_keep")["res"]
        q = res["lat_quarters_ms"]
        ok = res["failed"] == 0 and q[3] <= GROWTH * q[0]
        sustained += [rate] if ok else []
        print(json.dumps({"rate": rate, "p95_ms": res["e2e"]["p95_request_ms"], "failed": res["failed"],
                          "statuses": res["statuses"], "lat_quarters_ms": q, "serve": res["serve"],
                          "sustained": ok, "correct": out["correct"]}), flush=True)
    if not sustained:
        print(json.dumps({"knee": None}), flush=True)
        return 1
    knee = max(sustained)
    rate = round(0.8 * knee, 1)
    if args.write:
        path = HERE / "traffic" / f"{cell['traffic']}.json"
        mix = json.loads(path.read_text())
        mix["rate"] = rate
        path.write_text(json.dumps(mix, indent=2) + "\n")
    print(json.dumps({"knee": knee, "rate": rate}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
