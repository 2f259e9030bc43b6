"""An open loop of single-query requests to the program's HTTP server.

Independent users of a search box: ``rate`` requests a second arrive as a
Poisson process, each ``POST /search`` with one query and ``topk``, sent by
``clients`` processes (``loops/sender.py``) whatever is in flight.  Every
seed gets the same multiset of gaps (the exponential law's quantiles) and
as many requests (rate x seconds), in its own order, and distinct queries
from the pool.  A request is timed from when it was due to when its reply
was read; one that fails or never comes counts as missing every limit.  The
window is ``seconds`` of arrivals; the replies are awaited after it.

For the check, ``check_requests`` requests due in the window's first
``check_within_s`` seconds (drawn from the seed) have their legs' lists and
fused list kept as the server's searcher produced them, beside their
replies.
"""

from __future__ import annotations

import importlib
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from perfbench.spec import ROOT

DRAIN_S = 60.0  # how long replies are awaited past the window's close


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def exponential_gaps(rate: float, n: int) -> np.ndarray:
    """The Exp(rate) law's quantiles at (i + 0.5) / n."""
    p = (np.arange(n) + 0.5) / n
    return -np.log1p(-p) / rate


def p95(latencies: np.ndarray) -> float:
    """The nearest-rank 95th percentile."""
    s = np.sort(latencies)
    return float(s[max(0, math.ceil(0.95 * len(s)) - 1)])


class Loop:
    def __init__(self, system, inputs, cfg, traffic, seed: int):
        self.system, self.inputs, self.cfg, self.traffic = system, inputs, cfg, traffic
        rng = np.random.default_rng([seed, 7])
        self.order = rng.permutation(len(inputs.query_texts))
        self.rng = rng
        self.server = importlib.import_module(f"perfbench.systems.{cfg['system']}").server(system, traffic)
        self.watch: dict[str, int] = {}
        self.kept: dict[str, dict] = {}
        self._install_capture()

    def _install_capture(self) -> None:
        s, state = self.system, {"texts": []}
        prepare, search_batch, fuse = s._prepare_inputs, s._search_batch, s._fuse

        def kept_prepare(chunk):
            state["texts"] = list(chunk)
            return prepare(chunk)

        def rows(key):
            return [(j, t) for j, t in enumerate(state["texts"]) if t in self.watch and key not in self.kept.get(t, {})]

        def kept_search_batch(inputs):
            out = search_batch(inputs)
            for j, t in rows("legs"):
                self.kept.setdefault(t, {})["legs"] = {leg: (r.ids[j], r.scores[j]) for leg, r in out.items()}
            return out

        def kept_fuse(results):
            out = fuse(results)
            for j, t in rows("fused"):
                self.kept.setdefault(t, {})["fused"] = (out.ids[j], out.scores[j])
            return out

        s._prepare_inputs, s._search_batch, s._fuse = kept_prepare, kept_search_batch, kept_fuse

    def warm(self) -> None:
        """The server's own warm-up (one padded batch) on the first call, then
        one request through HTTP."""
        if self.server._dispatcher.ident is None:
            self.server.start(warmup=True)
        host, port = self.server.address
        job = {"url": f"http://{host}:{port}", "start": time.monotonic(),
               "requests": [[0, 0.0, self.inputs.query_texts[self.order[-1]], self.traffic["topk"]]]}
        self._collect(self._send([job]), DRAIN_S)
        _sync()

    @staticmethod
    def _send(jobs) -> list:
        procs = [subprocess.Popen([sys.executable, "-m", "perfbench.loops.sender"], cwd=ROOT,
                                  stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True) for _ in jobs]
        for p, job in zip(procs, jobs):
            p.stdin.write(json.dumps(job))
            p.stdin.close()
            p.stdin = None  # the schedule is sent: communicate() only reads
        return procs

    @staticmethod
    def _collect(procs, timeout: float) -> list:
        out = []
        deadline = time.monotonic() + timeout
        for p in procs:
            try:  # read while waiting: a reply log larger than the pipe would block the client
                text, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                text = text if p.returncode == 0 else ""
            except subprocess.TimeoutExpired:
                p.kill()
                p.communicate()
                text = ""
            out += [json.loads(line) for line in text.splitlines() if line.strip()]
        return out

    def window(self, seconds: float, tracer=None, profiler=None) -> dict:
        mix = self.traffic
        n = max(1, round(mix["rate"] * seconds))
        due = np.cumsum(self.rng.permutation(exponential_gaps(mix["rate"], n)))
        texts = [self.inputs.query_texts[self.order[i % len(self.order)]] for i in range(n)]
        early = np.flatnonzero(due < mix["check_within_s"])
        picked = self.rng.choice(early, size=min(mix["check_requests"], len(early)), replace=False)
        self.watch = {texts[i]: int(i) for i in picked}
        host, port = self.server.address
        stats0 = dict(self.server.stats)
        start = time.monotonic() + 0.5  # the clients read their schedules first
        k = mix["clients"]
        reqs = [[i, float(due[i]), texts[i], mix["topk"]] for i in range(n)]
        procs = self._send([{"url": f"http://{host}:{port}", "start": start, "requests": reqs[c::k]}
                            for c in range(k)])
        traced_s = None
        if tracer is not None:
            time.sleep(max(0.0, start - time.monotonic()))
            tracer.active = True
            profiler.__enter__()
            t0 = time.perf_counter()
            time.sleep(min(mix["trace_s"], seconds))
            _sync()
            traced_s = time.perf_counter() - t0
            tracer.active = False
            profiler.__exit__(None, None, None)
        rows = self._collect(procs, seconds + DRAIN_S + 0.5)
        window_s = seconds
        stats1 = dict(self.server.stats)
        self.server.stop()

        done = {r["index"]: r for r in rows}
        # a request that failed or never came waited until the replies stopped being awaited
        missing = start + seconds + DRAIN_S
        lat = np.array([done[i]["done"] - done[i]["due"] if i in done and done[i]["status"] == 200
                        else missing - (start + due[i]) for i in range(n)])
        ok = np.array([i in done and done[i]["status"] == 200 for i in range(n)])
        lag = np.array([done[i]["sent"] - done[i]["due"] for i in done])
        failed = int((~ok).sum())
        keep = [i for i in sorted(picked) if texts[i] in self.kept and i in done and done[i]["status"] == 200]
        legs = {leg: (np.stack([self.kept[texts[i]]["legs"][leg][0].cpu().numpy() for i in keep]).astype(np.int64),
                      np.stack([self.kept[texts[i]]["legs"][leg][1].cpu().numpy() for i in keep]))
                for leg in (self.kept[texts[keep[0]]]["legs"] if keep else {})}
        fused = (np.stack([self.kept[texts[i]]["fused"][0].cpu().numpy() for i in keep]).astype(np.int64),
                 np.stack([self.kept[texts[i]]["fused"][1].cpu().numpy() for i in keep])) if keep else None
        final = (np.array([done[i]["ids"] for i in keep], np.int64),
                 np.array([done[i]["scores"] for i in keep], np.float32)) if keep else None
        return {
            "attempted": n,
            "answered": n - failed,
            "failed": failed,
            "unchecked": len(picked) - len(keep),
            "window_s": window_s,
            "traced_s": traced_s,
            "e2e": {"p95_request_ms": p95(lat) * 1e3},
            # median latency of the requests due in each quarter of the window:
            # a backlog that grows shows as rising medians
            "lat_quarters_ms": [float(np.median(lat[(due >= seconds * q / 4) & (due < seconds * (q + 1) / 4)])) * 1e3
                                for q in range(4)],
            "check_rows": self.order[np.array(keep, np.int64) % len(self.order)] if keep else np.array([], np.int64),
            "out": {"legs": legs, "fused": fused, "final": final},
            "statuses": {str(k): int(v) for k, v in zip(*np.unique([done[i]["status"] if i in done else -1
                                                                     for i in range(n)], return_counts=True))},
            "serve": {
                "batches": stats1["batches"] - stats0["batches"],
                "queries": stats1["queries"] - stats0["queries"],
                "batch_ms_total": stats1["batch_ms_total"] - stats0["batch_ms_total"],
                "max_batch": mix["max_batch"],
                "lag_p99_ms": float(np.percentile(lag, 99)) * 1e3 if len(lag) else None,
                "requests": n,
            },
        }

    def trace_record(self, res: dict, record: dict) -> dict:
        return {"serve": res["serve"], "batches": res["serve"]["batches"],
                "rerank_depth": self.traffic.get("rerank_depth", 0)}
