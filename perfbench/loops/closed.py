"""A closed loop of query batches through ``HybridSearcher.search``.

One caller, as a user scoring a query set: each call hands the searcher
``batches_per_call`` batches of ``batch`` queries (its one-deep pipeline
overlaps a batch's host work with the previous batch's device work) and
waits for the ranked lists on the host before the next call.  Queries are
the pool's, in order from an offset drawn from the seed, cycling.  The
window runs until ``seconds`` have passed at the end of a call; every query
answered counts, and the window is the time to the last answer.

For the check, one batch among the window's first ``check_batch_within``
(drawn from the seed) has its legs' lists and its fused list kept as the
searcher produced them, beside its final lists.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Loop:
    def __init__(self, system, inputs, cfg, traffic, seed: int):
        self.system, self.inputs, self.cfg, self.traffic = system, inputs, cfg, traffic
        self.batch, self.per_call = traffic["batch"], traffic["batch"] * traffic["batches_per_call"]
        rng = np.random.default_rng([seed, 7])
        self.pool = len(inputs.query_texts)
        self.start = int(rng.integers(self.pool))
        self.capture = int(rng.integers(traffic["check_batch_within"]))
        self.check_rows = np.sort(rng.choice(self.batch, size=cfg["check"]["queries"], replace=False))
        self.state = {"batch": -1, "legs": None, "fused": None}
        self._install_capture()

    def _install_capture(self) -> None:
        s, state = self.system, self.state
        search_batch, fuse = s._search_batch, s._fuse

        def kept_search_batch(inputs):
            state["batch"] += 1
            out = search_batch(inputs)
            if state["batch"] == self.capture:
                state["legs"] = out
            return out

        def kept_fuse(results):
            out = fuse(results)
            if state["batch"] == self.capture:
                state["fused"] = out
            return out

        s._search_batch, s._fuse = kept_search_batch, kept_fuse

    def rows(self, call: int) -> np.ndarray:
        return (self.start + call * self.per_call + np.arange(self.per_call)) % self.pool

    def _call(self, call: int, batches: int | None = None):
        rows = self.rows(call)[: None if batches is None else batches * self.batch]
        ranked, _ = self.system.search([self.inputs.query_texts[r] for r in rows], batch_size=self.batch)
        return ranked

    def warm(self) -> None:
        """The window's shapes (eager: no compilation, the hand kernels build
        at their first launch), on queries just before its first."""
        self._call(-1, self.traffic["warm_batches"])
        _sync()

    def window(self, seconds: float, tracer=None, profiler=None) -> dict:
        self.state["batch"] = -1
        trace_calls = self.traffic["trace_calls"]
        failed = answered = calls = 0
        final = None
        traced_finals = []
        traced_s = None
        if tracer is not None:
            tracer.active = True
            profiler.__enter__()
        t0 = time.perf_counter()
        while True:
            ranked = self._call(calls)
            ids, scores = ranked.ids.numpy(), ranked.scores.numpy()
            failed += int(((ids < 0).any(axis=1) | ~np.isfinite(scores).all(axis=1)).sum())
            answered += ids.shape[0]
            if calls == self.capture // self.traffic["batches_per_call"]:
                final = (ids, scores)
            if tracer is not None and traced_s is None:
                traced_finals.append((calls, ids))
                if len(traced_finals) == trace_calls:
                    traced_s = self._stop_trace(tracer, profiler, t0)
            calls += 1
            if time.perf_counter() - t0 >= seconds and final is not None:
                break
        window_s = time.perf_counter() - t0
        if tracer is not None and traced_s is None:
            traced_s = self._stop_trace(tracer, profiler, t0)
        off = (self.capture % self.traffic["batches_per_call"]) * self.batch
        keep = self.check_rows
        legs = {leg: (r.ids[keep].cpu().numpy().astype(np.int64), r.scores[keep].cpu().numpy())
                for leg, r in self.state["legs"].items()}
        fused = self.state["fused"]
        call_rows = self.rows(self.capture // self.traffic["batches_per_call"])
        return {
            "attempted": calls * self.per_call,
            "answered": answered,
            "failed": failed,
            "calls": calls,
            "window_s": window_s,
            "traced_s": traced_s,
            "e2e": {"queries_per_s": answered / window_s},
            "traced_finals": traced_finals,
            "check_rows": call_rows[off + keep],
            "out": {
                "legs": legs,
                "fused": (fused.ids[keep].cpu().numpy().astype(np.int64), fused.scores[keep].cpu().numpy()),
                "final": (final[0][off + keep].astype(np.int64), final[1][off + keep]),
            },
        }

    def trace_record(self, res: dict, record: dict) -> dict:
        from perfbench import roofline

        shapes = record.get("kernel_shapes", {}).get("K1", [])
        out = roofline.hybrid_traced_work(self.cfg, self.traffic, self.inputs, res["traced_finals"], self.rows, shapes)
        out["batches"] = len(res["traced_finals"]) * self.traffic["batches_per_call"]
        out["rerank_depth"] = self.traffic.get("rerank_depth", 0)
        return out

    @staticmethod
    def _stop_trace(tracer, profiler, t0) -> float:
        _sync()
        s = time.perf_counter() - t0
        tracer.active = False
        profiler.__exit__(None, None, None)
        return s
