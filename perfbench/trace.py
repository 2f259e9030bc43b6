"""Spans, kernel events and the profiler trace of a traced run.

Spans are recorded from perfbench's own files: the system module names the
program's methods to wrap (``span_targets``), and each call inside the
traced part of the window runs under ``torch.profiler.record_function(
"perfbench.<span>")`` with its host time summed.  A kernel launched through
``ctypes`` may be missing from the profiler's trace, so each hand-written
kernel the system names (``kernel_counters``) is also timed by a pair of
CUDA events on its stream, and its launches are counted.  ``reduce()``
turns all of it into the record that the per-layer readers read.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

HAND_KERNEL_NAMES = {"K1": ("maxima_kernel",)}
SHORT_GAP_US = 20  # idle gaps shorter than this are summed under one name


class Tracer:
    def __init__(self, targets, kernels):
        self.targets = targets
        self.kernels = kernels
        self.active = False
        self.stack: list[str] = []
        self.host_s = defaultdict(float)
        self.calls = defaultdict(int)
        self.launches: dict[str, list] = defaultdict(list)  # name -> [(span, start, end, args)]
        self._undo = []

    def install(self) -> None:
        for obj, method, span in self.targets:
            self._wrap_span(obj, method, span)
        for name, module, entry in self.kernels:
            self._wrap_kernel(name, module, entry)

    def uninstall(self) -> None:
        for obj, attr, old, is_instance in reversed(self._undo):
            if is_instance:
                delattr(obj, attr) if old is None else setattr(obj, attr, old)
            else:
                setattr(obj, attr, old)
        self._undo.clear()

    def _wrap_span(self, obj, method, span):
        orig = getattr(obj, method)
        had = obj.__dict__.get(method) if hasattr(obj, "__dict__") else None
        label = "perfbench." + span

        def wrapped(*a, **kw):
            if not self.active:
                return orig(*a, **kw)
            self.stack.append(span)
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(label):
                    return orig(*a, **kw)
            finally:
                self.host_s[span] += time.perf_counter() - t0
                self.calls[span] += 1
                self.stack.pop()

        setattr(obj, method, wrapped)
        self._undo.append((obj, method, had, True))

    def _wrap_kernel(self, name, module, entry):
        orig = getattr(module, entry)

        def wrapped(*a, **kw):
            if not self.active:
                return orig(*a, **kw)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(*a, **kw)
            end.record()
            shapes = tuple(tuple(x.shape) for x in a if isinstance(x, torch.Tensor))
            self.launches[name].append((self.stack[-1] if self.stack else None, start, end, shapes))
            return out

        wrapped.launches = getattr(orig, "launches", 0)
        setattr(module, entry, wrapped)
        self._undo.append((module, entry, orig, False))


def _is_hand(key: str) -> str | None:
    for name, parts in HAND_KERNEL_NAMES.items():
        if any(p in key for p in parts):
            return name
    return None


def reduce(prof, tracer: Tracer, window_s: float, top: int = 10) -> dict:
    """The traced window's record: host and device seconds by span, device
    operations, busy seconds, each hand kernel's event-timed launches, and
    the breakdown (top device operations, longest idle gaps by the span
    the host was in)."""
    torch.cuda.synchronize()
    kernel_s = defaultdict(float)
    kernel_span_s = defaultdict(float)
    for name, calls in tracer.launches.items():
        for span, start, end, _ in calls:
            s = start.elapsed_time(end) / 1e3
            kernel_s[name] += s
            if span:
                kernel_span_s[span] += s

    ops, hand_ops, annotations, host_ranges = [], [], [], []
    by_name = defaultdict(float)
    traced_hand = defaultdict(int)
    for e in prof.events():
        kind = e.device_type.name
        if e.name.startswith("perfbench."):
            span = e.name[len("perfbench."):]
            if kind == "CUDA":  # the range's device-side span
                annotations.append((e.time_range.start, e.time_range.end, span))
            elif kind == "CPU":
                host_ranges.append((e.time_range.start, e.time_range.end, span))
        elif kind == "CUDA" and not getattr(e, "is_user_annotation", False):
            hand = _is_hand(e.name)
            if hand:  # its time and span come from its events; the trace places it
                traced_hand[hand] += 1
                hand_ops.append((e.time_range.start, e.time_range.end))
                continue
            ops.append((e.time_range.start, e.time_range.end))
            by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e6
    for name, s in kernel_s.items():
        by_name[name] += s
    top_ops = sorted(by_name.items(), key=lambda x: -x[1])[:top]
    # a hand kernel's launches the trace missed: their event time counts as busy
    missed_s = sum(s * (1 - min(traced_hand[name], len(tracer.launches[name])) / len(tracer.launches[name]))
                   for name, s in kernel_s.items() if tracer.launches[name])

    # one stream: the operations inside a range's device-side span are those
    # launched inside the range; the trace spans a range over the operations
    # launched in it and not in a range nested in it
    ops.sort()
    starts = [o[0] for o in ops]
    prefix = [0.0]
    for lo, hi in ops:
        prefix.append(prefix[-1] + (hi - lo))
    span_dev = defaultdict(float)
    for lo, hi, span in annotations:
        i, j = bisect.bisect_left(starts, lo), bisect.bisect_right(starts, hi)
        span_dev[span] += (prefix[j] - prefix[i]) / 1e6
    for span, s in kernel_span_s.items():
        span_dev[span] += s

    gaps = defaultdict(float)
    host_ranges.sort()
    busy_us = 0.0
    last_end = None
    for s, e in sorted(ops + hand_ops):
        busy_us += max(0.0, e - max(s, last_end)) if last_end is not None else e - s
        if last_end is not None and s > last_end:
            if s - last_end < SHORT_GAP_US:
                gaps[f"between operations (< {SHORT_GAP_US} us)"] += (s - last_end) / 1e6
            else:
                inner = [r for r in host_ranges if r[0] <= last_end < r[1]]
                label = min(inner, key=lambda r: r[1] - r[0])[2] if inner else "outside spans"
                gaps["host in " + label] += (s - last_end) / 1e6
        last_end = e if last_end is None else max(last_end, e)

    launches = {name: len(calls) for name, calls in tracer.launches.items()}
    return {
        "window_s": window_s,
        "busy_s": busy_us / 1e6 + missed_s,
        "device_ops": len(ops) + sum(launches.values()),
        "host_s": dict(tracer.host_s),
        "span_calls": dict(tracer.calls),
        "device_s": dict(span_dev),
        "kernel_s": dict(kernel_s),
        "kernel_launches": launches,
        "kernel_traced_launches": dict(traced_hand),
        "kernel_shapes": {name: [c[3] for c in calls] for name, calls in tracer.launches.items()},
        "breakdown": {
            "device_ops": [[k, v] for k, v in top_ops],
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda x: -x[1])[:top],
        },
    }
