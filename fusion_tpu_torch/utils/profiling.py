"""Profiling and tracing helpers, after ``fusion_tpu/utils/profiling.py``:

  * ``span`` / ``count`` — the program's own tracing: named spans at its
                     layer boundaries and named counters.  Off (the default)
                     a span is one flag check and a shared null context, a
                     counter one flag check.  Under ``tracing()`` a span is a
                     ``torch.profiler`` range named ``fusion.<name>`` and an
                     in-memory record (host seconds, calls, start, end,
                     thread, parent); ``snapshot()`` reads the record and
                     ``reset()`` clears it;
  * ``trace``      — a ``torch.profiler`` trace written for TensorBoard, with
                     the program's spans on;
  * ``flops_of``   — the FLOPs of one call as ``FlopCounterMode`` counts them
                     (``utils/common.estimate_flops``);
  * ``peak_tflops`` / ``mfu_report`` — achieved TFLOP/s and MFU against the
                     H100's dense bf16 peak.

``flops_of``'s counter sees the aten operations a call dispatches, so a
Python loop's body counts once per trip (JAX's ``mfu_report`` reads XLA's
cost analysis, which counts a ``lax.scan`` body once).  It does not see the hand-written
kernels: FA, FA-bwd and K1 launch through ctypes, outside the dispatcher.
On the card their work is added analytically (``attention_flops``), as the
training and rerank measurements do; on the CPU their plain versions run as
aten operations, and the counter sees them.

The analytic counts of a train step live here too: ``train_step_flops`` (the
four families, 3 × the forward, plus a forward under remat) and
``colbert_step_flops`` (the ColBERT bench step's useful and hardware FLOPs).
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager, nullcontext

import torch

# dense bf16 peak of the H100 SXM data sheet; FUSION_TPU_TORCH_PEAK_TFLOPS
# overrides it on other hardware
DEFAULT_PEAK_TFLOPS = 989.0


# ----------------------------------------------------------------------
# the program's spans and counters
# ----------------------------------------------------------------------
PREFIX = "fusion"  # a span's profiler range is named "<PREFIX>.<name>"

_on = False
_NULL = nullcontext()
_lock = threading.Lock()
_local = threading.local()  # .stack: this thread's open span records
_records: list[list] = []  # [name, start_ns, end_ns, native thread id, parent record or None]
_counters: dict[str, float] = {}
_deferred: list[tuple[str, torch.Tensor]] = []  # device counts, read by snapshot()


class _Span:
    __slots__ = ("name", "rec", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.range = torch.profiler.record_function(f"{PREFIX}.{self.name}")
        self.range.__enter__()
        # the clock is read inside the range on both sides: under a profiler,
        # entering a range costs ~0.1 ms before the range's own timestamp
        self.rec = [self.name, time.time_ns(), 0, threading.get_native_id(), stack[-1] if stack else None]
        stack.append(self.rec)
        with _lock:
            _records.append(self.rec)
        return self

    def __exit__(self, *exc):
        self.rec[2] = time.time_ns()
        _local.stack.pop()
        self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager that marks one layer of the program's work as
    ``name``.  Off, the shared null context; under ``tracing()``, a
    ``torch.profiler.record_function`` range named ``fusion.<name>`` and a
    record of its start and end on the profiler trace's clock (Unix
    nanoseconds: a trace's event at ``t`` µs lies at ``trace_start_ns() +
    1000 t``), its thread and its parent span on that thread."""
    return _Span(name) if _on else _NULL


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name`` under ``tracing()``; nothing when
    tracing is off.  ``n`` may be a device tensor: it is read by
    ``snapshot()``, so counting waits for nothing."""
    if not _on:
        return
    with _lock:
        if isinstance(n, torch.Tensor):
            _deferred.append((name, n.detach()))
        else:
            _counters[name] = _counters.get(name, 0) + n


def enabled() -> bool:
    """Whether spans and counters record (inside ``tracing()``)."""
    return _on


def current() -> str | None:
    """The innermost open span on this thread, or None."""
    stack = getattr(_local, "stack", None)
    return stack[-1][0] if stack else None


@contextmanager
def tracing():
    """Spans and counters record inside the block (they add to what is
    recorded until ``reset()``)."""
    global _on
    was, _on = _on, True
    try:
        yield
    finally:
        _on = was


def reset() -> None:
    """Clear the spans and counters recorded so far."""
    with _lock:
        _records.clear()
        _counters.clear()
        _deferred.clear()


def snapshot() -> dict:
    """The record since the last ``reset()``:

      * ``spans``: per name, ``host_s`` (seconds inside it), ``calls`` and
        ``self_s`` (``host_s`` less what its child spans cover);
      * ``counters``: per name, the sum counted;
      * ``events``: every closed span as ``[name, start_ns, end_ns, thread,
        parent]``, ``thread`` the native thread id and ``parent`` the index
        of the enclosing span on that thread (-1 for none).
    """
    with _lock:
        recs = [r for r in _records if r[2]]
        counters = dict(_counters)
        deferred = list(_deferred)
    for name, n in deferred:
        counters[name] = counters.get(name, 0) + n.item()
    index = {id(r): i for i, r in enumerate(recs)}
    parents = [index.get(id(r[4]), -1) for r in recs]
    covered = [0] * len(recs)
    for r, p in zip(recs, parents):
        if p >= 0:
            covered[p] += r[2] - r[1]
    spans: dict[str, dict] = {}
    for r, c in zip(recs, covered):
        agg = spans.setdefault(r[0], {"host_s": 0.0, "calls": 0, "self_s": 0.0})
        agg["host_s"] += (r[2] - r[1]) / 1e9
        agg["calls"] += 1
        agg["self_s"] += (r[2] - r[1] - c) / 1e9
    return {
        "spans": spans,
        "counters": counters,
        "events": [[r[0], r[1], r[2], r[3], p] for r, p in zip(recs, parents)],
    }


@contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (CPU, and CUDA when a
    card is present) into ``log_dir`` for TensorBoard, with the program's
    spans on: the trace shows its layers."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)), tracing():
        yield


def flops_of(fn, *example_args) -> dict:
    """``{"flops", "seconds"}`` of one call of ``fn`` (it runs once)."""
    from fusion_tpu_torch.utils.common import estimate_flops

    return estimate_flops(fn, *example_args)


def peak_tflops() -> float:
    return float(os.environ.get("FUSION_TPU_TORCH_PEAK_TFLOPS", DEFAULT_PEAK_TFLOPS))


def utilization(flops: float, seconds: float) -> float:
    """``flops`` done in ``seconds`` as a share of ``peak_tflops``."""
    return flops / seconds / (peak_tflops() * 1e12)


def mfu_report(fn, example_args, measured_seconds: float | None, hand_flops: float = 0.0) -> dict:
    """Achieved TFLOP/s and MFU of one call of ``fn(*example_args)`` that
    took ``measured_seconds``: the counter's FLOPs (the call runs once to
    count them) plus ``hand_flops``, the work of hand-written kernels the
    call launches on the card (``attention_flops``; 0 on the CPU, where the
    counter sees their plain versions).  ``{}`` when nothing was counted."""
    flops = flops_of(fn, *example_args)["flops"] + float(hand_flops)
    if flops <= 0:
        return {}
    out = {"flops": flops}
    if measured_seconds and measured_seconds > 0:
        tps = flops / measured_seconds / 1e12
        out["tflops_per_s"] = round(tps, 2)
        out["mfu"] = round(tps / peak_tflops(), 4)
        out["peak_tflops"] = peak_tflops()
    return out


# ----------------------------------------------------------------------
# analytic counts
# ----------------------------------------------------------------------
def trunk_flops_per_token(cfg) -> float:
    """Per token, over the layers, the trunk's matmul FLOPs outside
    attention: fused qkv and out (4 H²) and the FFN (2 H F), two per
    multiply-add."""
    h, f = cfg.hidden_size, cfg.intermediate_size
    return 2.0 * cfg.num_layers * (4 * h * h + 2 * h * f)


def attention_flops(cfg, length: int) -> float:
    """QKᵀ and PV of one sequence of ``length`` tokens over all layers (the
    work of FA in the ``flash`` form)."""
    return 4.0 * cfg.num_layers * length * length * cfg.hidden_size


def encoder_flops(cfg, n: int, length: int) -> float:
    """One forward of the trunk over ``n`` sequences of ``length`` tokens."""
    return n * (length * trunk_flops_per_token(cfg) + attention_flops(cfg, length))


def train_step_flops(cfg, family: str, b: int, lq: int, ld: int, n_neg: int, dim: int = 128) -> tuple[float, float]:
    """(model FLOPs, hardware FLOPs) of one train step of ``family`` (dpr,
    splade, colbert or monobert) at batch ``b``, query ``lq``, doc ``ld``
    and ``n_neg`` negatives a query: 3 × the forward (forward and backward)
    of the trunks and heads, plus under ``cfg.remat`` one more forward of
    the trunks."""
    h, v = cfg.hidden_size, cfg.vocab_size
    if family == "monobert":
        layers, heads = encoder_flops(cfg, b, ld), b * (2 * h * h + 2 * h)
    else:
        layers = encoder_flops(cfg, b, lq) + encoder_flops(cfg, b * (1 + n_neg), ld)
        tokens = b * lq + b * (1 + n_neg) * ld
        if family == "dpr":
            heads = 2.0 * b * b * (1 + n_neg) * h  # in-batch similarities
        elif family == "splade":
            heads = tokens * (2 * h * h + 2 * h * v) + 2.0 * b * b * (1 + n_neg) * v
        else:  # the projection, and MaxSim over the positive and the negatives
            heads = tokens * 2 * h * dim + 2.0 * b * (1 + n_neg) * lq * ld * dim
    model = 3 * (layers + heads)
    return model, model + (layers if cfg.remat else 0)


def colbert_step_flops(cfg, bs: int, nway: int, lq: int, ld: int, dim: int) -> tuple[float, float]:
    """(useful, hardware) FLOPs of one ColBERT CE step over ``bs`` queries
    and ``nway`` docs each, with the trunk's matmul parameters taken as 12 H²
    a layer, as the JAX bench script counts them (exact at an FFN of 4 H).
    Useful: 3 × 2 × those parameters × the encoded tokens (attention and
    heads left out).  Hardware: 3 × the whole forward (trunk matmuls,
    attention, the projection and the n-way MaxSim) plus, under remat, one
    more forward of the trunk."""
    h, layers = cfg.hidden_size, cfg.num_layers
    p_matmul = layers * 12 * h * h
    tokens = bs * (lq + ld * nway)
    useful = 3 * 2 * p_matmul * tokens

    def trunk(n, length):
        return n * length * 2 * p_matmul + n * attention_flops(cfg, length)

    trunk_fwd = trunk(bs, lq) + trunk(bs * nway, ld)
    heads = tokens * 2 * h * dim + 2.0 * bs * nway * lq * ld * dim
    hardware = 3 * (trunk_fwd + heads) + (trunk_fwd if cfg.remat else 0)
    return float(useful), float(hardware)
