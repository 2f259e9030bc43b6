"""Profiling and tracing helpers, as ``fusion_tpu/utils/profiling.py``:

  * ``trace``      — a ``torch.profiler`` trace written for TensorBoard;
  * ``StageTimer`` — named wall-clock stages, each fenced by
                     ``torch.cuda.synchronize`` when its work is on the card
                     (nothing to wait for on the CPU), reported in JAX's keys;
  * ``flops_of``   — the FLOPs of one call as ``FlopCounterMode`` counts them
                     (``utils/common.estimate_flops``);
  * ``peak_tflops`` / ``mfu_report`` — achieved TFLOP/s and MFU against the
                     H100's dense bf16 peak.

The counter sees the aten operations a call dispatches, so a Python loop's
body counts once per trip (JAX's ``mfu_report`` reads XLA's cost analysis,
which counts a ``lax.scan`` body once).  It does not see the hand-written
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
import time
from contextlib import contextmanager

import torch

# dense bf16 peak of the H100 SXM data sheet; FUSION_TPU_TORCH_PEAK_TFLOPS
# overrides it on other hardware
DEFAULT_PEAK_TFLOPS = 989.0


@contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (CPU, and CUDA when a
    card is present) into ``log_dir`` for TensorBoard."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def _on_card(fence) -> bool:
    if isinstance(fence, torch.Tensor):
        return fence.is_cuda
    if isinstance(fence, dict):
        fence = list(fence.values())
    if isinstance(fence, (list, tuple)):
        return any(_on_card(f) for f in fence)
    return hasattr(fence, "ids") and _on_card(fence.ids)  # RankedLists


class StageTimer:
    """Accumulate named stage durations, fenced so device work is counted in
    its stage.

    >>> t = StageTimer()
    >>> with t.stage("encode", fence=embs):
    ...     embs = model.encode(...)
    >>> t.report(num_queries=64)
    {'encode (ms/query)': ...}
    """

    def __init__(self):
        self.totals: dict[str, float] = {}

    @contextmanager
    def stage(self, name: str, fence=None):
        """Time the block; with ``fence`` (a tensor, a list or dict of them,
        or ``RankedLists``) on the card, wait for the card before the clock
        stops."""
        t0 = time.perf_counter()
        yield
        if fence is not None and _on_card(fence):
            torch.cuda.synchronize()
        self.totals[name] = self.totals.get(name, 0.0) + (time.perf_counter() - t0)

    def report(self, num_queries: int = 1) -> dict[str, float]:
        return {f"{name} (ms/query)": total / max(num_queries, 1) * 1000 for name, total in self.totals.items()}


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
