"""Learning-rate schedules: plain ``step → lr`` functions with optax's
semantics and f32 arithmetic, as ``fusion_tpu/train/schedules.py`` builds
them from optax:

  * ``linear`` — 0 → lr over the warmup, then linear decay to 0 at
    ``total_steps`` (HF's 'linear');
  * ``cosine`` — linear warmup, then cosine decay to 0 over
    ``total_steps - warmup``;
  * ``constant`` and ``constant_with_warmup``.

The warmup is ``max(int(total_steps · warmup_ratio), 1)`` steps; a joined
schedule switches at ``step >= boundary`` and restarts the next piece at
``step - boundary`` (optax's ``join_schedules``).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np

Schedule = Callable[[int], float]

_f32 = np.float32


def _linear(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax.linear_schedule."""

    def schedule(count: int) -> float:
        if transition_steps <= 0:
            return float(_f32(init_value))
        count = _f32(min(max(count, 0), transition_steps))
        frac = _f32(1) - count / _f32(transition_steps)
        return float(_f32(init_value - end_value) * frac + _f32(end_value))

    return schedule


def _cosine_decay(init_value: float, decay_steps: int) -> Schedule:
    """optax.cosine_decay_schedule with alpha 0 and exponent 1."""

    def schedule(count: int) -> float:
        count = _f32(min(count, decay_steps))
        cosine = _f32(0.5) * (_f32(1) + np.cos(_f32(math.pi) * count / _f32(decay_steps)))
        return float(_f32(init_value) * cosine)

    return schedule


def _join(schedules: list[Schedule], boundaries: list[int]) -> Schedule:
    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, piece in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = piece(count - boundary)
        return out

    return schedule


def _warmup(total_steps: int, warmup_ratio: float) -> int:
    return max(int(total_steps * warmup_ratio), 1)


def linear_with_warmup(
    learning_rate: float, total_steps: int, warmup_ratio: float = 0.04, warmup_steps: int | None = None
) -> Schedule:
    """HF 'linear': 0 → lr over the warmup, then linear decay to 0 at total_steps."""
    warmup = max(warmup_steps if warmup_steps is not None else int(total_steps * warmup_ratio), 1)
    return _join(
        [_linear(0.0, learning_rate, warmup), _linear(learning_rate, 0.0, max(total_steps - warmup, 1))],
        [warmup],
    )


def cosine_with_warmup(learning_rate: float, total_steps: int, warmup_ratio: float = 0.04) -> Schedule:
    warmup = _warmup(total_steps, warmup_ratio)
    if total_steps - warmup <= 0:
        raise ValueError(f"the cosine schedule needs total_steps > warmup ({total_steps} <= {warmup})")
    return _join([_linear(0.0, learning_rate, warmup), _cosine_decay(learning_rate, total_steps - warmup)], [warmup])


def get_schedule(name: str, learning_rate: float, total_steps: int, warmup_ratio: float = 0.04) -> Schedule:
    """Schedule by the reference CLI's names."""
    if name == "linear":
        return linear_with_warmup(learning_rate, total_steps, warmup_ratio)
    if name == "cosine":
        return cosine_with_warmup(learning_rate, total_steps, warmup_ratio)
    if name == "constant":
        return lambda count: learning_rate
    if name == "constant_with_warmup":
        warmup = _warmup(total_steps, warmup_ratio)
        return _join([_linear(0.0, learning_rate, warmup), lambda count: learning_rate], [warmup])
    raise ValueError(f"unknown schedule {name!r}")
