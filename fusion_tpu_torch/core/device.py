"""The device an entry point runs on.

Every public constructor and build function of the package takes ``device`` and
defaults to the card (``"cuda"``).  Without a card that default fails loudly
instead of running on the CPU: the caller asks for the CPU by passing
``device="cpu"``, as the tests do."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and there is
    no usable CUDA device."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for (the default), but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return device


def check_use_pallas(use_pallas) -> None:
    """The JAX package's ``use_pallas`` (its Pallas kernel or XLA's plain
    form), accepted where JAX takes it and dropped: the port runs a kernel on
    a tensor on the card and its plain version on a tensor on the CPU."""
    if use_pallas not in (None, True, False):
        raise ValueError(f"use_pallas must be None, True or False, got {use_pallas!r}")
