"""Multi-process bootstrap: one process per device.

The JAX package joins a pod with ``jax.distributed.initialize``; the port
joins a ``torch.distributed`` process group, one rank per device, on one host
or many.  A deployment over several cards starts one process per card
(``torchrun --nproc_per_node=<cards> serve.py``) and each calls
``initialize_multihost()``, which reads torchrun's ``MASTER_ADDR`` /
``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``; or it passes the
coordinator's address, the process count and its id, as JAX's call takes
them.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from fusion_tpu_torch.parallel import sharding
from fusion_tpu_torch.parallel.sharding import make_mesh


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str = "nccl",
    device=None,
) -> None:
    """Join the process group (idempotent: a second call is a no-op).

    ``coordinator_address`` is ``host:port`` (or a ``tcp://`` / ``file://``
    URL) of rank 0; with no arguments torchrun's environment variables drive
    the bootstrap.  ``backend`` is ``nccl`` (the default, one card per rank:
    ``device`` defaults to ``cuda:{LOCAL_RANK}``) or ``gloo`` (the CPU tests
    pass ``device="cpu"``; two ranks sharing one card, which NCCL refuses,
    pass a CUDA device).  ``device`` becomes ``make_mesh``'s default."""
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if device is None:
        device = f"cuda:{local_rank}" if backend == "nccl" else "cpu"
    device = torch.device(device)
    if dist.is_initialized():
        return
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if coordinator_address is None:
        dist.init_process_group(backend=backend)
    else:
        url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        dist.init_process_group(backend=backend, init_method=url, world_size=num_processes, rank=process_id)
    sharding._DEFAULT_DEVICE[0] = device


def pod_mesh(model: int = 1, index: int = 1):
    """A (data, model, index) mesh over every rank of the group; data absorbs
    the remaining ranks.  Call after ``initialize_multihost``."""
    return make_mesh(data=None, model=model, index=index)


def is_primary_host() -> bool:
    """True on the process that should write checkpoints and logs (rank 0)."""
    return not dist.is_initialized() or dist.get_rank() == 0
