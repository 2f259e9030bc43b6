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

import datetime
import os

import torch
import torch.distributed as dist

from fusion_tpu_torch.core.device import resolve_device
from fusion_tpu_torch.parallel import sharding
from fusion_tpu_torch.parallel.sharding import make_mesh


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str = "nccl",
    device=None,
    timeout: float | None = None,
) -> None:
    """Join the process group (idempotent: a second call is a no-op).

    ``coordinator_address`` is ``host:port`` (or a ``tcp://`` / ``file://``
    URL) of rank 0; with no arguments torchrun's environment variables drive
    the bootstrap.  ``backend`` is ``nccl`` (the default, one card per rank)
    or ``gloo`` (two ranks sharing one card, which NCCL refuses).  ``device``
    defaults to the card ``cuda:{LOCAL_RANK}`` under either backend, and
    raises without one (``core.device.resolve_device``): the CPU tests pass
    ``device="cpu"``.  It becomes ``make_mesh``'s default.  ``timeout``
    (seconds; torch's default when None) bounds every collective of the
    default group and of the mesh's and the server's groups (``parallel.sharding``):
    a rank whose partner never arrives raises after it instead of waiting
    forever."""
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    device = resolve_device(f"cuda:{local_rank}" if device is None else device)
    if dist.is_initialized():
        return
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    sharding._GROUP_TIMEOUT[0] = kw.get("timeout")
    if coordinator_address is None:
        dist.init_process_group(backend=backend, **kw)
    else:
        url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        dist.init_process_group(backend=backend, init_method=url, world_size=num_processes, rank=process_id, **kw)
    sharding._DEFAULT_DEVICE[0] = device


def pod_mesh(model: int = 1, index: int = 1):
    """A (data, model, index) mesh over every rank of the group; data absorbs
    the remaining ranks.  Call after ``initialize_multihost``."""
    return make_mesh(data=None, model=model, index=index)


def is_primary_host() -> bool:
    """True on the process that should write checkpoints and logs (rank 0)."""
    return not dist.is_initialized() or dist.get_rank() == 0
