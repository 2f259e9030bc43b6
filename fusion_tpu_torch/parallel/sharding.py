"""The device mesh and the collectives of the sharded forms.

The JAX package runs one controller over a ``jax.sharding.Mesh`` and lets
``shard_map`` run a body per device.  The port runs one process per device
(SPMD): every rank holds only its own shard of each index and calls the same
functions in the same order, and the collectives between the ranks are
``torch.distributed`` calls.  The multi-host JAX tests run the same way (every
process builds the same searcher and searches the same queries).

Axes, in JAX's order (``make_mesh``'s ranks laid out ``(data, model, index)``
with ``index`` fastest):

  * ``data``  — the batch dimension of data-parallel training;
  * ``model`` — tensor parallelism inside the encoder;
  * ``index`` — corpus-axis parallelism for serving: every index is doc-range
                sharded over it, each rank takes a local top-k and one
                all-gather merges the lists.

``Mesh.shape`` is a dict by axis name, as JAX's ``mesh.shape[INDEX_AXIS]``.
A mesh of one rank needs no process group: its collectives are the identity,
so a single-card user (and the CPU tests) run every sharded function at S = 1
without ``init_process_group``.  A larger mesh needs the group
(``parallel.multihost.initialize_multihost``); each axis of more than one
rank gets its own group from ``dist.new_group`` under the caller's backend.

The collectives live here and nowhere else: ``all_gather`` (a ``[Q, k]`` list
into ``[S, Q, k]``), ``all_reduce_sum`` and ``merge_shards``.  Under ``gloo``
a CUDA tensor is copied to host memory and back around the call (gloo stages
CUDA tensors through the host in any case; doing the copy here keeps the
kernels on the card whatever a torch build's gloo accepts).  NCCL refuses two
ranks on one card, so two ranks sharing a card use gloo.  ``COLLECTIVES``
counts each rank's calls, bytes and host seconds inside them.

The JAX module's ``cached_shard_program`` and its ``NamedSharding`` helpers
(``replicated``, ``data_sharding``, ``index_sharding``) have no counterpart:
there is no compiled mesh program to cache, and a rank's shard is an ordinary
tensor on its device.  ``encoder_param_spec`` / ``shard_params`` (tensor
parallelism) belong to the training half and raise.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import torch
import torch.distributed as dist

from fusion_tpu_torch.core.device import resolve_device
from fusion_tpu_torch.core.ranked import PAD_ID, RankedLists, stable_topk

DATA_AXIS = "data"
MODEL_AXIS = "model"
INDEX_AXIS = "index"
AXES = (DATA_AXIS, MODEL_AXIS, INDEX_AXIS)

# each rank's collective traffic: calls, bytes it contributes, host seconds
COLLECTIVES = {"calls": 0, "bytes": 0, "seconds": 0.0}

# the device initialize_multihost gave this process (make_mesh's default)
_DEFAULT_DEVICE: list = [None]

_TRAINING_HALF = (
    "the training half of the multi-device tier (data- and tensor-parallel training) is not ported "
    "to fusion_tpu_torch yet (ROADMAP.md Queue 1, item 18)"
)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a (data, model, index) mesh: the size of each
    axis (``shape``), this rank's coordinate on it (``coords``), the process
    group of the ranks that share its other coordinates (``groups``, None for
    an axis of one rank) and the rank's ``device``."""

    shape: dict
    coords: dict
    groups: dict
    device: torch.device
    backend: str | None = None

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS] * self.shape[INDEX_AXIS]


def make_mesh(
    data: int | None = None,
    model: int = 1,
    index: int = 1,
    devices: Sequence | None = None,
) -> Mesh:
    """This rank's (data, model, index) mesh over the ranks of the default
    process group (one rank, with no group).

    With ``data=None`` the data axis absorbs whatever ranks remain after
    model×index are allocated.  ``devices`` lists each rank's device, in rank
    order (default: the device ``initialize_multihost`` gave this process, else
    ``cuda``); this rank takes ``devices[rank]``."""
    grouped = dist.is_available() and dist.is_initialized()
    world, rank = (dist.get_world_size(), dist.get_rank()) if grouped else (1, 0)
    if data is None:
        if world % (model * index):
            raise ValueError(f"{world} ranks not divisible by model*index = {model * index}")
        data = world // (model * index)
    if data * model * index != world:
        raise ValueError(
            f"mesh {data}x{model}x{index} != {world} ranks"
            + ("" if grouped else ": a mesh of more than one rank needs a process group "
               "(parallel.multihost.initialize_multihost)")
        )
    if devices is not None and len(devices) != world:
        raise ValueError(f"{len(devices)} devices given for {world} ranks: one device per rank")
    device = devices[rank] if devices is not None else (_DEFAULT_DEVICE[0] or "cuda")
    shape = {DATA_AXIS: data, MODEL_AXIS: model, INDEX_AXIS: index}
    coords = {DATA_AXIS: rank // (model * index), MODEL_AXIS: rank // index % model, INDEX_AXIS: rank % index}
    strides = {DATA_AXIS: model * index, MODEL_AXIS: index, INDEX_AXIS: 1}
    groups = {}
    for axis in AXES:
        groups[axis] = None
        if shape[axis] == 1:
            continue
        # new_group is collective over the whole world: every rank creates
        # every group of the axis, in the same order, and keeps its own
        for base in range(world):
            if (base // strides[axis]) % shape[axis]:
                continue
            members = [base + i * strides[axis] for i in range(shape[axis])]
            group = dist.new_group(members)
            if rank in members:
                groups[axis] = group
    return Mesh(shape=shape, coords=coords, groups=groups, device=resolve_device(device),
                backend=dist.get_backend() if grouped else None)


def default_index_rank(n_shards: int) -> int:
    """The index coordinate this process holds on a mesh of ``n_shards``
    index ranks: the default process group's rank modulo ``n_shards``
    (``make_mesh`` lays ``index`` out fastest), 0 without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() % n_shards
    if n_shards != 1:
        raise ValueError(
            f"{n_shards} shards and no process group: pass rank= (the shard this process keeps)"
        )
    return 0


def _host_staged(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    return x.cpu() if mesh.backend == "gloo" and x.is_cuda else x


def _count(x: torch.Tensor, t0: float) -> None:
    COLLECTIVES["calls"] += 1
    COLLECTIVES["bytes"] += x.numel() * x.element_size()
    COLLECTIVES["seconds"] += time.perf_counter() - t0


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str = INDEX_AXIS) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, stacked in coordinate order:
    ``[Q, k]`` → ``[S, Q, k]`` on every rank of the axis."""
    group = mesh.groups[axis]
    if group is None:
        return x[None]
    t0 = time.perf_counter()
    src = _host_staged(mesh, x.contiguous())
    parts = [torch.empty_like(src) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, src, group=group)
    out = torch.stack(parts).to(x.device)
    _count(x, t0)
    return out


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axis: str = INDEX_AXIS) -> torch.Tensor:
    """The sum of every rank's ``x`` along ``axis`` (JAX's ``psum``)."""
    if mesh.groups[axis] is None:
        return x
    t0 = time.perf_counter()
    buf = _host_staged(mesh, x.contiguous()).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.groups[axis])
    out = buf.to(x.device)
    _count(x, t0)
    return out


def merge_shards(local_ids: torch.Tensor, local_scores: torch.Tensor, k: int, mesh: Mesh | None = None) -> RankedLists:
    """The global top-``k`` of per-shard lists, on every rank.

    With a ``mesh``, each rank's ``[Q, kl]`` list (global ids) is all-gathered
    over the index axis first; with ``mesh=None`` the lists are the gathered
    ``[S, Q, kl]`` already.  They are laid out ``[Q, S·kl]`` and one stable
    top-k keeps ``lax.top_k``'s order: on equal scores the lower shard wins,
    then the lower local rank.  Non-finite scores come back as id -1."""
    if mesh is not None:
        local_ids, local_scores = all_gather(local_ids, mesh), all_gather(local_scores, mesh)
    s, q, kl = local_scores.shape
    scores = local_scores.transpose(0, 1).reshape(q, s * kl)
    ids = local_ids.transpose(0, 1).reshape(q, s * kl)
    top_scores, pos = stable_topk(scores, min(k, s * kl))
    top_ids = torch.gather(ids, 1, pos)
    return RankedLists(
        ids=torch.where(torch.isfinite(top_scores), top_ids, PAD_ID).to(torch.int32), scores=top_scores
    )


def globalize(local: RankedLists, rank: int, per: int) -> torch.Tensor:
    """A shard's local ids → global ids (``local + rank·per``, -1 kept)."""
    return torch.where(local.ids >= 0, local.ids + rank * per, PAD_ID).to(torch.int32)


def encoder_param_spec(params) -> dict:
    raise NotImplementedError(f"encoder_param_spec: {_TRAINING_HALF}")


def shard_params(params, mesh: Mesh):
    raise NotImplementedError(f"shard_params: {_TRAINING_HALF}")
