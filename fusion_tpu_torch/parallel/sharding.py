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

The collectives live here and nowhere else.  Serving: ``all_gather`` (a
``[Q, k]`` list into ``[S, Q, k]``), ``all_reduce_sum`` and ``merge_shards``;
and ``Channel``, the HTTP server's group beside the mesh's (rank 0's
messages to every rank, the count of the ranks that failed a step).
Training, each an autograd function where a gradient crosses it:

  * ``all_gather_cat`` — every rank's rows along ``data`` (or columns along
    ``model``: SPLADE's vocabulary), concatenated; the backward keeps this
    rank's slice of the upstream gradient.  Every rank computes the same
    loss from the gathered rows, so that slice is the whole gradient of its
    rows, and the parameter gradients are then summed over ``data``
    (``all_reduce_flat``), not averaged: the pair that sums the gradient
    once.  (The other pair, a reduce-scatter backward, sums the same
    upstream gradient from every rank, and the gradients must then be
    averaged.)
  * ``copy_to_model`` / ``reduce_from_model`` — Megatron's pair over
    ``model``: the identity forward and an all-reduce backward at the input
    of a column-parallel layer, an all-reduce forward and the identity
    backward at the output of a row-parallel one;
  * ``all_reduce_flat`` — one all-reduce of a flat bucket of tensors (the
    gradients of every trainable leaf), not one call per leaf;
  * ``all_gather_flat`` — one all-gather of a flat bucket (the sharded
    gradients and parameters, whole again for the optimizer).

Under ``gloo`` a CUDA tensor is copied to host memory and back around the
call, inside the autograd functions too (gloo stages CUDA tensors through the
host in any case; doing the copy here keeps the kernels on the card whatever
a torch build's gloo accepts).  NCCL refuses two ranks on one card, so two
ranks sharing a card use gloo.  ``COLLECTIVES`` counts each rank's calls,
bytes and host seconds inside them.

Tensor parallelism follows JAX's rules (``_ENCODER_TP_RULES``, regexes over
the Flax parameter paths): the fused qkv and the FFN's inner dimension are
column-parallel over ``model`` (attention by heads), the attention ``out``
and ``ffn_out`` row-parallel with their biases replicated, SPLADE's MLM
decoder column-parallel over the vocabulary; everything else is replicated
(X-MOD's adapters, and the whole of a T5 trunk, whose leaf names match no
rule: every ``model`` rank computes it, as JAX's replicated leaves do).
``encoder_param_spec`` returns JAX's specs as tuples (``P()`` is ``()``),
``shard_params`` a rank's slice of a Flax tree, and ``shard_module`` slices a
port module's parameters in place through their Flax layouts
(``convert.flax_layouts``): each sliced parameter carries ``tp_shard``, its
layout and split dimension, from which ``gather_whole`` and
``unshard_module`` make it whole again.

The JAX module's ``cached_shard_program`` and its ``NamedSharding`` helpers
(``replicated``, ``data_sharding``, ``index_sharding``) have no counterpart:
there is no compiled mesh program to cache, and a rank's shard is an ordinary
tensor on its device.
"""

from __future__ import annotations

import dataclasses
import pickle
import re
import time
from typing import NamedTuple, Sequence

import torch
import torch.distributed as dist

from fusion_tpu_torch.core.device import resolve_device
from fusion_tpu_torch.core.ranked import PAD_ID, RankedLists, stable_topk

DATA_AXIS = "data"
MODEL_AXIS = "model"
INDEX_AXIS = "index"
AXES = (DATA_AXIS, MODEL_AXIS, INDEX_AXIS)

# each rank's collective traffic: calls, bytes it contributes, host seconds;
# and the calls it entered (a call that never returns counts here alone)
COLLECTIVES = {"calls": 0, "bytes": 0, "seconds": 0.0, "entered": 0}

# the device initialize_multihost gave this process (make_mesh's default),
# and the timeout it gave the group (every group made here takes it; None:
# torch's default)
_DEFAULT_DEVICE: list = [None]
_GROUP_TIMEOUT: list = [None]


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
            group = dist.new_group(members, timeout=_GROUP_TIMEOUT[0])
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
    COLLECTIVES["entered"] += 1
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
    COLLECTIVES["entered"] += 1
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


class Channel:
    """A process group of every rank of ``mesh`` beside the searchers' own,
    for a host program that drives them all from rank 0 (the HTTP server):
    ``broadcast`` sends rank 0's picklable message to every rank (a length,
    then the bytes as ``uint8``, on the rank's card under NCCL and in host
    memory under gloo), and ``failures`` tells every rank how many ranks
    failed a step and whether they failed at the same point.  A group of its
    own keeps these calls from pairing with a searcher's: a rank that fails
    before a collective waits here while the others wait there, and each
    raises at the group's timeout.  Every rank builds it, in the same order
    (``dist.new_group`` is collective)."""

    def __init__(self, mesh: Mesh):
        world = dist.get_world_size()
        if mesh.size != world:
            raise ValueError(f"a channel spans the whole group: the mesh holds {mesh.size} of {world} ranks")
        self.size = world
        self.group = dist.new_group(list(range(world)), timeout=_GROUP_TIMEOUT[0])
        self.rank = dist.get_rank()
        self.device = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
        # the longest a rank 0 with nothing to send may wait before it sends
        # a message anyway: a quarter of the group's timeout, at most 5 s
        timeout = _GROUP_TIMEOUT[0]
        self.idle_s = 5.0 if timeout is None else min(5.0, timeout.total_seconds() / 4)

    def broadcast(self, message=None):
        """Rank 0's ``message`` on every rank (the others pass nothing)."""
        t0 = time.perf_counter()
        payload = pickle.dumps(message) if self.rank == 0 else b""
        size = torch.tensor([len(payload)], dtype=torch.int64, device=self.device)
        dist.broadcast(size, src=0, group=self.group)
        if self.rank == 0:
            buf = torch.frombuffer(bytearray(payload), dtype=torch.uint8).to(self.device)
        else:
            buf = torch.empty(int(size.item()), dtype=torch.uint8, device=self.device)
        dist.broadcast(buf, src=0, group=self.group)
        _count(buf, t0)
        if self.rank:  # a receiver's wait for the next message is idle time, not the call's
            COLLECTIVES["seconds"] -= time.perf_counter() - t0
        # rank 0 of this program wrote the bytes
        return message if self.rank == 0 else pickle.loads(buf.cpu().numpy().tobytes())

    def failures(self, failed: bool, entered: int) -> tuple[int, bool]:
        """(ranks that failed the step, whether every rank entered the same
        number of collectives in it), from this rank's ``failed`` and
        ``entered`` (``COLLECTIVES["entered"]``'s growth over the step)."""
        t0 = time.perf_counter()
        mine = torch.tensor([int(failed), entered], dtype=torch.int64, device=self.device)
        parts = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(parts, mine, group=self.group)
        _count(mine, t0)
        table = torch.stack(parts).cpu()
        return int(table[:, 0].sum()), bool((table[:, 1] == table[0, 1]).all())




# ----------------------------------------------------------------------
# the training collectives
# ----------------------------------------------------------------------
def _active(mesh: Mesh | None, axis: str) -> bool:
    return mesh is not None and mesh.groups[axis] is not None


class _AllGatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.n = mesh, axis, dim, x.shape[dim]
        return torch.cat(list(all_gather(x, mesh, axis).unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.mesh.coords[ctx.axis] * ctx.n
        return grad.narrow(ctx.dim, start, ctx.n), None, None, None


def all_gather_cat(x: torch.Tensor, mesh: Mesh | None, axis: str = DATA_AXIS, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, concatenated on ``dim`` in
    coordinate order; the backward keeps this rank's slice of the gradient
    (see the module's note on summing the gradients once).  The identity on
    an axis of one rank."""
    if not _active(mesh, axis):
        return x
    return _AllGatherCat.apply(x, mesh, axis, dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.mesh, MODEL_AXIS), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_sum(x, mesh, MODEL_AXIS)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The input of a column-parallel layer: the identity forward, the sum
    of every ``model`` rank's gradient backward."""
    return _CopyToModel.apply(x, mesh) if _active(mesh, MODEL_AXIS) else x


def reduce_from_model(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The output of a row-parallel layer: the sum over ``model`` forward,
    the identity backward."""
    return _ReduceFromModel.apply(x, mesh) if _active(mesh, MODEL_AXIS) else x


def all_reduce_flat(tensors: list[torch.Tensor], mesh: Mesh | None, axis: str = DATA_AXIS) -> None:
    """Sum ``tensors`` over ``axis`` in place, through one flat f32 bucket
    (one collective for all of them)."""
    if not _active(mesh, axis) or not tensors:
        return
    flat = all_reduce_sum(torch.cat([t.reshape(-1).float() for t in tensors]), mesh, axis)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset : offset + t.numel()].view_as(t))
        offset += t.numel()


def all_gather_flat(tensors: list[torch.Tensor], mesh: Mesh, axis: str = MODEL_AXIS) -> list[list[torch.Tensor]]:
    """Every rank's ``tensors`` along ``axis`` through one flat f32 bucket:
    ``out[i][r]`` is rank ``r``'s ``tensors[i]`` (each rank's tensors have
    the same shapes)."""
    if not tensors:
        return []
    parts = all_gather(torch.cat([t.reshape(-1).float() for t in tensors]), mesh, axis)
    out, offset = [], 0
    for t in tensors:
        out.append([parts[r, offset : offset + t.numel()].view(t.shape) for r in range(parts.shape[0])])
        offset += t.numel()
    return out


# ----------------------------------------------------------------------
# encoder tensor-parallel rules
# ----------------------------------------------------------------------
# path regex → spec over the Flax parameter tree, as JAX's rules: attention
# shards over heads, the FFN over its inner dimension, the MLM decoder over
# the vocabulary; the word embeddings and everything else are replicated
_ENCODER_TP_RULES: list[tuple[str, tuple]] = [
    (r".*attention/qkv/kernel", (None, None, MODEL_AXIS, None)),
    (r".*attention/qkv/bias", (None, MODEL_AXIS, None)),
    (r".*attention/out/kernel", (MODEL_AXIS, None, None)),
    (r".*attention/out/bias", ()),
    (r".*ffn_in/kernel", (None, MODEL_AXIS)),
    (r".*ffn_in/bias", (MODEL_AXIS,)),
    (r".*ffn_out/kernel", (MODEL_AXIS, None)),
    (r".*ffn_out/bias", ()),
    (r".*embeddings/word/embedding", (None, None)),
    (r".*mlm/decoder/kernel", (None, MODEL_AXIS)),
    (r".*mlm/decoder/bias", (MODEL_AXIS,)),
    (r".*", ()),
]


def param_spec(path: Sequence[str]) -> tuple:
    """The spec of the Flax leaf at ``path``: a tuple of axis names or None
    per dimension (``()``: replicated)."""
    key = "/".join(str(k) for k in path)
    for pattern, spec in _ENCODER_TP_RULES:
        if re.fullmatch(pattern, key):
            return spec
    return ()


def encoder_param_spec(params) -> dict:
    """The spec tree of a Flax encoder parameter tree (nested dicts), leaf
    for leaf as JAX's ``PartitionSpec`` tree (``tuple(P(...))``)."""

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return param_spec(path)

    return walk(params, ())


def _split_dim(spec: tuple, mesh: Mesh) -> int | None:
    """The dimension ``spec`` splits over ``model`` on ``mesh`` (None:
    whole on every rank)."""
    if MODEL_AXIS not in spec or mesh.shape[MODEL_AXIS] == 1:
        return None
    return spec.index(MODEL_AXIS)


def _local(x, dim: int, mesh: Mesh):
    size, coord = mesh.shape[MODEL_AXIS], mesh.coords[MODEL_AXIS]
    n = x.shape[dim]
    if n % size:
        raise ValueError(f"dimension {dim} of size {n} does not split over {size} model ranks")
    per = n // size
    if isinstance(x, torch.Tensor):
        return x.narrow(dim, coord * per, per)
    return x.take(range(coord * per, (coord + 1) * per), axis=dim)


def shard_params(params, mesh: Mesh):
    """This rank's slice of a Flax tree (numpy or tensor leaves) by
    ``encoder_param_spec``: JAX's ``addressable_shards`` of the rank."""

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        dim = _split_dim(param_spec(path), mesh)
        return node if dim is None else _local(node, dim, mesh)

    return walk(params, ())


class TPShard(NamedTuple):
    """How a parameter was sliced: its Flax layout and the dimension of
    that layout split over ``model``."""

    layout: object  # convert.FlaxLayout
    dim: int


def shard_module(module: torch.nn.Module, mesh: Mesh, num_heads: int) -> None:
    """Slice ``module``'s parameters in place to this rank's part by
    ``encoder_param_spec`` over their Flax layouts, and give every submodule
    the mesh (``tp_mesh``) its forward runs the collectives on.  Idempotent.
    An X-MOD trunk splits as the encoder's (its adapters stay whole); none
    of a T5 trunk's paths matches a rule, so it stays whole and every
    ``model`` rank computes all of it, as in JAX."""
    from fusion_tpu_torch.models import convert

    if mesh.shape[MODEL_AXIS] == 1 or getattr(module, "tp_mesh", None) is not None:
        return
    for name, lay in convert.flax_layouts(module, num_heads).items():
        dim = _split_dim(param_spec(lay.path), mesh)
        if dim is None:
            continue
        p = module.get_parameter(name)
        with torch.no_grad():
            p.data = lay.from_flax(_local(lay.to_flax(p.detach()), dim, mesh)).contiguous()
        p.tp_shard = TPShard(lay, dim)
    for m in module.modules():
        m.tp_mesh = mesh


def gather_whole(pairs: list, mesh: Mesh, mean: Sequence[torch.Tensor] = ()) -> list[torch.Tensor]:
    """``[(parameter, tensor)]`` of sliced parameters (each tensor shaped as
    its parameter: the parameter itself, or its gradient) → each tensor
    whole over ``model`` in the parameter's Flax layout, followed by each
    tensor of ``mean`` averaged over ``model``, through one
    ``all_gather_flat``.  (``mean`` takes the replicated parameters'
    gradients: every ``model`` rank computes them whole, but a kernel with
    atomics, such as the embedding backward on the card, may round them
    otherwise on each rank; their mean is the same bits everywhere.)"""
    local = [p.tp_shard.layout.to_flax(t).contiguous() for p, t in pairs] + [t.contiguous() for t in mean]
    gathered = all_gather_flat(local, mesh, MODEL_AXIS)
    whole = [torch.cat(parts, dim=p.tp_shard.dim).to(t.dtype) for (p, t), parts in zip(pairs, gathered)]
    return whole + [torch.stack(parts).mean(0).to(t.dtype) for t, parts in zip(mean, gathered[len(pairs):])]


def local_slice(whole_flax: torch.Tensor, param, mesh: Mesh) -> torch.Tensor:
    """This rank's part of a whole Flax-layout tensor of ``param``, in the
    port's layout."""
    shard = param.tp_shard
    return shard.layout.from_flax(_local(whole_flax, shard.dim, mesh))


def unshard_module(module: torch.nn.Module, mesh: Mesh) -> None:
    """Make ``module``'s sliced parameters whole again (every rank calls it),
    so the model saves and serves as on one device."""
    if getattr(module, "tp_mesh", None) is None:
        return
    sharded = [p for p in module.parameters() if hasattr(p, "tp_shard")]
    whole = gather_whole([(p, p.detach()) for p in sharded], mesh)
    with torch.no_grad():
        for p, flax_whole in zip(sharded, whole):
            p.data = p.tp_shard.layout.from_flax(flax_whole).contiguous()
            del p.tp_shard
    for m in module.modules():
        m.tp_mesh = None
