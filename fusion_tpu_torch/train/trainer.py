"""Training: the host loop ``fit``, its train state, and one train-step
factory per model family, as ``fusion_tpu/train/trainer.py``:

  * ``make_biencoder_train_step`` — dense MNRL, SPLADE InfoNCE (in-batch
    negatives with the aligned positive at -1e9) plus sparsity
    regularizers, MarginMSE and KLD distillation (``biencoder_loss``);
  * ``make_colbert_train_step`` — CE over [pos, negs] MaxSim scores, or KLD
    against teacher scores;
  * ``make_crossencoder_train_step`` — pointwise BCE.

A step runs the forward in the model's compute dtype over f32 master
weights (the model built with ``param_dtype=torch.float32``), backpropagates,
reads each gradient in the JAX package's layout (``convert.flax_layouts``)
and applies the optimizer chain of ``train/optim.py`` in place.  Dropout
masks come from ``DropoutKey(dropout_seed, step, stream)``: the factory's
``dropout_seed`` (JAX's parameter, default 0) is their one source, so a
resumed run draws the masks an uninterrupted one would.
``freeze_layers_except_last_n`` leaves the frozen parameters out of the
chain: they neither move nor enter the clip norm (optax's
``multi_transform`` with ``set_to_zero``).

With a ``mesh`` (``parallel.sharding.make_mesh``: one process per rank,
joined by ``parallel.multihost.initialize_multihost``) a factory returns the
data- and tensor-parallel step of ``_finalize_step``, whose loss is the loss
of the global batch, as JAX's jitted step over a sharded batch computes it:

  * every rank is given the global batch and takes its rows along ``data``;
  * each loss gathers its per-row values over ``data`` with their gradient
    before it reduces them: the embeddings of the bi-encoders (MNRL's and
    InfoNCE's in-batch negatives and the FLOPS regularizer span every
    rank's rows), ColBERT's scores, the cross-encoder's logits;
  * the gradients are summed over ``data`` through one flat bucket
    (``sharding.all_reduce_flat``; the gather's backward keeps a rank's own
    slice, so the sum counts each row once);
  * under ``model > 1`` the trunk runs tensor-parallel (``place_state``
    slices the parameters by ``encoder_param_spec``), and the optimizer runs
    on whole leaves, as JAX's replicated optimizer state does: the sliced
    gradients and parameters are gathered over ``model`` (one bucket, with
    the replicated gradients averaged in it, so every rank holds the same
    bits), the chain runs the same on every rank, and each rank keeps its
    slice of the update;
  * dropout masks are drawn at the global shape and each rank keeps its rows
    and heads, so the parallel step equals the one-device step over the
    global batch at any rate.

The train state is saved with ``torch.save`` (params, optimizer state, step
and the ``FitConfig`` seed it was made with); the JAX package saves its own
with Orbax, and neither reads the other's.  Under a mesh, rank 0 alone logs
and writes, and a saved state holds whole parameters.
"""

from __future__ import annotations

import os
import queue
import re
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator, NamedTuple

import numpy as np
import torch

from fusion_tpu_torch.models import checkpoint, convert, heads
from fusion_tpu_torch.models.encoder import DropoutKey
from fusion_tpu_torch.parallel import sharding
from fusion_tpu_torch.parallel.multihost import is_primary_host
from fusion_tpu_torch.parallel.sharding import DATA_AXIS, MODEL_AXIS, all_gather_cat
from fusion_tpu_torch.train import losses
from fusion_tpu_torch.train.optim import (
    AdamState,
    FactoredState,
    ShampooParamState,
    ShampooState,
    get_optimizer,
    no_decay_mask,
)
from fusion_tpu_torch.train.schedules import get_schedule


class TrainState(NamedTuple):
    params: dict  # name → the module's trainable parameter (updated in place)
    opt_state: Any
    step: int
    seed: int = 0  # the FitConfig seed the state was made with (the masks take the factory's dropout_seed)


@dataclass
class FitConfig:
    """Knobs shared by every trainer command."""

    steps: int = 1000
    batch_size: int = 32
    optimizer_name: str = "AdamW"
    learning_rate: float = 2e-5
    weight_decay: float = 0.01
    scheduler: str = "linear"
    warmup_ratio: float = 0.04
    max_grad_norm: float = 1.0
    log_every_n_steps: int = 0
    log_callback: Callable | None = None
    ckpt_path: str | None = None
    ckpt_save_steps: int | None = None
    ckpt_save_limit: int = 3
    seed: int = 42
    eval_every_n_steps: int = 0
    eval_callback: Callable | None = None
    freeze_layers_except_last_n: int | None = None
    # batches staged onto the device ahead of the compute stream by a
    # background thread (0 = feed synchronously from the loop thread)
    prefetch: int = 2


def _to_device(batch: dict, device: torch.device | None) -> dict:
    """Host arrays → tensors on ``device``: token ids as int64, through
    pinned memory and an asynchronous copy on the card."""
    out = {}
    for k, v in batch.items():
        if v is None:
            continue
        t = torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else torch.as_tensor(v)
        if k.endswith("_ids"):
            t = t.to(torch.int64)
        if device is not None and device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        elif device is not None:
            t = t.to(device)
        out[k] = t
    return out


MAX_CACHED_BATCHES = 1024  # the most batches of a plain iterator that fit keeps for cycling


def _prefetch_batches(data_iterator, steps: int, depth: int, device: torch.device | None = None):
    """Yield ``steps`` device-placed batches, cycling the iterator.

    A re-iterable input (a list, ``data.datasets.Batches``) is iterated again
    when it runs dry and nothing is cached.  A plain iterator or generator
    has its first ``MAX_CACHED_BATCHES`` batches cached and the cache cycled
    when it ends; past that many the cache is dropped (an endless generator
    keeps no batches), and such an iterator ending raises.  With ``depth``
    > 0 a daemon thread pulls and places up to ``depth`` batches ahead; its
    errors are raised in the caller's thread."""

    def gen():
        it = iter(data_iterator)
        reiterable = it is not data_iterator
        seen: list[dict] | None = []  # None once more than MAX_CACHED_BATCHES were drawn
        cache_pos = 0
        for _ in range(steps):
            batch = None
            if it is not None:
                try:
                    batch = next(it)
                    if not reiterable and seen is not None:
                        seen.append(batch)
                        if len(seen) > MAX_CACHED_BATCHES:
                            seen = None
                except StopIteration:
                    if reiterable:
                        it = iter(data_iterator)
                        batch = next(it)  # an empty re-iterable raises
                    elif seen is None:
                        raise ValueError(
                            f"a plain iterator ended after more than {MAX_CACHED_BATCHES} batches and cannot be"
                            " cycled: pass a re-iterable (a list, data.datasets.Batches)"
                        ) from None
                    else:
                        it = None
            if batch is None:
                if not seen:
                    raise ValueError("data_iterator yielded no batches")
                batch = seen[cache_pos % len(seen)]
                cache_pos += 1
            yield _to_device(batch, device)

    if depth <= 0:
        yield from gen()
        return

    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()

    def worker():
        try:
            for placed in gen():
                q.put(placed)
            q.put(end)
        except BaseException as e:  # noqa: BLE001 - handed to the consuming thread, which raises it
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


# ----------------------------------------------------------------------
# parameters: layouts, freeze labels, the optimizer
# ----------------------------------------------------------------------
def _layouts(model) -> dict[str, convert.FlaxLayout]:
    return convert.flax_layouts(model.module, model.cfg.num_heads)


def freeze_labels(paths, num_trainable_top_layers: int) -> dict:
    """JAX path → 'train' / 'freeze': encoder layers below the top
    ``num_trainable_top_layers`` and the embeddings freeze, heads train."""
    paths = list(paths)
    max_layer = max(
        (int(m.group(1)) for p in paths for k in p if (m := re.fullmatch(r"layer_(\d+)", str(k)))), default=-1
    )
    cutoff = max_layer - num_trainable_top_layers + 1

    def label(keys):
        for k in keys:
            m = re.fullmatch(r"layer_(\d+)", str(k))
            if m:
                return "train" if int(m.group(1)) >= cutoff else "freeze"
        return "freeze" if "embeddings" in keys else "train"

    return {p: label(p) for p in paths}


def build_optimizer(cfg: FitConfig, paths):
    """(optimizer chain over the trainable JAX paths, schedule)."""
    schedule = get_schedule(cfg.scheduler, cfg.learning_rate, cfg.steps, cfg.warmup_ratio)
    tx = get_optimizer(
        cfg.optimizer_name, schedule, weight_decay=cfg.weight_decay, max_grad_norm=cfg.max_grad_norm,
        mask=no_decay_mask(paths),
    )
    return tx, schedule


def init_train_state(model, cfg: FitConfig):
    """(TrainState, optimizer, schedule) for ``model``, whose parameters must
    be f32 master weights; frozen parameters stop taking gradients."""
    layouts = _layouts(model)
    named = dict(model.module.named_parameters())
    labels = None
    if cfg.freeze_layers_except_last_n is not None:
        labels = freeze_labels([lay.path for lay in layouts.values()], cfg.freeze_layers_except_last_n)
    params = {}
    for name, p in named.items():
        if labels is not None and labels[layouts[name].path] == "freeze":
            p.requires_grad_(False)
            continue
        if p.dtype != torch.float32:
            raise ValueError(
                f"parameter {name} is {p.dtype}: training needs f32 master weights "
                "(build the model with param_dtype=torch.float32)"
            )
        p.requires_grad_(True)
        params[name] = p
    tx, schedule = build_optimizer(cfg, [layouts[n].path for n in params])
    opt_state = tx.init({layouts[n].path: layouts[n].to_flax(p.detach()) for n, p in params.items()})
    return TrainState(params, opt_state, 0, cfg.seed), tx, schedule


def _dropout_key(seed: int, step: int, stream: int, mesh) -> DropoutKey:
    """The step's ``DropoutKey`` of ``stream``, with this rank's place on
    the mesh's ``data`` and ``model`` axes."""
    if mesh is None:
        return DropoutKey(seed, step, stream)
    return DropoutKey(seed, step, stream, (mesh.coords[DATA_AXIS], mesh.shape[DATA_AXIS]),
                      (mesh.coords[MODEL_AXIS], mesh.shape[MODEL_AXIS]))


def reduce_gradients(params: dict, mesh) -> tuple[dict, dict, dict]:
    """The gradients of ``params`` (name → parameter, after a backward) as
    the parallel step updates with them: summed over ``data`` through one
    flat bucket, and under ``model > 1`` the sliced ones gathered whole (with
    their parameters) and the replicated ones averaged over ``model``,
    through one all-gather.  → (gradients by name in the port's layout,
    whole gradients and whole parameters of the sliced names in the Flax
    layout)."""
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p) for n, p in params.items()}
    sharding.all_reduce_flat(list(grads.values()), mesh, DATA_AXIS)
    if mesh is None or mesh.shape[MODEL_AXIS] == 1:
        return grads, {}, {}
    sliced = [n for n, p in params.items() if hasattr(p, "tp_shard")]
    replicated = [n for n in params if n not in sliced]
    pairs = [(params[n], grads[n]) for n in sliced] + [(params[n], params[n].detach()) for n in sliced]
    out = sharding.gather_whole(pairs, mesh, mean=[grads[n] for n in replicated])
    k = len(sliced)
    grads.update(zip(replicated, out[2 * k:]))
    return grads, dict(zip(sliced, out[:k])), dict(zip(sliced, out[k : 2 * k]))


def _make_step(model, tx, loss_fn, mesh=None, dropout_seed: int = 0):
    """``(state, batch) → (state, metrics)``: one forward and backward of
    ``loss_fn(batch, step, dropout_seed, mesh)``, the gradients reduced over
    the mesh (``reduce_gradients``), then the optimizer chain over them in
    the JAX layout, applied in place (a sliced parameter takes its slice of
    the update)."""
    layouts = _layouts(model)
    tensor_parallel = mesh is not None and mesh.shape[MODEL_AXIS] > 1

    def train_step(state: TrainState, batch: dict):
        if tensor_parallel and getattr(model.module, "tp_mesh", None) is None:
            raise ValueError("a step with model > 1 runs on sliced parameters: call step.place_state(state) first")
        for p in state.params.values():
            p.grad = None
        loss, metrics = loss_fn(batch, state.step, dropout_seed, mesh)
        loss.backward()
        local_grads, whole_grads, whole_params = reduce_gradients(state.params, mesh)
        grads, views = {}, {}
        for name, p in state.params.items():
            lay = layouts[name]
            grads[lay.path] = whole_grads[name] if name in whole_grads else lay.to_flax(local_grads[name])
            views[lay.path] = whole_params[name] if name in whole_params else lay.to_flax(p.detach())
        updates, opt_state = tx.update(grads, state.opt_state, views)
        with torch.no_grad():
            for name, p in state.params.items():
                update = updates[layouts[name].path]
                sliced = name in whole_params
                p.add_(sharding.local_slice(update, p, mesh) if sliced else layouts[name].from_flax(update))
                p.grad = None
        return TrainState(state.params, opt_state, state.step + 1, state.seed), {
            k: v.detach() for k, v in metrics.items()
        }

    return _finalize_step(model, train_step, mesh)


def _local_rows(value, mesh):
    """This rank's rows of a global batch array along ``data``."""
    rows, coord = mesh.shape[DATA_AXIS], mesh.coords[DATA_AXIS]
    n = value.shape[0]
    if n % rows:
        raise ValueError(f"a batch of {n} rows does not split over {rows} data ranks")
    per = n // rows
    return value[coord * per : (coord + 1) * per]


def _finalize_step(model, train_step, mesh):
    """``train_step`` as it is without a mesh; with one, a step that takes
    the global batch (as JAX's callers give it) and runs on this rank's rows,
    with ``place_state(state)``: the parameters sliced by
    ``encoder_param_spec`` in place (under ``model > 1``; call it after
    ``init_train_state`` and before the first step), the optimizer state
    kept whole, as JAX's at ``P()``."""
    if mesh is None:
        return train_step

    def sharded_step(state: TrainState, batch: dict):
        return train_step(state, {k: _local_rows(v, mesh) for k, v in batch.items()})

    def place_state(state: TrainState) -> TrainState:
        sharding.shard_module(model.module, mesh, model.cfg.num_heads)
        return state

    sharded_step.place_state = place_state
    sharded_step.mesh = mesh
    return sharded_step


# ----------------------------------------------------------------------
# bi-encoder (dense MNRL / SPLADE InfoNCE+regs / MarginMSE / KLD)
# ----------------------------------------------------------------------
def biencoder_loss(model, batch: dict, step: int, rank_loss_config: dict, reg_loss_config: dict | None,
                   total_steps: int, seed: int = 0, mesh=None):
    """Shared loss of dense and sparse bi-encoders → (loss, metrics).

    Batch: query_ids/mask [B, Lq], pos_ids/mask [B, Ld], neg_ids/mask
    [B*N, Ld]; optional teacher_pos [B] / teacher_neg [B*N].  With a
    ``mesh`` the batch is this rank's rows and the embeddings are gathered
    over ``data`` first: the loss of the global batch."""
    q = model.embed_tokens_train(batch["query_ids"], batch["query_mask"], _dropout_key(seed, step, 0, mesh))
    p = model.embed_tokens_train(batch["pos_ids"], batch["pos_mask"], _dropout_key(seed, step, 1, mesh))
    n = model.embed_tokens_train(batch["neg_ids"], batch["neg_mask"], _dropout_key(seed, step, 2, mesh))
    q, p, n = (all_gather_cat(x, mesh) for x in (q, p, n))
    bs = q.shape[0]
    npq = n.shape[0] // bs
    sim = model.similarity
    name = rank_loss_config.get("name", "MNRLoss")

    if name == "MNRLoss":  # in-batch MNRL over positives and hard negatives
        rank_loss = losses.mnrl(q, torch.cat([p, n], dim=0), scale=rank_loss_config.get("scale", 20.0),
                                similarity=sim)
    else:
        pos_scores = heads.pairwise_similarity(q, p, sim)
        neg_scores = heads.pairwise_similarity(q[:, None, :], n.reshape(bs, npq, -1), sim)
        if name == "InfoNCELoss":
            neg_all = neg_scores
            if rank_loss_config.get("use_ib_negs", False):
                ib = heads.batchwise_similarity(q, p, sim)
                eye = torch.eye(bs, dtype=torch.bool, device=ib.device)
                neg_all = torch.cat([neg_scores.float(), torch.where(eye, -1e9, ib)], dim=-1)
            rank_loss = losses.info_nce(pos_scores, neg_all, temperature=rank_loss_config.get("temperature", 1.0))
        elif name in ("MarginMSELoss", "KLDLoss"):
            fn = losses.margin_mse if name == "MarginMSELoss" else losses.kld
            teacher_pos, teacher_neg = (all_gather_cat(batch[k], mesh) for k in ("teacher_pos", "teacher_neg"))
            rank_loss = fn(pos_scores, neg_scores, teacher_pos, teacher_neg.reshape(bs, npq),
                           teacher_scale=rank_loss_config.get("teacher_scale", 1.0))
        else:
            raise ValueError(f"unknown rank loss {name!r}")

    metrics = {"rank_loss": rank_loss}
    total = rank_loss
    if reg_loss_config:
        target = int(total_steps / 3)
        q_name, d_name = reg_loss_config.get("query_reg", "FlopsLoss"), reg_loss_config.get("doc_reg", "FlopsLoss")
        q_reg = losses.regularizer(q_name, q, reg_loss_config.get("query_reg_weight", 0.0), step=step,
                                   target_step=target if reg_loss_config.get("query_reg") == "FlopsLoss" else None)
        d_reg = losses.regularizer(d_name, torch.cat([p, n], dim=0), reg_loss_config.get("doc_reg_weight", 0.0),
                                   step=step,
                                   target_step=target if reg_loss_config.get("doc_reg") == "FlopsLoss" else None)
        total = total + q_reg + d_reg
        metrics.update({"query_reg_loss": q_reg, "doc_reg_loss": d_reg})
    metrics["loss"] = total
    return total, metrics


def make_biencoder_train_step(model, tx, rank_loss_config: dict, reg_loss_config: dict | None, total_steps: int,
                              mesh=None, dropout_seed: int = 0):
    """The bi-encoder step; with ``mesh``, data- and tensor-parallel (see
    the module's note)."""
    return _make_step(model, tx, lambda batch, step, seed, mesh: biencoder_loss(
        model, batch, step, rank_loss_config, reg_loss_config, total_steps, seed, mesh), mesh, dropout_seed)


# ----------------------------------------------------------------------
# ColBERT (late interaction over token embeddings)
# ----------------------------------------------------------------------
def colbert_loss(model, batch: dict, step: int, loss_name: str = "ce", seed: int = 0, mesh=None):
    """CE over [pos, negs] MaxSim scores, or KLD against teacher scores;
    with a ``mesh``, over the scores of every ``data`` rank."""
    q_tok = model.embed_tokens_train(batch["query_ids"], batch["query_mask"], _dropout_key(seed, step, 0, mesh))
    p_tok = model.embed_tokens_train(batch["pos_ids"], batch["pos_mask"], _dropout_key(seed, step, 1, mesh))
    n_tok = model.embed_tokens_train(batch["neg_ids"], batch["neg_mask"], _dropout_key(seed, step, 2, mesh))
    bs, ld = q_tok.shape[0], n_tok.shape[1]
    npq = n_tok.shape[0] // bs
    q_mask = batch["query_mask"].float()
    pos_scores = model.pairwise_maxsim(q_tok, q_mask, p_tok, batch["pos_mask"])
    neg_scores = model.nway_maxsim(q_tok, q_mask, n_tok.reshape(bs, npq, ld, -1),
                                   batch["neg_mask"].reshape(bs, npq, ld))
    pos_scores, neg_scores = all_gather_cat(pos_scores, mesh), all_gather_cat(neg_scores, mesh)
    if loss_name == "kld":
        teacher_pos, teacher_neg = (all_gather_cat(batch[k], mesh) for k in ("teacher_pos", "teacher_neg"))
        loss = losses.kld(pos_scores, neg_scores, teacher_pos, teacher_neg.reshape(pos_scores.shape[0], npq))
    else:
        loss = losses.info_nce(pos_scores, neg_scores)
    return loss, {"loss": loss}


def make_colbert_train_step(model, tx, loss_name: str = "ce", total_steps: int = 0, dropout_seed: int = 0,
                            mesh=None):
    """The ColBERT step (``total_steps`` is JAX's parameter, unused by the
    loss); with ``mesh``, data- and tensor-parallel."""
    return _make_step(model, tx, lambda batch, step, seed, mesh: colbert_loss(
        model, batch, step, loss_name, seed, mesh), mesh, dropout_seed)


# ----------------------------------------------------------------------
# cross-encoder (pointwise BCE)
# ----------------------------------------------------------------------
def crossencoder_loss(model, batch: dict, step: int, seed: int = 0, mesh=None):
    """Pointwise BCE; with a ``mesh``, over the logits of every ``data``
    rank."""
    logits = model.score_tokens_train(batch["pair_ids"], batch["pair_mask"], _dropout_key(seed, step, 0, mesh))
    loss = losses.bce_logits(all_gather_cat(logits, mesh), all_gather_cat(batch["labels"], mesh))
    return loss, {"loss": loss}


def make_crossencoder_train_step(model, tx, dropout_seed: int = 0, mesh=None):
    """The cross-encoder step; with ``mesh``, data- and tensor-parallel."""
    return _make_step(model, tx, lambda batch, step, seed, mesh: crossencoder_loss(model, batch, step, seed, mesh),
                      mesh, dropout_seed)


# ----------------------------------------------------------------------
# the host loop
# ----------------------------------------------------------------------
def fit(model, train_step, data_iterator: Iterable[dict] | Iterator[dict], cfg: FitConfig, schedule=None,
        state: TrainState | None = None) -> TrainState:
    """Drive ``train_step`` for ``cfg.steps`` steps over ``data_iterator``
    (dict batches of numpy arrays, cycled when exhausted).  Step numbers are
    counted on the host from ``state.step``; logging goes through
    ``cfg.log_callback(epoch, steps_per_epoch, step, lr, value, name)``,
    rolling checkpoints to ``cfg.ckpt_path``, evaluation through
    ``cfg.eval_callback(model, step)``.  Under a parallel step (one with a
    ``mesh``) every rank runs the loop; rank 0 alone logs and writes the
    checkpoints, whole (every rank takes part in gathering them)."""
    if state is None:
        raise ValueError("pass an initialized TrainState (use init_train_state)")
    mesh = getattr(train_step, "mesh", None)
    primary = is_primary_host()
    log = cfg.log_callback if primary else None
    base_step = int(state.step)
    t0 = time.perf_counter()
    device = getattr(model, "device", None)
    for local_step, batch in enumerate(_prefetch_batches(data_iterator, cfg.steps, cfg.prefetch, device)):
        state, metrics = train_step(state, batch)
        step_num = base_step + local_step + 1
        if log is not None and cfg.log_every_n_steps > 0 and (local_step + 1) % cfg.log_every_n_steps == 0:
            lr = float(schedule(step_num)) if schedule is not None else cfg.learning_rate
            for name, value in metrics.items():
                log(0, 0, step_num, lr, float(value), name)
        if cfg.ckpt_path and cfg.ckpt_save_steps and (local_step + 1) % cfg.ckpt_save_steps == 0:
            with whole_parameters(model, mesh):
                if primary:
                    checkpoint.save_step(model, cfg.ckpt_path, step_num, cfg.ckpt_save_limit)
        if cfg.eval_callback is not None and cfg.eval_every_n_steps > 0 and (local_step + 1) % cfg.eval_every_n_steps == 0:
            cfg.eval_callback(model, step_num)
    elapsed = time.perf_counter() - t0
    if log is not None and cfg.log_every_n_steps:
        log(0, 0, int(state.step), 0.0, elapsed / max(cfg.steps, 1), "sec_per_step")
    return state


class whole_parameters:
    """Context: ``model``'s parameters whole over the mesh's ``model`` axis
    inside the block (every rank enters it), sliced again after; nothing to
    do without tensor parallelism."""

    def __init__(self, model, mesh):
        self.model, self.mesh = model, mesh
        self.sliced = mesh is not None and getattr(model.module, "tp_mesh", None) is not None

    def __enter__(self):
        if self.sliced:
            sharding.unshard_module(self.model.module, self.mesh)
        return self.model

    def __exit__(self, *exc):
        if self.sliced:
            sharding.shard_module(self.model.module, self.mesh, self.model.cfg.num_heads)
        return False


# ----------------------------------------------------------------------
# full train state (resume)
# ----------------------------------------------------------------------
_STATE_FILE = "train_state.pt"
_STATE_CLASSES = (AdamState, FactoredState, ShampooState, ShampooParamState)


def _map_tensors(x, fn):
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: _map_tensors(v, fn) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_map_tensors(v, fn) for v in x))
    return x


def save_train_state(path: str, state: TrainState, mesh=None) -> None:
    """``path/train_state.pt``: params, optimizer state, step and seed (host
    copies).  Under ``mesh`` every rank calls it: the sliced parameters are
    gathered whole over ``model``, and rank 0 writes."""
    params = {k: p.detach() for k, p in state.params.items()}
    sliced = [k for k, p in state.params.items() if hasattr(p, "tp_shard")]
    if sliced:
        whole = sharding.gather_whole([(state.params[k], params[k]) for k in sliced], mesh)
        for k, w in zip(sliced, whole):
            params[k] = state.params[k].tp_shard.layout.from_flax(w)
    if not is_primary_host():
        return
    os.makedirs(path, exist_ok=True)
    torch.save({
        "params": {k: p.cpu() for k, p in params.items()},
        "opt_state": _map_tensors(state.opt_state, lambda t: t.detach().cpu()),
        "step": int(state.step),
        "seed": int(state.seed),
    }, os.path.join(path, _STATE_FILE))


def restore_train_state(path: str, template: TrainState, mesh=None) -> TrainState:
    """Load a saved train state into ``template``'s parameters (in place)
    and onto their device; a sliced parameter (after ``place_state`` under
    ``mesh``) takes its slice of the saved whole one."""
    torch.serialization.add_safe_globals(list(_STATE_CLASSES))
    saved = torch.load(os.path.join(path, _STATE_FILE), weights_only=True)
    if set(saved["params"]) != set(template.params):
        raise ValueError("the saved train state's parameters are not the template's")
    device = next(iter(template.params.values())).device if template.params else torch.device("cpu")
    with torch.no_grad():
        for k, p in template.params.items():
            value = saved["params"][k]
            if hasattr(p, "tp_shard"):
                value = sharding.local_slice(p.tp_shard.layout.to_flax(value), p, mesh)
            p.copy_(value)
    return TrainState(template.params, _map_tensors(saved["opt_state"], lambda t: t.to(device)),
                      saved["step"], saved["seed"])
