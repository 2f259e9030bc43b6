"""Optimizers: AdamW, Adafactor and blocked Shampoo, with optax's update
rules, as ``fusion_tpu/train/optim.py`` builds them.

Each optimizer is a ``Transform``: ``init(params) → state`` and
``update(grads, state, params) → (updates, state)`` over dicts of f32
tensors keyed by the parameters' JAX paths (tuples of keys; the trainer
gives each parameter in the JAX package's layout, ``models/convert.py``'s
``flax_layouts``), and ``apply_updates`` adds the updates.  The layout
matters where a rule reads a shape: Adafactor factors a leaf's two largest
dims, Shampoo views it as a matrix after merging small dims.

  * ``adamw``: optax.adamw (b1 0.9, b2 0.999, eps 1e-7), decoupled decay
    masked by ``no_decay_mask`` (no decay for biases, LayerNorm params or any
    key with "norm"); the learning rate is ``schedule(count)``, ``count``
    starting at 0, so a linear warmup's first step has lr 0;
  * ``adafactor``: optax.adafactor(multiply_by_parameter_scale=False,
    clipping_threshold=1.0): factored RMS scaling (decay 0.8, eps 1e-30,
    factored when the second-largest dim is >= 128), block-RMS clip at 1,
    the learning rate, then the decayed weights added unscaled by it;
  * ``shampoo``: the JAX package's blocked Shampoo: each leaf a matrix in
    ``block_size`` tiles zero-padded at the edges, batched ``eigh`` inverse
    4th roots refreshed every ``precondition_every`` steps, AdaGrad or SGD
    grafting, Nesterov momentum;
  * ``get_optimizer``: optax's ``clip_by_global_norm`` first (``g`` if
    ``‖g‖ < max`` else ``g / ‖g‖ · max``; not ``clip_grad_norm_``, which adds
    1e-6 to the norm), then the optimizer.

The state lives in f32 tensors on the parameters' device.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, NamedTuple

import numpy as np
import torch

Tree = dict  # JAX path (tuple of str) → tensor


class Transform(NamedTuple):
    init: Callable[[Tree], Any]
    update: Callable[[Tree, Any, Tree], tuple[Tree, Any]]


def _lr_fn(learning_rate) -> Callable[[int], float]:
    return learning_rate if callable(learning_rate) else (lambda _: learning_rate)


def _f32(x: float) -> float:
    return float(np.float32(x))


def apply_updates(params: Mapping[Any, torch.Tensor], updates: Tree) -> None:
    """``params[k] += updates[k]`` in place, for every key of ``updates``."""
    with torch.no_grad():
        for k, u in updates.items():
            params[k].add_(u.to(params[k].dtype))


# ----------------------------------------------------------------------
# parameter grouping
# ----------------------------------------------------------------------
def no_decay_mask(paths) -> dict:
    """JAX path → True where weight decay applies: not on biases, LayerNorm
    params or any key containing "norm"."""

    def flag(keys):
        is_norm = any(k == "ln" or "LayerNorm" in k or "norm" in k.lower() for k in keys)
        is_bias = bool(keys) and keys[-1] in ("bias", "scale")
        return not (is_norm or is_bias)

    return {p: flag([str(k) for k in p]) for p in paths}


# ----------------------------------------------------------------------
# AdamW
# ----------------------------------------------------------------------
class AdamState(NamedTuple):
    count: int
    mu: Tree
    nu: Tree


def adamw(learning_rate, weight_decay: float = 0.01, eps: float = 1e-7, b1: float = 0.9, b2: float = 0.999,
          mask: Mapping | None = None) -> Transform:
    lr_fn = _lr_fn(learning_rate)

    def init(params):
        zeros = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        return AdamState(0, zeros, {k: z.clone() for k, z in zeros.items()})

    def update(grads, state, params):
        count_inc = state.count + 1
        c1 = 1.0 - np.float32(b1) ** np.float32(count_inc)
        c2 = 1.0 - np.float32(b2) ** np.float32(count_inc)
        lr = lr_fn(state.count)
        mu, nu, out = {}, {}, {}
        for k, g in grads.items():
            g = g.float()
            mu[k] = (1 - b1) * g + b1 * state.mu[k]
            nu[k] = (1 - b2) * (g * g) + b2 * state.nu[k]
            u = (mu[k] / float(c1)) / (torch.sqrt(nu[k] / float(c2)) + eps)
            if weight_decay and (mask is None or mask[k]):
                u = u + weight_decay * params[k].float()
            out[k] = -_f32(lr) * u
        return out, AdamState(count_inc, mu, nu)

    return Transform(init, update)


# ----------------------------------------------------------------------
# Adafactor
# ----------------------------------------------------------------------
class FactoredState(NamedTuple):
    count: int
    v_row: Tree
    v_col: Tree
    v: Tree


def _factored_dims(shape, min_dim_size_to_factor: int = 128):
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


def adafactor(learning_rate, weight_decay: float = 0.0, decay_rate: float = 0.8, eps: float = 1e-30,
              clipping_threshold: float = 1.0) -> Transform:
    lr_fn = _lr_fn(learning_rate)

    def init(params):
        v_row, v_col, v = {}, {}, {}
        for k, p in params.items():
            dims = _factored_dims(tuple(p.shape))
            z = lambda shape: torch.zeros(shape, dtype=torch.float32, device=p.device)  # noqa: E731
            if dims is not None:
                d1, d0 = dims
                v_row[k] = z(tuple(np.delete(p.shape, d0)))
                v_col[k] = z(tuple(np.delete(p.shape, d1)))
                v[k] = z((1,))
            else:
                v_row[k], v_col[k], v[k] = z((1,)), z((1,)), z(tuple(p.shape))
        return FactoredState(0, v_row, v_col, v)

    def update(grads, state, params):
        t = np.float32(state.count + 1)
        decay_t = float(np.float32(1.0) - t ** np.float32(-decay_rate))
        lr = _f32(lr_fn(state.count))
        v_row, v_col, v, out = dict(state.v_row), dict(state.v_col), dict(state.v), {}
        for k, g in grads.items():
            g = g.float()
            grad_sqr = g * g + eps
            dims = _factored_dims(tuple(g.shape))
            if dims is not None:
                d1, d0 = dims
                v_row[k] = decay_t * state.v_row[k] + (1.0 - decay_t) * grad_sqr.mean(dim=d0)
                v_col[k] = decay_t * state.v_col[k] + (1.0 - decay_t) * grad_sqr.mean(dim=d1)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = v_row[k].mean(dim=reduced_d1, keepdim=True)
                row_factor = (v_row[k] / row_col_mean) ** -0.5
                col_factor = v_col[k] ** -0.5
                u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            else:
                v[k] = decay_t * state.v[k] + (1.0 - decay_t) * grad_sqr
                u = g * v[k] ** -0.5
            u = u / torch.clamp(torch.sqrt((u * u).mean()) / clipping_threshold, min=1.0)
            u = lr * u
            if weight_decay:
                u = u + weight_decay * params[k].float()
            out[k] = -u
        return out, FactoredState(state.count + 1, v_row, v_col, v)

    return Transform(init, update)


# ----------------------------------------------------------------------
# blocked Shampoo
# ----------------------------------------------------------------------
class ShampooParamState(NamedTuple):
    stats_l: torch.Tensor  # [nb, bs, bs] left Gram statistics
    stats_r: torch.Tensor  # [nb, bs, bs] right Gram statistics
    root_l: torch.Tensor  # [nb, bs, bs] L^{-1/4}
    root_r: torch.Tensor  # [nb, bs, bs] R^{-1/4}
    adagrad: torch.Tensor  # diagonal grafting accumulator, the leaf's shape
    momentum: torch.Tensor  # the leaf's shape


class ShampooState(NamedTuple):
    count: int
    per_param: dict


def merge_small_dims(shape: tuple[int, ...], max_dim: int) -> tuple[int, ...]:
    """Greedily merge adjacent dims whose running product stays ≤ max_dim:
    (8, 8, 64) with max 128 → (64, 64); (1, 768) → (768,)."""
    dims = [d for d in shape if d != 1]
    if not dims:
        return (1,)
    merged = [dims[0]]
    for d in dims[1:]:
        if merged[-1] * d <= max_dim:
            merged[-1] *= d
        else:
            merged.append(d)
    return tuple(merged)


def _as_matrix(x: torch.Tensor, max_dim: int) -> torch.Tensor:
    """A leaf as a matrix after small-dim merging: vectors become [1, n],
    rank > 2 collapses the trailing dims."""
    xr = x.reshape(merge_small_dims(tuple(x.shape), max_dim))
    if xr.ndim <= 1:
        return xr.reshape(1, -1)
    return xr.reshape(xr.shape[0], -1)


def _padded(r: int, c: int, bs: int) -> tuple[int, int]:
    return r + (-r) % bs, c + (-c) % bs


def _to_blocks(m: torch.Tensor, bs: int) -> torch.Tensor:
    """[R, C] zero-padded to multiples of bs → [nb, bs, bs] stacked tiles."""
    r, c = m.shape
    rp, cp = _padded(r, c, bs)
    m = torch.nn.functional.pad(m, (0, cp - c, 0, rp - r))
    return m.reshape(rp // bs, bs, cp // bs, bs).permute(0, 2, 1, 3).reshape(-1, bs, bs)


def _from_blocks(blocks: torch.Tensor, r: int, c: int, bs: int) -> torch.Tensor:
    rp, cp = _padded(r, c, bs)
    return blocks.reshape(rp // bs, cp // bs, bs, bs).permute(0, 2, 1, 3).reshape(rp, cp)[:r, :c]


def _inv_pth_root(mats: torch.Tensor, p: int, eps: float) -> torch.Tensor:
    """Batched symmetric inverse p-th root via eigh: M^{-1/p}."""
    eye = torch.eye(mats.shape[-1], dtype=mats.dtype, device=mats.device)
    w, v = torch.linalg.eigh(mats + eps * eye)
    w = torch.clamp(w, min=eps)
    return (v * (w ** (-1.0 / p))[:, None, :]) @ v.transpose(-1, -2)


def shampoo(
    learning_rate,
    block_size: int = 128,
    beta1: float = 0.9,
    beta2: float = 1.0,
    matrix_eps: float = 1e-6,
    diagonal_eps: float = 1e-10,
    weight_decay: float = 0.0,
    precondition_every: int = 10,
    start_preconditioning_step: int = 1,
    nesterov: bool = True,
    graft_type: str = "adagrad",
) -> Transform:
    """Blocked Shampoo with grafting; ``beta2=1.0`` accumulates raw
    statistics, < 1 an EMA.  The learning rate is ``schedule(count)`` with
    ``count`` the 1-based step, as in the JAX package."""
    if graft_type not in ("adagrad", "sgd"):
        raise ValueError(f"unknown graft_type {graft_type!r}")
    lr_fn = _lr_fn(learning_rate)
    bs = block_size

    def init(params):
        per = {}
        for k, x in params.items():
            r, c = _as_matrix(x, bs).shape
            rp, cp = _padded(r, c, bs)
            nb = (rp // bs) * (cp // bs)
            zeros = torch.zeros((nb, bs, bs), dtype=torch.float32, device=x.device)
            root = torch.eye(bs, dtype=torch.float32, device=x.device).expand(nb, bs, bs).clone()
            per[k] = ShampooParamState(zeros, zeros.clone(), root, root.clone(),
                                       torch.zeros_like(x, dtype=torch.float32),
                                       torch.zeros_like(x, dtype=torch.float32))
        return ShampooState(0, per)

    def update(grads, state, params):
        count = state.count + 1
        refresh = count % precondition_every == 0 or count == start_preconditioning_step
        lr = _f32(lr_fn(count))
        out, per = {}, {}
        for k, g in grads.items():
            s = state.per_param[k]
            g32 = g.float()
            m = _as_matrix(g32, bs)
            gb = _to_blocks(m, bs)
            new_l = beta2 * s.stats_l + torch.einsum("nab,ncb->nac", gb, gb)
            new_r = beta2 * s.stats_r + torch.einsum("nab,nac->nbc", gb, gb)
            if refresh:
                root_l, root_r = _inv_pth_root(new_l, 4, matrix_eps), _inv_pth_root(new_r, 4, matrix_eps)
            else:
                root_l, root_r = s.root_l, s.root_r
            pre = torch.einsum("nab,nbc,ncd->nad", root_l, gb, root_r)
            pre_m = _from_blocks(pre, *m.shape, bs).reshape(g.shape)
            new_acc = s.adagrad + g32 * g32
            graft = g32 / (torch.sqrt(new_acc) + diagonal_eps) if graft_type == "adagrad" else g32
            if count >= start_preconditioning_step:
                direction = pre_m * (torch.linalg.vector_norm(graft)
                                     / torch.clamp(torch.linalg.vector_norm(pre_m), min=1e-30))
            else:
                direction = graft
            if weight_decay:
                direction = direction + weight_decay * params[k].float()
            mom = beta1 * s.momentum + direction
            step_dir = beta1 * mom + direction if nesterov else mom
            per[k] = ShampooParamState(new_l, new_r, root_l, root_r, new_acc, mom)
            out[k] = -lr * step_dir
        return out, ShampooState(count, per)

    return Transform(init, update)


# ----------------------------------------------------------------------
# the update chain
# ----------------------------------------------------------------------
def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum((g.float() * g.float()).sum() for g in tree.values()))


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tree:
    """optax's form: ``g`` if ``‖g‖ < max_norm``, else ``g / ‖g‖ · max_norm``."""
    if not grads:
        return grads
    norm = global_norm(grads)
    keep = norm < max_norm
    return {k: torch.where(keep, g, (g / norm) * max_norm) for k, g in grads.items()}


def get_optimizer(
    name: str,
    learning_rate,
    weight_decay: float = 0.01,
    max_grad_norm: float | None = 1.0,
    mask: Mapping | None = None,
    **kw,
) -> Transform:
    """The update chain by the reference CLI's names: clip by global norm,
    then AdamW (with the decay ``mask``), Adafactor or Shampoo."""
    name_l = name.lower()
    if name_l == "adamw":
        tx = adamw(learning_rate, weight_decay=weight_decay, mask=mask, **kw)
    elif name_l == "adafactor":
        tx = adafactor(learning_rate, weight_decay=weight_decay)
    elif name_l == "shampoo":
        tx = shampoo(learning_rate, weight_decay=weight_decay, **kw)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    if not max_grad_norm:
        return tx

    def update(grads, state, params):
        return tx.update(clip_by_global_norm(grads, max_grad_norm), state, params)

    return Transform(tx.init, update)
