"""fusion_tpu_torch's losses, schedules and optimizers against the JAX
package's (``fusion_tpu.train``), on the same seeded numpy inputs.

Tolerances (f32 both sides): losses rtol 1e-6 / atol 1e-6; schedules
rtol 1e-6 (f32 arithmetic, one ulp apart where XLA's cos differs from
numpy's); AdamW and Adafactor params after 5 updates rtol 1e-6 /
atol 1e-7; Shampoo rtol 1e-4 / atol 1e-6 at ``matrix_eps`` 1e-2.  (At
the default 1e-6 the statistics of a padded edge block or a vector leaf
are rank-deficient, and an f32 ``eigh`` returns their null eigenvalues as
noise of ~1e-7 of the largest, which the inverse 4th root amplifies: the
two packages then differ by ~10 % on those leaves, each by its own
library's noise.)  Shampoo at the default 1e-6 on leaves of whole square
blocks, preconditioned from the second update on, when their statistics
are full rank and well conditioned: 5e-6 absolute on steps of ~0.2 (7.2e-7
measured)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fusion_tpu.train import losses as jl
from fusion_tpu.train.optim import _no_decay_mask
from fusion_tpu.train.optim import get_optimizer as jax_get_optimizer
from fusion_tpu.train.schedules import get_schedule as jax_get_schedule
from fusion_tpu_torch.train import losses as tl
from fusion_tpu_torch.train.optim import apply_updates, get_optimizer, merge_small_dims, no_decay_mask
from fusion_tpu_torch.train.schedules import get_schedule

RTOL, ATOL = 1e-6, 1e-6


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture
def scores(rng):
    b, n = 6, 3
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return f(b), f(b, n), f(b), f(b, n)


def test_info_nce(scores):
    pos, neg, _, _ = scores
    for temp in (1.0, 0.05):
        want = float(jl.info_nce(jnp.asarray(pos), jnp.asarray(neg), temperature=temp))
        np.testing.assert_allclose(float(tl.info_nce(_t(pos), _t(neg), temperature=temp)), want, RTOL, ATOL)


@pytest.mark.parametrize("name", ["margin_mse", "kld"])
def test_distillation_losses(scores, name):
    args = [jnp.asarray(x) for x in scores]
    for scale in (1.0, 0.08):
        want = float(getattr(jl, name)(*args, teacher_scale=scale))
        got = float(getattr(tl, name)(*[_t(x) for x in scores], teacher_scale=scale))
        np.testing.assert_allclose(got, want, RTOL, ATOL)


@pytest.mark.parametrize("similarity", ["cos_sim", "dot_score"])
def test_mnrl(rng, similarity):
    q = rng.normal(size=(5, 16)).astype(np.float32)
    d = rng.normal(size=(9, 16)).astype(np.float32)
    want = float(jl.mnrl(jnp.asarray(q), jnp.asarray(d), scale=20.0, similarity=similarity))
    np.testing.assert_allclose(float(tl.mnrl(_t(q), _t(d), scale=20.0, similarity=similarity)), want, RTOL, ATOL)


def test_bce_logits(rng):
    logits = rng.normal(size=(11,)).astype(np.float32) * 4
    labels = (rng.random(11) > 0.5).astype(np.float32)
    want = float(jl.bce_logits(jnp.asarray(logits), jnp.asarray(labels)))
    np.testing.assert_allclose(float(tl.bce_logits(_t(logits), _t(labels))), want, RTOL, ATOL)


@pytest.mark.parametrize("name", ["FlopsLoss", "L1Loss", "L0Loss"])
def test_regularizers(rng, name):
    reps = np.maximum(rng.normal(size=(6, 40)), 0).astype(np.float32)
    for step, target in ((0, None), (3, 30), (29, 30), (31, 30), (100, 30)):
        want = float(jl.regularizer(name, jnp.asarray(reps), 3e-4, step=step, target_step=target))
        got = float(tl.regularizer(name, _t(reps), 3e-4, step=step, target_step=target))
        np.testing.assert_allclose(got, want, RTOL, 1e-12)
    # the weight also reads a tensor step
    for step in (0, 5, 40):
        want = float(jl.flops_weight(3e-4, jnp.asarray(step), 30))
        np.testing.assert_allclose(float(tl.flops_weight(3e-4, torch.tensor(step), 30)), want, RTOL, 0)


@pytest.mark.parametrize("name", ["linear", "cosine", "constant", "constant_with_warmup"])
@pytest.mark.parametrize("total,ratio", [(50, 0.04), (7, 0.3), (120, 0.1)])
def test_schedules_every_step(name, total, ratio):
    js, ts = jax_get_schedule(name, 3e-5, total, ratio), get_schedule(name, 3e-5, total, ratio)
    want = np.array([float(js(jnp.asarray(i, jnp.int32))) for i in range(total + 3)])
    got = np.array([ts(i) for i in range(total + 3)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-13)


def _param_tree(rng):
    """Flat {path: array}: a 160 x 130 kernel (Adafactor factors it), a
    3-D kernel, a LayerNorm pair and a bias; Shampoo at block 64 pads the
    kernel's edge blocks."""
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {
        ("layer_0", "ffn_in", "kernel"): f(160, 130),
        ("layer_0", "ffn_in", "bias"): f(130),
        ("layer_0", "attention", "out", "kernel"): f(4, 8, 40),
        ("layer_0", "attn_ln", "scale"): f(40),
        ("embeddings", "ln", "bias"): f(40),
    }


def _nest(flat):
    out = {}
    for path, v in flat.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


def _flatten(tree):
    return {tuple(str(getattr(p, "key", p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("clip", [1e9, 0.5], ids=["clip_not_triggered", "clip_triggered"])
@pytest.mark.parametrize("name,kw,tol", [
    ("adamw", {}, (1e-6, 1e-7)),
    ("adafactor", {}, (1e-6, 1e-7)),
    ("shampoo", {"block_size": 64, "precondition_every": 2, "matrix_eps": 1e-2}, (1e-4, 1e-6)),
])
def test_optimizer_chains_match_optax(rng, name, kw, tol, clip):
    params = _param_tree(rng)
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) * 0.3 for k, v in params.items()} for _ in range(5)]
    schedule = jax_get_schedule("linear", 1e-2, 20, 0.1)
    jparams = jax.tree_util.tree_map(jnp.asarray, _nest(params))
    jtx = jax_get_optimizer(name, schedule, weight_decay=0.01, max_grad_norm=clip,
                            params=jparams if name == "adamw" else None, **kw)
    jstate = jtx.init(jparams)
    mask = no_decay_mask(params)
    assert mask == {k: bool(v) for k, v in _flatten(_no_decay_mask(_nest(params))).items()}
    tx = get_optimizer(name, get_schedule("linear", 1e-2, 20, 0.1), weight_decay=0.01, max_grad_norm=clip,
                       mask=mask if name == "adamw" else None, **kw)
    tparams = {k: _t(v.copy()) for k, v in params.items()}
    tstate = tx.init(tparams)
    for g in grads:
        updates, jstate = jtx.update(jax.tree_util.tree_map(jnp.asarray, _nest(g)), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tupdates, tstate = tx.update({k: _t(v) for k, v in g.items()}, tstate, tparams)
        apply_updates(tparams, tupdates)
    want = _flatten(jparams)
    moved = 0
    for k, v in tparams.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=tol[0], atol=tol[1], err_msg=str(k))
        moved += not np.array_equal(want[k], params[k])
    assert moved == len(params)


@pytest.mark.parametrize("clip", [1e9, 0.5], ids=["clip_not_triggered", "clip_triggered"])
def test_shampoo_at_the_default_eps_on_full_rank_blocks(rng, clip):
    """Shampoo at its default matrix_eps 1e-6, over leaves that fill whole
    square blocks (one, four, and a merged [8, 8, 64] → [64, 64]), with
    preconditioning from the second update: the Gram matrix of one square
    Gaussian block is full rank but its condition number has no bound, and
    from two updates on the statistics are well conditioned."""
    params = {("a",): rng.normal(size=(64, 64)).astype(np.float32),
              ("b",): rng.normal(size=(128, 128)).astype(np.float32),
              ("c",): rng.normal(size=(8, 8, 64)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) * 0.3 for k, v in params.items()} for _ in range(5)]
    kw = dict(block_size=64, precondition_every=2, start_preconditioning_step=2)
    jparams = jax.tree_util.tree_map(jnp.asarray, _nest(params))
    jtx = jax_get_optimizer("shampoo", jax_get_schedule("linear", 1e-2, 20, 0.1), weight_decay=0.01,
                            max_grad_norm=clip, **kw)
    jstate = jtx.init(jparams)
    tx = get_optimizer("shampoo", get_schedule("linear", 1e-2, 20, 0.1), weight_decay=0.01, max_grad_norm=clip, **kw)
    tparams = {k: _t(v.copy()) for k, v in params.items()}
    tstate = tx.init(tparams)
    for g in grads:
        updates, jstate = jtx.update(jax.tree_util.tree_map(jnp.asarray, _nest(g)), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tupdates, tstate = tx.update({k: _t(v) for k, v in g.items()}, tstate, tparams)
        apply_updates(tparams, tupdates)
    want = _flatten(jparams)
    for k, v in tparams.items():
        assert np.abs(want[k] - params[k]).max() > 0.1  # steps of ~0.2
        np.testing.assert_allclose(v.numpy(), want[k], rtol=0, atol=5e-6, err_msg=str(k))


def test_no_decay_mask_paths():
    paths = [("encoder", "layer_0", "attn_ln", "scale"), ("encoder", "layer_0", "ffn_in", "kernel"),
             ("encoder", "layer_0", "ffn_in", "bias"), ("mlm", "LayerNorm", "kernel"),
             ("encoder", "embeddings", "word", "embedding"), ("x", "final_norm", "kernel")]
    got = no_decay_mask(paths)
    assert [got[p] for p in paths] == [False, True, False, False, True, False]


def test_merge_small_dims():
    assert merge_small_dims((8, 8, 64), 128) == (64, 64)
    assert merge_small_dims((1, 768), 128) == (768,)
    assert merge_small_dims((768, 3, 12, 64), 128) == (768, 36, 64)
