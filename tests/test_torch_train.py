"""The port's train steps (``fusion_tpu_torch.train.trainer``) against the
JAX package's, at ``EncoderConfig.tiny(vocab_size=256)`` in f32 with dropout
0, on weights converted from the JAX params and batches made from a seed
with numpy: the loss and its metrics dict, every gradient leaf (read
through the trainer's own ``convert.flax_layouts``), and the params after
3 AdamW steps under linear warmup (lr 0, lr/3, 2lr/3).  (Adafactor and
Shampoo are in ``test_torch_train_optimizers.py``; the decay mask, the
freeze, dropout, remat and ``fit`` in ``test_torch_train_fit.py``.)

Tolerances: losses and metrics rtol 1e-5; each gradient leaf within 1e-4
of its JAX norm (‖Δ‖ / ‖g‖; ~1e-6 is what f32 sums in another order
give); params after 3 AdamW steps within 5e-5 absolute, 5 % of one step
at lr 1e-3 (Adam divides each element by its own gradient's magnitude, so
an element whose gradient is near eps 1e-7 moves by another fraction of
the lr when its f32 gradient differs in the last digits)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_train_parity import B, LD, N, flat, jax_batch, models, pair_batch, triplet_batch

from fusion_tpu.train import trainer as jt
from fusion_tpu_torch.train import trainer as tt

LOSS_RTOL, GRAD_TOL, PARAM_ATOL = 1e-5, 1e-4, 5e-5
FLOPS = {"query_reg": "FlopsLoss", "query_reg_weight": 3e-4, "doc_reg": "FlopsLoss", "doc_reg_weight": 1e-4}
BIENCODER_CASES = {
    "dense_mnrl": ("dense", {"name": "MNRLoss", "scale": 20.0}, None),
    "splade_infonce_ib_flops": ("splade", {"name": "InfoNCELoss", "use_ib_negs": True, "temperature": 0.05}, FLOPS),
    "dense_margin_mse": ("dense", {"name": "MarginMSELoss", "teacher_scale": 0.5}, None),
    "splade_kld_l1": ("splade", {"name": "KLDLoss"},
                      {"query_reg": "L1Loss", "query_reg_weight": 1e-2, "doc_reg": "FlopsLoss", "doc_reg_weight": 1e-4}),
}
FIT = dict(steps=10, learning_rate=1e-3, warmup_ratio=0.3)


def _port_grads(model):
    layouts = tt._layouts(model)
    return {layouts[n].path: layouts[n].to_flax(p.grad).numpy() for n, p in model.module.named_parameters()}


def _assert_grads(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        err = np.linalg.norm(got[k] - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= GRAD_TOL, (k, err)


def _check_loss_and_grads(jm, tm, jax_loss, port_loss):
    (jl, jmetrics), jg = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(jm.params)
    tl, tmetrics = port_loss()
    tl.backward()
    assert set(tmetrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(tmetrics[k].detach()), float(jmetrics[k]), rtol=LOSS_RTOL, err_msg=k)
    _assert_grads(_port_grads(tm), flat(jg))


def _check_three_steps(jm, tm, jax_step_factory, port_step_factory, batch, fit=FIT, loss_rtol=LOSS_RTOL,
                       param_atol=PARAM_ATOL, qkv_bias_atol=None):
    """With ``qkv_bias_atol`` the qkv biases' key third is left out and the
    query and value thirds are held to it."""
    p0 = flat(jm.params)
    jstate, jtx, _ = jt.init_train_state(jm, jt.FitConfig(**fit))
    # The JAX Shampoo state holds one buffer as both root_l and root_r, which
    # its jitted step's buffer donation refuses: give each leaf its own.
    jstate = jstate._replace(opt_state=jax.tree_util.tree_map(jnp.copy, jstate.opt_state))
    tstate, ttx, _ = tt.init_train_state(tm, tt.FitConfig(**fit))
    jstep, tstep = jax_step_factory(jtx), port_step_factory(ttx)
    jb, tb = jax_batch(batch), tt._to_device(batch, tm.device)
    for _ in range(3):
        jstate, jmet = jstep(jstate, jb)
        tstate, tmet = tstep(tstate, tb)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=loss_rtol)
    assert tstate.step == 3
    want, got = flat(jstate.params), flat(tm.flax_tree(tm.module.state_dict()))
    for k, w in want.items():
        if qkv_bias_atol is not None and k[-3:] == ("attention", "qkv", "bias"):
            np.testing.assert_allclose(got[k][[0, 2]], w[[0, 2]], rtol=0, atol=qkv_bias_atol, err_msg=str(k))
        else:
            np.testing.assert_allclose(got[k], w, rtol=0, atol=param_atol, err_msg=str(k))
    assert sum(not np.array_equal(want[k], p0[k]) for k in want) == len(want)


@pytest.mark.parametrize("case", sorted(BIENCODER_CASES))
def test_biencoder_loss_and_grads(case):
    head, rank, reg = BIENCODER_CASES[case]
    jm, tm = models("biencoder", head)
    batch = triplet_batch()
    step = 4  # inside the FLOPS ramp (target int(30 / 3) = 10)
    _check_loss_and_grads(
        jm, tm,
        lambda p: jt.biencoder_loss(jm, p, jax_batch(batch), jnp.asarray(step), rank, reg, 30),
        lambda: tt.biencoder_loss(tm, tt._to_device(batch, tm.device), step, rank, reg, 30),
    )


@pytest.mark.parametrize("case", sorted(BIENCODER_CASES))
def test_biencoder_three_adamw_steps(case):
    head, rank, reg = BIENCODER_CASES[case]
    jm, tm = models("biencoder", head)
    _check_three_steps(jm, tm, lambda tx: jt.make_biencoder_train_step(jm, tx, rank, reg, 10),
                       lambda tx: tt.make_biencoder_train_step(tm, tx, rank, reg, 10), triplet_batch())


@pytest.mark.parametrize("loss_name", ["ce", "kld"])
def test_colbert_loss_and_grads(loss_name):
    jm, tm = models("colbert")
    batch = triplet_batch(float_masks=True)

    def jax_loss(params):
        # the JAX step's loss body (fusion_tpu/train/trainer.py make_colbert_train_step)
        b = jax_batch(batch)
        q = jm.embed_tokens(params, b["query_ids"], b["query_mask"], train=True)
        p = jm.embed_tokens(params, b["pos_ids"], b["pos_mask"], train=True)
        n = jm.embed_tokens(params, b["neg_ids"], b["neg_mask"], train=True)
        pos = jm.pairwise_maxsim(q, b["query_mask"], p, b["pos_mask"])
        neg = jm.nway_maxsim(q, b["query_mask"], n.reshape(B, N, LD, -1), b["neg_mask"].reshape(B, N, LD))
        from fusion_tpu.train import losses

        loss = (losses.kld(pos, neg, b["teacher_pos"], b["teacher_neg"].reshape(B, N)) if loss_name == "kld"
                else losses.info_nce(pos, neg))
        return loss, {"loss": loss}

    _check_loss_and_grads(jm, tm, jax_loss,
                          lambda: tt.colbert_loss(tm, tt._to_device(batch, tm.device), 0, loss_name))


@pytest.mark.parametrize("loss_name", ["ce", "kld"])
def test_colbert_three_adamw_steps(loss_name):
    jm, tm = models("colbert")
    _check_three_steps(jm, tm, lambda tx: jt.make_colbert_train_step(jm, tx, loss_name=loss_name),
                       lambda tx: tt.make_colbert_train_step(tm, tx, loss_name=loss_name),
                       triplet_batch(float_masks=True))


def test_crossencoder_loss_and_grads():
    jm, tm = models("crossencoder")
    batch = pair_batch()

    def jax_loss(params):
        from fusion_tpu.train import losses

        b = jax_batch(batch)
        loss = losses.bce_logits(jm.score_tokens(params, b["pair_ids"], b["pair_mask"], train=True), b["labels"])
        return loss, {"loss": loss}

    _check_loss_and_grads(jm, tm, jax_loss, lambda: tt.crossencoder_loss(tm, tt._to_device(batch, tm.device), 0))


def test_crossencoder_three_adamw_steps():
    jm, tm = models("crossencoder")
    _check_three_steps(jm, tm, lambda tx: jt.make_crossencoder_train_step(jm, tx),
                       lambda tx: tt.make_crossencoder_train_step(tm, tx), pair_batch())
