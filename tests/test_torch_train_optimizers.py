"""The dense train step after 3 Adafactor and 3 Shampoo steps at their
defaults, against the JAX package's, at hidden 128 so that the FFN kernels
and the word embedding are factored (their two largest dims are ≥ 128),
on the real model's parameter layout through ``convert.flax_layouts``
(the AdamW steps and the rest of the set-up are in ``test_torch_train.py``).

Tolerances: Adafactor 1e-6 absolute (5.8e-7 measured), except the
attention's qkv bias: its key third has a gradient of f32 noise (a key bias
adds a constant to each query's logits, which the softmax cancels), which
Adafactor's RMS scaling turns into steps of the lr in either package, so
the key third is not compared and the query and value thirds, whose
block-RMS clip shares that noise, are held to 5e-5 (2.6e-5 measured).
Shampoo at its default ``matrix_eps`` 1e-6: losses rtol 1e-4 and params
1.5e-4 absolute (7.3e-5 measured on steps of ~1e-2): the statistics of the
bias and LayerNorm vectors and of the zero-padded edge blocks are
rank-deficient, and each package's f32 ``eigh`` returns their null
eigenvalues as its own noise.  (``test_torch_losses_optim.py`` holds
Shampoo at that eps on full-rank blocks at 5e-6.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_train import BIENCODER_CASES, FIT, _check_three_steps
from torch_train_parity import flat, jax_batch, models, triplet_batch

from fusion_tpu.train import trainer as jt
from fusion_tpu_torch.train import trainer as tt

WIDE = dict(hidden_size=128, intermediate_size=256, num_heads=2)  # [256, 128] and [128, 256] leaves
OPTIMIZER_CASES = {
    "Adafactor": dict(param_atol=1e-6, qkv_bias_atol=5e-5),
    "Shampoo": dict(loss_rtol=1e-4, param_atol=1.5e-4),
}


@pytest.mark.parametrize("optimizer", sorted(OPTIMIZER_CASES))
def test_biencoder_three_steps_of_each_optimizer(optimizer):
    jm, tm = models("biencoder", "dense", **WIDE)
    rank = BIENCODER_CASES["dense_mnrl"][1]
    batch = triplet_batch()
    if optimizer == "Adafactor":  # the key bias's gradient is noise, the query bias's is not
        loss = lambda p: jt.biencoder_loss(jm, p, jax_batch(batch), jnp.asarray(0), rank, None, 10)[0]  # noqa: E731
        g = jax.jit(jax.grad(loss))(jm.params)
        qkv_b = np.asarray(flat(g)[("layer_0", "attention", "qkv", "bias")])
        assert np.linalg.norm(qkv_b[1]) < 1e-5 * np.linalg.norm(qkv_b[0])
    _check_three_steps(jm, tm, lambda tx: jt.make_biencoder_train_step(jm, tx, rank, None, 10),
                       lambda tx: tt.make_biencoder_train_step(tm, tx, rank, None, 10), batch,
                       fit=dict(FIT, optimizer_name=optimizer), **OPTIMIZER_CASES[optimizer])
