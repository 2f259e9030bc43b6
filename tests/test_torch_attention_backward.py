"""The backward of the ``flash`` form (``ops/attention.py``): the plain
backward and ``MaskedAttention``'s CPU path against ``torch.autograd`` of
the plain forward and against ``jax.vjp`` / ``jax.grad`` of the JAX
package's ``flash`` form, which on the CPU computes its ``einsum``
arithmetic (its Pallas kernels need a TPU).  Inputs come from numpy seeds:
plain and packed rows, ragged lengths and an all-pad row.

Tolerances:

  * f32: atol 1e-5.  The plain backward forms ``D = rowsum(dO∘O)`` where
    autograd forms ``rowsum(dP∘P)``; the two agree up to f32 rounding;
  * bf16 against autograd: atol 3e-2 on gradients of magnitude below 4.
    Both round ``P`` to bf16 for ``dV``; autograd also rounds ``dP`` (a
    bf16 product's output) and its ``dS`` stays f32 where the plain
    backward keeps ``dP`` in f32 and rounds ``dS`` to bf16, a relative
    2^-8 on each of them.

The kernels themselves run only on the card (``cuda`` marker)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import DEVICE
from torch_train_parity import flat, models, triplet_batch

from fusion_tpu.models.encoder import Encoder as JaxEncoder
from fusion_tpu.models.encoder import EncoderConfig as JaxConfig
from fusion_tpu.models.encoder import SelfAttention as JaxSelfAttention
from fusion_tpu.train import trainer as jt
from fusion_tpu_torch.models import convert
from fusion_tpu_torch.models.encoder import Encoder, EncoderConfig, SelfAttention, place, token_tensors
from fusion_tpu_torch.ops import attention as att
from fusion_tpu_torch.train import trainer as tt

F32_TOL, BF16_TOL = 1e-5, 3e-2


def _case(seed, b=3, length=37, heads=2, hd=16, packed=False):
    """Fused qkv [b, length, 3, heads, hd], the output's gradient, a key mask
    (a full row, a ragged one, an all-pad one) and, packed, segments: two
    pairs and a padded tail in row 0, pads in segment 0."""
    r = np.random.default_rng(seed)
    qkv = r.standard_normal((b, length, 3, heads, hd)).astype(np.float32)
    d_out = r.standard_normal((b, length, heads, hd)).astype(np.float32)
    mask = np.ones((b, length), np.int32)
    mask[1, 20:] = 0
    mask[2] = 0
    seg = None
    if packed:
        seg = np.ones((b, length), np.int64)
        seg[0, 13:30], seg[0, 30:] = 2, 0
        mask[0, 30:] = 0
        seg[1, 20:] = 0
        seg[2] = 0
    return qkv, d_out, mask, seg


def _tensors(qkv, d_out, mask, seg, dtype):
    return (torch.as_tensor(qkv).to(dtype), torch.as_tensor(d_out).to(dtype), torch.as_tensor(mask),
            None if seg is None else torch.as_tensor(seg))


def _autograd(qkv, d_out, mask, seg, scale):
    x = qkv.clone().requires_grad_()
    out = att.masked_attention_plain(*x.unbind(2), mask, seg, scale)
    (g,) = torch.autograd.grad(out, x, d_out)
    return g


@pytest.mark.parametrize("dtype, tol", [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)], ids=["f32", "bf16"])
@pytest.mark.parametrize("packed", [False, True], ids=["flat", "packed"])
def test_backward_plain_matches_autograd(dtype, tol, packed):
    qkv, d_out, mask, seg = _tensors(*_case(1, packed=packed), dtype)
    scale = 0.25
    q, k, v = qkv.unbind(2)
    out, m, l = att.masked_attention_plain(q, k, v, mask, seg, scale, residuals=True)
    assert torch.equal(out, att.masked_attention_plain(q, k, v, mask, seg, scale))
    # the residuals: each row's max of its biased logits and sum of exp(logit - max)
    z = att._biased_logits(q, k, mask, seg, scale)
    torch.testing.assert_close(torch.exp(z - m[..., None]) / l[..., None], torch.softmax(z, -1), atol=1e-6, rtol=0)
    got = torch.stack(att.masked_attention_backward_plain(q, k, v, out, m, l, d_out, mask, seg, scale), 2)
    want = _autograd(qkv, d_out, mask, seg, scale)
    assert want.float().abs().max() < 4
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=tol, rtol=0)
    # the all-pad row averages every key, so its q and k gradients are not 0
    assert got[2, :, 0].abs().max() > 0 and got[2, :, 1].abs().max() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("packed", [False, True], ids=["flat", "packed"])
def test_function_cpu_path_is_the_plain_backward(dtype, packed):
    """``masked_attention`` under a gradient runs ``MaskedAttention``: on the
    CPU its forward is the plain forward bit for bit and its backward the
    plain backward, and ``split_qkv`` hands the projection the backward's
    one [B, L, 3, heads, hd] buffer."""
    qkv, d_out, mask, seg = _tensors(*_case(2, packed=packed), dtype)
    x = qkv.clone().requires_grad_()
    q, k, v = att.split_qkv(x)
    out = att.masked_attention(q, k, v, mask, seg, 0.25)
    assert out.grad_fn.name() == "MaskedAttentionBackward"
    assert torch.equal(out, att.masked_attention_plain(*qkv.unbind(2), mask, seg, 0.25))
    (got,) = torch.autograd.grad(out, x, d_out)
    o, m, l = att.masked_attention_plain(*qkv.unbind(2), mask, seg, 0.25, residuals=True)
    want = att.masked_attention_backward_plain(*qkv.unbind(2), o, m, l, d_out, mask, seg, 0.25)
    assert all(torch.equal(got[:, :, i], want[i]) for i in range(3))


def test_split_qkv_passes_one_buffer_on():
    """The gradients of ``split_qkv``'s views: the planes of one contiguous
    buffer reach the projection as that buffer (no copy), any others are
    stacked."""
    x = torch.zeros((2, 5, 3, 2, 4), requires_grad=True)
    buf = torch.randn((2, 5, 3, 2, 4))
    (g,) = torch.autograd.grad(att.split_qkv(x), x, buf.unbind(2))
    assert g.data_ptr() == buf.data_ptr() and torch.equal(g, buf)
    parts = [t.clone() for t in buf.unbind(2)]
    (g,) = torch.autograd.grad(att.split_qkv(x), x, parts)
    assert g.data_ptr() != buf.data_ptr() and torch.equal(g, buf)
    with torch.no_grad():
        assert all(t._base is x for t in att.split_qkv(x))


@pytest.fixture(scope="module")
def jax_attention():
    """JAX's SelfAttention (flash form) at hidden 64, 4 heads of 16, and the
    port's with its weights."""
    jcfg = JaxConfig.tiny(vocab_size=64, hidden_size=64, num_heads=4, attention_impl="flash")
    jm = JaxSelfAttention(jcfg)
    x = np.random.default_rng(3).standard_normal((3, 37, 64)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.ones((3, 37), jnp.int32))
    tm = SelfAttention(EncoderConfig.tiny(vocab_size=64, hidden_size=64, num_heads=4, attention_impl="flash"))
    tm.load_state_dict(_attention_state_dict(params))
    return jm, params, tm, x


def _attention_state_dict(tree) -> dict:
    """A Flax SelfAttention tree (params or their gradients) in the port's
    layout."""
    tree = convert._tree(tree)
    return {"qkv.weight": convert._t(tree["qkv"]["kernel"]).reshape(64, -1).T.contiguous(),
            "qkv.bias": convert._t(tree["qkv"]["bias"]).reshape(-1),
            "out.weight": convert._t(tree["out"]["kernel"]).reshape(-1, 64).T.contiguous(),
            "out.bias": convert._t(tree["out"]["bias"])}


@pytest.mark.parametrize("packed", [False, True], ids=["flat", "packed"])
def test_attention_vjp_matches_jax(jax_attention, packed):
    """The attention layer's vjp (input and every weight) through the port's
    ``flash`` (``MaskedAttention`` on the CPU) against ``jax.vjp`` of JAX's
    ``flash`` form: f32, atol 1e-5, for a weight's gradient 1e-5 of its
    largest element (a bias gradient sums 111 rows of magnitude ~15)."""
    jm, params, tm, x = jax_attention
    _, _, mask, seg = _case(4, packed=packed)
    g = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    seg_j = None if seg is None else jnp.asarray(seg)

    def f(p, xx):
        return jm.apply(p, xx, jnp.asarray(mask), segment_ids=seg_j)

    want_out, vjp = jax.vjp(f, params, jnp.asarray(x))
    want_p, want_x = vjp(jnp.asarray(g))
    xt = torch.as_tensor(x).requires_grad_()
    tm.zero_grad()
    out = tm(xt, torch.as_tensor(mask), None if seg is None else torch.as_tensor(seg))
    out.backward(torch.as_tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), atol=F32_TOL, rtol=0)
    want_grads = _attention_state_dict(want_p)
    for name, p in tm.named_parameters():
        w = want_grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, atol=F32_TOL * max(1.0, np.abs(w).max()), rtol=0, err_msg=name)


@pytest.fixture
def counting(monkeypatch):
    """Counts of the plain forward (residual mode) and backward calls that
    ``MaskedAttention`` makes on the CPU."""
    calls = {"forward": 0, "backward": 0}
    fwd, bwd = att.masked_attention_plain, att.masked_attention_backward_plain

    def forward(*a, **kw):
        calls["forward"] += bool(kw.get("residuals"))
        return fwd(*a, **kw)

    def backward(*a, **kw):
        calls["backward"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(att, "masked_attention_plain", forward)
    monkeypatch.setattr(att, "masked_attention_backward_plain", backward)
    return calls


def test_encoder_grads_match_jax_remat_on_and_off(counting):
    """A 2-layer f32 encoder in ``flash`` at dropout 0, ragged and all-pad
    rows: every gradient against ``jax.grad`` of the JAX trunk (atol 1e-5
    relative to each leaf's norm), with remat on and off, which agree bit
    for bit.  Remat runs the Function's forward twice per layer (the first
    forward and the recompute) and its backward once."""
    rng = np.random.default_rng(6)
    ids = rng.integers(5, 128, size=(4, 20)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 9:], mask[2], mask[3, 3:] = 0, 0, 0
    ids[mask == 0] = 1
    w = rng.standard_normal((4, 20, 32)).astype(np.float32)
    jcfg = JaxConfig.tiny(vocab_size=128, attention_impl="flash", remat=True)
    jm = JaxEncoder(jcfg)
    params = jm.init(jax.random.PRNGKey(1), jnp.ones((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32))
    want = flat(jax.jit(jax.grad(lambda p: jnp.sum(jm.apply(p, jnp.asarray(ids), jnp.asarray(mask), False) * w)))(
        params))
    grads = []
    for remat in (True, False):
        calls = dict(counting)
        tm = Encoder(EncoderConfig.tiny(vocab_size=128, attention_impl="flash", remat=remat))
        tm.load_state_dict(convert.encoder_state_dict(params))
        tm = place(tm, torch.float32, DEVICE)
        (tm(*token_tensors(ids, mask, DEVICE)) * torch.as_tensor(w)).sum().backward()
        layers = tm.cfg.num_layers
        assert counting["forward"] - calls["forward"] == (2 if remat else 1) * layers
        assert counting["backward"] - calls["backward"] == layers
        layouts = convert.flax_layouts(tm, tm.cfg.num_heads)
        got = {layouts[n].path: layouts[n].to_flax(p.grad).numpy() for n, p in tm.named_parameters()}
        assert set(got) == set(want)
        for key, wv in want.items():
            assert np.linalg.norm(got[key] - wv) <= F32_TOL * max(np.linalg.norm(wv), 1.0), key
        grads.append(got)
    assert all(np.array_equal(grads[0][k], grads[1][k]) for k in want)


def test_colbert_train_step_flash_matches_jax(counting):
    """One ColBERT CE train step in ``flash`` at dropout 0 against JAX's
    (whose ``flash`` computes ``einsum`` on the CPU): the loss (rtol 1e-5),
    every gradient leaf (1e-4 of its norm, as ``test_torch_train.py``) and
    the params after the AdamW update (atol 5e-5); the port's step went
    through ``MaskedAttention``."""
    jm, tm = models("colbert", attention_impl="flash")
    batch = triplet_batch(float_masks=True)
    fit = dict(steps=10, learning_rate=1e-3)
    jstate, jtx, _ = jt.init_train_state(jm, jt.FitConfig(**fit))
    tstate, ttx, _ = tt.init_train_state(tm, tt.FitConfig(**fit))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrads = jax.jit(jax.grad(lambda p: _jax_colbert_loss(jm, p, jb)))(jm.params)
    jstate, jmet = jt.make_colbert_train_step(jm, jtx, loss_name="ce")(jstate, jb)
    tb = tt._to_device(batch, tm.device)
    loss, _ = tt.colbert_loss(tm, tb, 0, "ce")
    loss.backward()
    layouts = tt._layouts(tm)
    got = {layouts[n].path: layouts[n].to_flax(p.grad).numpy() for n, p in tm.module.named_parameters()}
    for key, wv in flat(jgrads).items():
        assert np.linalg.norm(got[key] - wv) <= 1e-4 * max(np.linalg.norm(wv), 1e-30), key
    tm.module.zero_grad(set_to_none=True)
    before = counting["backward"]
    tstate, tmet = tt.make_colbert_train_step(tm, ttx, loss_name="ce")(tstate, tb)
    assert counting["backward"] - before == 3 * tm.cfg.num_layers  # query, positive and negative forwards
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
    want, now = flat(jstate.params), flat(tm.flax_tree(tm.module.state_dict()))
    for key, wv in want.items():
        np.testing.assert_allclose(now[key], wv, rtol=0, atol=5e-5, err_msg=str(key))


def _jax_colbert_loss(jm, params, b):
    """The JAX ColBERT step's CE loss body (fusion_tpu/train/trainer.py)."""
    from fusion_tpu.train import losses

    n_neg = b["neg_ids"].shape[0] // b["query_ids"].shape[0]
    q = jm.embed_tokens(params, b["query_ids"], b["query_mask"], train=True)
    p = jm.embed_tokens(params, b["pos_ids"], b["pos_mask"], train=True)
    n = jm.embed_tokens(params, b["neg_ids"], b["neg_mask"], train=True)
    pos = jm.pairwise_maxsim(q, b["query_mask"], p, b["pos_mask"])
    bsz, ld = b["pos_ids"].shape
    neg = jm.nway_maxsim(q, b["query_mask"], n.reshape(bsz, n_neg, ld, -1), b["neg_mask"].reshape(bsz, n_neg, ld))
    return losses.info_nce(pos, neg)


@pytest.mark.parametrize("family", ["dense", "splade", "crossencoder"])
def test_each_step_factory_trains_flash(counting, family):
    """The biencoder (dense, SPLADE) and cross-encoder step factories train a
    ``flash`` model at dropout 0 through ``MaskedAttention``: one AdamW step
    whose loss and updated params equal the ``einsum`` model's (atol 1e-5:
    only the backward's ``D`` differs in its rounding)."""
    from torch_train_parity import pair_batch

    out = []
    for impl in ("einsum", "flash"):
        if family == "crossencoder":
            _, tm = models("crossencoder", attention_impl=impl)
            batch, factory = pair_batch(), lambda m, tx: tt.make_crossencoder_train_step(m, tx)
        else:
            _, tm = models("biencoder", family, attention_impl=impl)
            batch = triplet_batch()
            factory = lambda m, tx: tt.make_biencoder_train_step(m, tx, {"name": "MNRLoss", "scale": 20.0}, None, 10)  # noqa: E731
        state, tx, _ = tt.init_train_state(tm, tt.FitConfig(steps=10, learning_rate=1e-3))
        before = counting["backward"]
        state, metrics = factory(tm, tx)(state, tt._to_device(batch, tm.device))
        assert (counting["backward"] > before) == (impl == "flash")
        out.append((float(metrics["loss"]), {k: v.clone() for k, v in tm.module.state_dict().items()}))
    (l0, p0), (l1, p1) = out
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    for key in p0:
        torch.testing.assert_close(p1[key], p0[key], atol=1e-5, rtol=0)


def test_bench_colbert_train_tool_on_the_cpu():
    """``tools/bench_colbert_train.py`` at ``--tiny --device cpu`` in the
    flash form: the script's record, finite losses, no device rate under
    a CPU run, and the FLOP counts from its shapes."""
    from fusion_tpu_torch.tools import bench_colbert_train

    rec = bench_colbert_train.run(bench_colbert_train.parse_args(
        ["--tiny", "--device", "cpu", "--attention", "flash", "--steps", "1"]))
    d = rec["detail"]
    assert rec["metric"] == "colbert_train_step_ms" and rec["value"] > 0
    assert d["device"] == "cpu" and d["useful_mfu"] is None and d["useful_tflops_per_s"] is None
    assert d["tokens_per_step"] == 4 * (32 + 32 * 8) and len(d["losses"]) == 2 and np.isfinite(d["losses"]).all()
    assert d["useful_tflop_per_step"] == 6 * 2 * 12 * 32 * 32 * d["tokens_per_step"] / 1e12


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)], ids=["f32", "bf16"])
def test_backward_kernels_match_plain(dtype, tol):
    """On the card: the residual mode and the backward kernels against their
    plain versions at head dim 64, packed and not, with an all-pad row and
    a ragged length; repeated launches bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU mode")
    for packed in (False, True):
        qkv, d_out, mask, seg = (None if t is None else t.cuda() for t in
                                 _tensors(*_case(7, length=70, hd=64, packed=packed), dtype))
        q, k, v = qkv.unbind(2)
        with torch.no_grad():
            out, m, l = att.masked_attention_cuda(q, k, v, mask, seg, 0.125, residuals=True)
            assert torch.equal(out, att.masked_attention_cuda(q, k, v, mask, seg, 0.125))
            _, pm, pl = att.masked_attention_plain(q, k, v, mask, seg, 0.125, residuals=True)
            torch.testing.assert_close(m, pm, atol=1e-5, rtol=0)
            torch.testing.assert_close(l, pl, atol=0, rtol=1e-5)
            got = att.masked_attention_backward_cuda(q, k, v, out, m, l, d_out, mask, seg, 0.125)
            want = att.masked_attention_backward_plain(q, k, v, out, m, l, d_out, mask, seg, 0.125)
            again = att.masked_attention_backward_cuda(q, k, v, out, m, l, d_out, mask, seg, 0.125)
        for a, b, c in zip(got, want, again):
            torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=0)
            assert torch.equal(a, c)
