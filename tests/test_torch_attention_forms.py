"""fusion_tpu_torch's attention forms (``einsum_bf16``, ``flash``) against the
JAX package's.

The JAX trunk is built at ``EncoderConfig.tiny(vocab_size=512)`` with
seeded numpy token arrays and its Flax params converted into the port.
JAX's ``flash`` on the CPU runs its ``einsum`` form (the Pallas kernel
needs a TPU), so the port's ``flash`` on the CPU, the plain version of its
masked-attention kernel (``ops/attention.py``), is held to that.  The kernel
itself runs only on the card (``cuda`` marker); the rule that sends packed
rows to it on the card (``packed_on_kernel``) is held here with its entry
stubbed and tensors that read as on the card.  Tolerances:

  * f32 ``einsum`` / ``flash``: atol 1e-5 (only the order of f32 sums
    differs);
  * f32 ``einsum_bf16`` with a power-of-two scale (head_dim 16, scale 1/4):
    atol 1e-5.  XLA computes the bf16 logits' scale and bias in f32 (excess
    precision) where the port rounds each step to bf16, as the JAX source
    spells; a power-of-two scale makes both exact, so only the sums differ;
  * f32 ``einsum_bf16`` at head_dim 8 (scale 2^-1.5): atol 1e-2 on hidden
    states, embeddings and logits (at most 6.2e-3 measured) — the rounding of
    a scaled logit, which XLA does not round, moves the softmax by up to a
    bf16 ulp (2^-8 relative);
  * bf16 compute (all forms): atol 0.0625 on hidden states of magnitude
    below 8 (two bf16 ulps there): both sides round every product and sum
    of the trunk to bf16 in their own orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_serving import CORPUS, QUERIES
from torch_parity import DEVICE, assert_ranked_match

from fusion_tpu.models.biencoder import BiEncoder as JaxBiEncoder
from fusion_tpu.models.colbert import ColBERT as JaxColBERT
from fusion_tpu.models.crossencoder import CrossEncoder as JaxCrossEncoder
from fusion_tpu.models.encoder import Encoder as JaxEncoder
from fusion_tpu.models.encoder import EncoderConfig as JaxConfig
from fusion_tpu.serving import HybridSearcher as JaxSearcher
from fusion_tpu_torch.models import convert
from fusion_tpu_torch.models.biencoder import BiEncoder
from fusion_tpu_torch.models.colbert import ColBERT
from fusion_tpu_torch.models.crossencoder import CrossEncoder
from fusion_tpu_torch.models.encoder import DropoutKey, Encoder, EncoderConfig, init_weights, place, token_tensors
from fusion_tpu_torch.serving import HybridSearcher

F32_TOL, BF16_SCALE_TOL, BF16_TOL = 1e-5, 1e-2, 0.0625
FORMS = ("einsum", "einsum_bf16", "flash")


def _tokens(rng, n=4, length=12):
    """[n, length] ids with ragged masks and one all-pad row."""
    ids = rng.integers(5, 512, size=(n, length)).astype(np.int32)
    mask = np.ones_like(ids)
    for row, keep in enumerate([length, 7, 0, 3][:n]):
        ids[row, keep:] = 1
        mask[row, keep:] = 0
    return ids, mask


def _packed(rng, rows=3, width=24):
    """Packed rows: pairs of random lengths back to back (segment ids per
    pair, positions restarting per pair), a padded tail, an all-pad row."""
    ids = np.ones((rows, width), np.int32)
    mask, seg, pos = np.zeros_like(ids), np.zeros_like(ids), np.full_like(ids, 1)
    for r in range(rows - 1):
        col, p = 0, 1
        while col < width - 4:
            ln = min(int(rng.integers(3, 9)), width - col)
            ids[r, col : col + ln] = rng.integers(5, 512, size=ln)
            mask[r, col : col + ln] = 1
            seg[r, col : col + ln] = p
            pos[r, col : col + ln] = np.arange(ln) + 2
            col, p = col + ln, p + 1
    return ids, mask, seg, pos


def _trunks(impl, dtype, num_heads=4, seed=0):
    """(JAX Encoder and params, the port's Encoder with the same weights)."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jcfg = JaxConfig.tiny(vocab_size=512, attention_impl=impl, dtype=jdt, num_heads=num_heads)
    jm = JaxEncoder(jcfg)
    params = jm.init(jax.random.PRNGKey(seed), jnp.ones((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32))
    tm = Encoder(EncoderConfig.tiny(vocab_size=512, attention_impl=impl, dtype=dtype, num_heads=num_heads))
    tm.load_state_dict(convert.encoder_state_dict(params))
    return jm, params, place(tm, dtype, DEVICE)


def _hidden(jm, params, tm, ids, mask, **packed):
    want = jm.apply(params, jnp.asarray(ids), jnp.asarray(mask), **{k: jnp.asarray(v) for k, v in packed.items()})
    with torch.inference_mode():
        got = tm(*token_tensors(ids, mask, DEVICE), **{k: torch.as_tensor(v, dtype=torch.int64) for k, v in packed.items()})
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("impl, num_heads, tol", [
    ("einsum", 4, F32_TOL), ("flash", 4, F32_TOL), ("einsum_bf16", 2, F32_TOL), ("einsum_bf16", 4, BF16_SCALE_TOL),
])
def test_f32_forms_match_jax(rng, impl, num_heads, tol):
    jm, params, tm = _trunks(impl, torch.float32, num_heads)
    got, want = _hidden(jm, params, tm, *_tokens(rng))
    assert np.isfinite(got).all()  # the all-pad row softmaxes uniformly
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("impl", FORMS)
def test_bf16_forms_match_jax(rng, impl):
    jm, params, tm = _trunks(impl, torch.bfloat16)
    got, want = _hidden(jm, params, tm, *_tokens(rng))
    assert np.isfinite(got).all() and np.abs(want).max() < 8
    np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=0)


@pytest.mark.parametrize("impl, num_heads, tol", [("einsum_bf16", 2, F32_TOL), ("flash", 4, F32_TOL)])
def test_packed_segments_match_jax(rng, impl, num_heads, tol):
    """Block-diagonal segments and per-pair positions, each form, with an
    all-pad row that stays finite."""
    jm, params, tm = _trunks(impl, torch.float32, num_heads)
    ids, mask, seg, pos = _packed(rng)
    got, want = _hidden(jm, params, tm, ids, mask, position_ids=pos, segment_ids=seg)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("impl", ("einsum_bf16", "flash"))
def test_packed_rows_equal_unpacked(rng, impl):
    """Each pair of a packed row reads the hidden states it has alone."""
    _, _, tm = _trunks(impl, torch.float32)
    ids, mask, seg, pos = _packed(rng, rows=2)
    with torch.inference_mode():
        packed = tm(*token_tensors(ids, mask, DEVICE), position_ids=torch.as_tensor(pos, dtype=torch.int64),
                    segment_ids=torch.as_tensor(seg, dtype=torch.int64))
        for p in range(1, int(seg[0].max()) + 1):
            cols = np.nonzero(seg[0] == p)[0]
            alone = tm(*token_tensors(ids[:1, cols], mask[:1, cols], DEVICE))
            np.testing.assert_allclose(packed[0, cols].numpy(), alone[0].numpy(), atol=F32_TOL, rtol=0)


def test_all_pad_rows_stay_finite():
    """No attended key at all: the -1e9 bias softmaxes uniformly in every
    form (a boolean mask would give NaN)."""
    ids, mask = np.ones((2, 16), np.int32), np.zeros((2, 16), np.int32)
    for impl in FORMS:
        for dtype in (torch.float32, torch.bfloat16):
            tm = place(Encoder(EncoderConfig.tiny(vocab_size=512, attention_impl=impl, dtype=dtype)), dtype, DEVICE)
            with torch.inference_mode():
                assert torch.isfinite(tm(*token_tensors(ids, mask, DEVICE))).all(), (impl, dtype)


def test_flash_with_dropout_computes_einsum(rng, monkeypatch):
    """With active dropout, ``flash`` runs the ``einsum`` form, as JAX's
    does: the train-mode forwards are bit-equal under one key, and the
    masked-attention kernel's entry point is not called.  Without dropout
    ``flash`` goes through it once per layer; on the CPU its plain version
    is the ``einsum`` form's arithmetic (as JAX's ``flash`` off a TPU), so
    the two forwards are bit-equal there too."""
    import fusion_tpu_torch.models.encoder as encoder_mod

    calls = []
    real = encoder_mod.masked_attention
    monkeypatch.setattr(encoder_mod, "masked_attention", lambda *a: calls.append(1) or real(*a))
    ids, mask = _tokens(rng)
    einsum = Encoder(EncoderConfig.tiny(vocab_size=512, dropout=0.1))
    init_weights(einsum, seed=3)
    flash = Encoder(EncoderConfig.tiny(vocab_size=512, attention_impl="flash", dropout=0.1))
    flash.load_state_dict(einsum.state_dict())
    out = {"einsum": einsum, "flash": flash}
    key = DropoutKey(seed=3, step=1)
    got = [m(*token_tensors(ids, mask, DEVICE), drop=key) for m in (out["einsum"], out["flash"])]
    assert torch.equal(got[0], got[1]) and not calls
    with torch.inference_mode():
        a, b = (m(*token_tensors(ids, mask, DEVICE)) for m in (out["einsum"], out["flash"]))
    assert len(calls) == flash.cfg.num_layers and torch.equal(a, b)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = JaxConfig.tiny(vocab_size=512), EncoderConfig.tiny(vocab_size=512)
    kw = dict(max_query_length=8, max_doc_length=16)
    jd, js = JaxBiEncoder(jcfg, head="dense", **kw), JaxBiEncoder(jcfg, head="splade", **kw)
    jc, jce = JaxColBERT(jcfg, dim=16, **kw), JaxCrossEncoder(jcfg, max_length=48)
    td = BiEncoder(tcfg, params=convert.encoder_state_dict(jd.params), head="dense", device=DEVICE, **kw)
    ts = BiEncoder(tcfg, params=convert.encoder_with_mlm_state_dict(js.params), head="splade", device=DEVICE, **kw)
    tc = ColBERT(tcfg, params=convert.colbert_state_dict(jc.params), dim=16, device=DEVICE, **kw)
    tce = CrossEncoder(tcfg, params=convert.crossencoder_state_dict(jce.params), max_length=48, device=DEVICE)
    return {"dense": (jd, td), "splade": (js, ts), "colbert": (jc, tc), "crossencoder": (jce, tce)}


def _outputs(name, model, jax_side, ids, mask):
    if name == "crossencoder":
        if jax_side:
            return np.asarray(model.score_tokens(model.params, jnp.asarray(ids), jnp.asarray(mask)))
        return model.score_tokens(*token_tensors(ids, mask, DEVICE)).numpy()
    if jax_side:
        return np.asarray(model.embed_tokens(model.params, jnp.asarray(ids), jnp.asarray(mask)))
    return model.embed_tokens(*token_tensors(ids, mask, DEVICE)).float().numpy()


@pytest.mark.parametrize("name", ["dense", "splade", "colbert", "crossencoder"])
@pytest.mark.parametrize("impl", ["einsum_bf16", "flash"])
def test_with_attention_views_match_jax(models, rng, name, impl):
    """``with_attention`` on each model: a view holding the same parameter
    tensors, scoring as JAX's view does."""
    jm, tm = models[name]
    view = tm.with_attention(impl)
    assert view.cfg.attention_impl == impl and tm.cfg.attention_impl == "einsum"
    assert tm.with_attention("einsum") is tm
    for (k, a), b in zip(tm.module.state_dict().items(), view.module.state_dict().values()):
        assert a.data_ptr() == b.data_ptr(), k
    ids, mask = _tokens(rng, length=8)
    ids[2, :2], mask[2, :2] = 7, 1  # no all-pad input: pooling an empty row is not the point here
    got = _outputs(name, view, False, ids, mask)
    want = _outputs(name, jm.with_attention(impl), True, ids, mask)
    tol = BF16_SCALE_TOL if impl == "einsum_bf16" else F32_TOL
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_set_encoder_attention_matches_jax(models):
    """The searcher's query encoders swapped for their ``einsum_bf16``
    views, per leg, against the JAX searcher's (scores within the
    ``einsum_bf16`` tolerance)."""
    (jd, td), (js, ts), (jc, tc) = models["dense"], models["splade"], models["colbert"]
    common = dict(batch_size=4, topk=8)
    want_s = JaxSearcher.build(CORPUS, dense_model=jd, splade_model=js, colbert_model=jc, **common)
    got_s = HybridSearcher.build(CORPUS, dense_model=td, splade_model=ts, colbert_model=tc, device=DEVICE, **common)
    assert got_s.set_encoder_attention("einsum_bf16") is got_s
    want_s.set_encoder_attention("einsum_bf16")
    for attr in ("dense_model", "splade_model", "colbert_model"):
        assert getattr(got_s, attr).cfg.attention_impl == "einsum_bf16"
    assert td.cfg.attention_impl == "einsum"  # the models themselves are untouched
    want = want_s.search_systems(QUERIES, batch_size=4, use_pallas=False)
    got = got_s.search_systems(QUERIES, batch_size=4)
    for system in ("dpr", "splade", "colbert"):
        w, g = want[system], got[system]
        assert_ranked_match(g.ids, g.scores, w.ids, w.scores, atol=BF16_SCALE_TOL)


@pytest.mark.parametrize("impl", ["einsum_bf16", "flash"])
def test_jax_checkpoint_attention_form_loads(models, tmp_path, impl):
    """A JAX cross-encoder saved with ``attention_impl`` loads in the port
    with that form and scores as JAX's; the port's save writes it back."""
    jce, _ = models["crossencoder"]
    jm = JaxCrossEncoder(dataclasses.replace(jce.cfg, attention_impl=impl), params=jce.params, max_length=48)
    jm.save(str(tmp_path / "jax"))
    got = CrossEncoder.load(str(tmp_path / "jax"), device=DEVICE)
    assert got.cfg.attention_impl == impl
    pairs = [(q, d) for q in QUERIES for d in list(CORPUS.values())[:3]]
    tol = BF16_SCALE_TOL if impl == "einsum_bf16" else F32_TOL
    np.testing.assert_allclose(got.predict(pairs, apply_sigmoid=False), jm.predict(pairs, apply_sigmoid=False),
                               atol=tol, rtol=0)
    got.save(str(tmp_path / "port"))
    assert JaxCrossEncoder.load(str(tmp_path / "port")).cfg.attention_impl == impl


def _attention_case(seed, b=3, length=70, heads=2, hd=64):
    """q, k, v [b, length, heads, hd] (views of one fused qkv array, as the
    encoder passes them), a key mask with a ragged row and an all-pad row,
    and packed-row segments (two pairs and padding in row 0)."""
    r = np.random.default_rng(seed)
    qkv = r.standard_normal((b, length, 3, heads, hd)).astype(np.float32)
    mask = np.ones((b, length), np.int32)
    mask[1, 50:] = 0
    mask[2] = 0
    seg = np.ones((b, length), np.int64)
    seg[0, 30:64], seg[0, 64:] = 2, 0
    mask[0, 64:] = 0
    return qkv, mask, seg


def _attention_reference(qkv, mask, seg):
    """numpy: the logits and the -1e9 bias summed in f32 (as the form does, so
    an all-pad row softmaxes uniformly), the softmax and · v in f64."""
    q, k, v = (qkv[:, :, i] for i in range(3))
    scale = np.float32(1 / np.sqrt(q.shape[-1]))
    logits = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k).astype(np.float32) * scale
    allowed = ((mask[:, None, :] > 0) & (seg[:, :, None] == seg[:, None, :]))[:, None]
    z = (logits + np.where(allowed, np.float32(0), np.float32(-1e9))).astype(np.float64)
    p = np.exp(z - z.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v.astype(np.float64))


@pytest.mark.parametrize("packed", [False, True])
def test_masked_attention_plain_matches_reference(packed):
    """``masked_attention`` on the CPU (the kernel's plain version) against a
    numpy reference, with ragged and all-pad rows and, packed, segments:
    atol 1e-5 (f32 sums in another order)."""
    from fusion_tpu_torch.ops.attention import masked_attention, masked_attention_plain

    qkv, mask, seg = _attention_case(5)
    t = torch.as_tensor(qkv)
    seg_t = torch.as_tensor(seg) if packed else None
    got = masked_attention(*t.unbind(2), torch.as_tensor(mask), seg_t, 1 / 8)
    want = _attention_reference(qkv, mask, seg if packed else np.ones_like(seg))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert torch.equal(got, masked_attention_plain(*t.unbind(2), torch.as_tensor(mask), seg_t, 1 / 8))
    # the all-pad row attends uniformly: the mean of its values
    np.testing.assert_allclose(got[2].numpy(), np.broadcast_to(qkv[2, :, 2].mean(0), got[2].shape), atol=1e-5)


def test_masked_attention_cuda_refuses_cpu_tensors():
    """The kernel's wrapper raises on tensors that are not on the card (the
    entry point sends those to the plain version)."""
    from fusion_tpu_torch.ops.attention import masked_attention_cuda

    qkv, mask, _ = _attention_case(6)
    before = masked_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        masked_attention_cuda(*torch.as_tensor(qkv).unbind(2), torch.as_tensor(mask), None, 1 / 8)
    assert masked_attention_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_masked_attention_kernel_matches_plain(dtype, atol):
    """On the card: the kernel against its plain version on the same inputs
    (f32: scalar f32 sums in another order; bf16: the kernel rounds the
    unnormalized probabilities to bf16 before · v, the plain version the
    normalized ones), packed and not, at a ragged length."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    from fusion_tpu_torch.ops.attention import masked_attention_cuda, masked_attention_plain

    qkv, mask, seg = _attention_case(7)
    t = torch.as_tensor(qkv, device="cuda").to(dtype)
    m = torch.as_tensor(mask, device="cuda")
    for s in (None, torch.as_tensor(seg, device="cuda")):
        got = masked_attention_cuda(*t.unbind(2), m, s, 1 / 8)
        want = masked_attention_plain(*t.unbind(2), m, s, 1 / 8)
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


class _CardTensor(torch.Tensor):
    """A CPU tensor that reads as one on the card (``is_cuda``), and so does
    every tensor computed from it: the CPU reaches the packed rows' kernel
    branch with the kernel's entry stubbed."""

    @property
    def is_cuda(self):
        return True


def _einsum_chain(q, k, v, mask, seg, cfg, drop=None):
    """The ``einsum`` form's chain spelled out: f32 logits · scale, the f32
    -1e9 bias off the allowed keys, the f32 softmax cast to ``cfg.dtype``,
    dropout on the probabilities, · v."""
    from fusion_tpu_torch.models.encoder import SITE_ATTN_PROBS, dropout
    from fusion_tpu_torch.ops.attention import allowed_keys

    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / np.sqrt(q.shape[-1]))
    bias = torch.where(allowed_keys(mask, seg), 0.0, -1e9).to(torch.float32)
    probs = dropout(torch.softmax(logits + bias, dim=-1).to(cfg.dtype), cfg.dropout, drop, 0, SITE_ATTN_PROBS)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _stub_kernel(monkeypatch):
    """Point the trunk's ``masked_attention`` (the kernel on the card) at its
    plain version, recording each call's masks → the list of (mask, segment
    ids) calls."""
    import fusion_tpu_torch.models.encoder as encoder_mod
    from fusion_tpu_torch.ops.attention import masked_attention_plain

    calls = []

    def kernel(q, k, v, mask, seg, scale):
        calls.append((mask, seg))
        plain = (t.as_subclass(torch.Tensor) for t in (q, k, v, mask, seg))
        return masked_attention_plain(*plain, scale)

    monkeypatch.setattr(encoder_mod, "masked_attention", kernel)
    return calls


# (form, dtype, packed, on the card, gradient, dropout, head dim) → the path
BF16, F32 = torch.bfloat16, torch.float32
PACKED_RULE_CASES = {
    "packed_einsum_card": ("einsum", BF16, True, True, False, False, 64, "kernel"),
    "packed_flash_card": ("flash", BF16, True, True, False, False, 64, "kernel"),
    "packed_flash_card_f32": ("flash", F32, True, True, False, False, 64, "kernel"),
    "no_segments": ("einsum", BF16, False, True, False, False, 64, "chain"),
    "einsum_bf16": ("einsum_bf16", BF16, True, True, False, False, 64, "chain"),
    "einsum_f32": ("einsum", F32, True, True, False, False, 64, "chain"),
    "gradient": ("einsum", BF16, True, True, True, False, 64, "chain"),
    "dropout": ("einsum", BF16, True, True, False, True, 64, "chain"),
    "head_dim_32": ("einsum", BF16, True, True, False, False, 32, "chain"),
    "cpu_tensor": ("einsum", BF16, True, False, False, False, 64, "chain"),
}


@pytest.mark.parametrize("case", list(PACKED_RULE_CASES))
def test_packed_rows_take_the_kernel_by_rule(monkeypatch, case):
    """Packed rows' attention runs the masked-attention kernel exactly when
    the call shows it computes the ``einsum`` arithmetic: segments given,
    the form ``flash`` (its own path, in either dtype) or ``einsum`` with
    ``q`` in bf16 on the card, no gradient, no active dropout, head dim 64.
    Every other call runs its form's chain, bit for bit on the CPU (an f32
    forward, a reference of the bf16 one, included), and the kernel's entry
    is not called.  Under
    tracing each packed call counts ``attention.packed_kernel`` or
    ``attention.packed_einsum``, a call without segments neither."""
    from fusion_tpu_torch.models.encoder import DropoutKey, attention
    from fusion_tpu_torch.utils import profiling

    impl, dtype, packed, card, grad, drop, hd, path = PACKED_RULE_CASES[case]
    calls = _stub_kernel(monkeypatch)
    qkv, mask, seg = _attention_case(9, hd=hd)
    cfg = EncoderConfig.tiny(attention_impl=impl, dtype=dtype, dropout=0.1 if drop else 0.0)
    base = torch.as_tensor(qkv).to(dtype)
    qkv_t = base.requires_grad_(grad).as_subclass(_CardTensor) if card else base.requires_grad_(grad)
    mask_t, seg_t = torch.as_tensor(mask), torch.as_tensor(seg) if packed else None
    key = DropoutKey(seed=4, step=2) if drop else None
    profiling.reset()
    with profiling.tracing():
        got = attention(*qkv_t.unbind(2), mask_t, seg_t, cfg, key)
    counters = profiling.snapshot()["counters"]
    profiling.reset()
    got = got.as_subclass(torch.Tensor)
    if path == "kernel":
        from fusion_tpu_torch.ops.attention import masked_attention_plain

        assert len(calls) == 1 and counters == {"attention.packed_kernel": 1}
        assert torch.equal(got, masked_attention_plain(*base.unbind(2), mask_t, seg_t, 1 / 8))
        return
    assert not calls
    assert counters == ({"attention.packed_einsum": 1} if packed else {})
    if impl == "einsum_bf16":  # its own chain: the same call on a tensor the card does not hold
        want = attention(*base.unbind(2), mask_t, seg_t, cfg)
    else:
        want = _einsum_chain(*base.unbind(2), mask_t, seg_t, cfg, key)
    assert got.requires_grad == grad and torch.equal(got, want)


def test_packed_trunk_converts_the_masks_once(monkeypatch, rng):
    """A packed trunk forward on the card hands every layer's kernel call the
    same int32 masks, converted once at the trunk's entry, and counts one
    ``attention.packed_kernel`` a layer; its hidden states are those of the
    kernel's plain version (the ``flash`` form's CPU path)."""
    from fusion_tpu_torch.utils import profiling

    cfg = EncoderConfig.tiny(vocab_size=512, hidden_size=128, num_heads=2, dtype=torch.bfloat16)
    einsum = Encoder(cfg)
    init_weights(einsum, seed=5)
    flash = Encoder(dataclasses.replace(cfg, attention_impl="flash"))
    flash.load_state_dict(einsum.state_dict())
    einsum, flash = place(einsum, torch.bfloat16, DEVICE), place(flash, torch.bfloat16, DEVICE)
    ids, mask, seg, pos = (torch.as_tensor(a, dtype=torch.int64) for a in _packed(rng))
    with torch.inference_mode():
        want = flash(ids, mask, pos, seg)
    calls = _stub_kernel(monkeypatch)
    profiling.reset()
    with torch.inference_mode(), profiling.tracing():
        got = einsum(ids.as_subclass(_CardTensor), mask, pos, seg).as_subclass(torch.Tensor)
        counters = profiling.snapshot()["counters"]
    profiling.reset()
    assert counters == {"attention.packed_kernel": cfg.num_layers} and len(calls) == cfg.num_layers
    first_mask, first_seg = calls[0]
    assert first_mask.dtype == first_seg.dtype == torch.int32
    assert all(m is first_mask and s is first_seg for m, s in calls)
    assert torch.equal(got, want)
