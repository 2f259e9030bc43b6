"""fusion_tpu_torch's int8 trunk (``quantize="int8"``) against the JAX
package's ``int8_dot_general``.

The codes are held bit-equal: JAX's are captured from the ``lax.dot_general``
call inside ``int8_dot_general`` (run eagerly), the port's come from
``int8_codes``; the int32 products and the f32 rescale then match to the
last bit as well (integer sums are exact, and the rescale is the same
three f32 operations).  The quantized views of every model are held to
JAX's views at atol 1e-3 (``INT8_TOL``): the int8 layers are exact on equal
inputs, but an activation that differs from JAX's in its last f32 bit (the
other sums run in another order) can sit on a rounding edge and move its
code by one step, a change of about 1/127 of one product; the searcher's
``quantize_encoders`` per leg at the same tolerance, and a JAX checkpoint
saved with ``quantize: int8`` loads in the port with that trunk.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_serving import CORPUS, QUERIES
from torch_parity import DEVICE, assert_ranked_match

from fusion_tpu.models import encoder as jax_encoder
from fusion_tpu.models.biencoder import BiEncoder as JaxBiEncoder
from fusion_tpu.models.colbert import ColBERT as JaxColBERT
from fusion_tpu.models.crossencoder import CrossEncoder as JaxCrossEncoder
from fusion_tpu.models.encoder import EncoderConfig as JaxConfig
from fusion_tpu.models.t5 import T5Config as JaxT5Config
from fusion_tpu.models.t5 import T5CrossEncoder as JaxT5
from fusion_tpu.serving import HybridSearcher as JaxSearcher
from fusion_tpu_torch.models import convert
from fusion_tpu_torch.models.biencoder import BiEncoder
from fusion_tpu_torch.models.colbert import ColBERT
from fusion_tpu_torch.models.crossencoder import CrossEncoder
from fusion_tpu_torch.models.encoder import EncoderConfig, int8_codes, int8_linear, token_tensors
from fusion_tpu_torch.models.t5 import T5Config, T5CrossEncoder
from fusion_tpu_torch.serving import HybridSearcher

INT8_TOL = 1e-3


def _jax_int8(monkeypatch, lhs, rhs):
    """JAX's ``int8_dot_general`` of ``lhs`` [M, K] and ``rhs`` [K, N] (a
    Dense kernel), with the int8 operands its inner ``dot_general`` saw."""
    seen = []
    inner = jax.lax.dot_general

    def capture(a, b, *args, **kw):
        seen.append((np.asarray(a), np.asarray(b)))
        return inner(a, b, *args, **kw)

    monkeypatch.setattr(jax.lax, "dot_general", capture)
    out = jax_encoder.int8_dot_general(jnp.asarray(lhs), jnp.asarray(rhs), (((1,), (0,)), ((), ())))
    monkeypatch.undo()
    (lq, rq), = seen
    return np.asarray(out), lq, rq


@pytest.mark.parametrize("m, k, n, scale", [(3, 32, 48, 1.0), (40, 64, 24, 300.0), (17, 8, 8, 1e-3)])
def test_int8_codes_and_product_bit_equal_to_jax(monkeypatch, rng, m, k, n, scale):
    x = (rng.standard_normal((m, k)) * scale).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    x[0] = 0.0  # an all-zero row: the 1e-12 floor keeps its codes 0
    want, lq, rq = _jax_int8(monkeypatch, x, w)
    xq, _ = int8_codes(torch.from_numpy(x))
    wq, _ = int8_codes(torch.from_numpy(w.T.copy()))  # the port's weight is [N, K]
    np.testing.assert_array_equal(xq.numpy(), lq)
    np.testing.assert_array_equal(wq.numpy().T, rq)
    got = int8_linear(torch.from_numpy(x), torch.from_numpy(w.T.copy()), None).numpy()
    np.testing.assert_array_equal(got, want)


def test_int8_linear_pads_few_rows(rng):
    """Fewer than 17 rows are padded for ``torch._int_mm`` and the padding
    is dropped: each row's output is what it gets in a large batch."""
    x = torch.from_numpy(rng.standard_normal((40, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 32)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    big = int8_linear(x, w, b)
    for rows in (1, 5, 16):
        assert torch.equal(int8_linear(x[:rows], w, b), big[:rows])
    assert int8_linear(x.view(4, 10, 32), w, b).shape == (4, 10, 16)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = JaxConfig.tiny(vocab_size=512), EncoderConfig.tiny(vocab_size=512)
    kw = dict(max_query_length=8, max_doc_length=16)
    jd, js = JaxBiEncoder(jcfg, head="dense", **kw), JaxBiEncoder(jcfg, head="splade", **kw)
    jc, jce = JaxColBERT(jcfg, dim=16, **kw), JaxCrossEncoder(jcfg, max_length=48)
    jt5 = JaxT5(JaxT5Config.tiny(vocab_size=512), max_length=48)
    t5cfg = T5Config.tiny(vocab_size=512)
    return {
        "dense": (jd, BiEncoder(tcfg, params=convert.encoder_state_dict(jd.params), head="dense", device=DEVICE,
                                **kw)),
        "splade": (js, BiEncoder(tcfg, params=convert.encoder_with_mlm_state_dict(js.params), head="splade",
                                 device=DEVICE, **kw)),
        "colbert": (jc, ColBERT(tcfg, params=convert.colbert_state_dict(jc.params), dim=16, device=DEVICE, **kw)),
        "crossencoder": (jce, CrossEncoder(tcfg, params=convert.crossencoder_state_dict(jce.params), max_length=48,
                                           device=DEVICE)),
        "t5": (jt5, T5CrossEncoder(t5cfg, params=convert.t5_crossencoder_state_dict(jt5.params, t5cfg),
                                   max_length=48, device=DEVICE)),
    }


def _tokens(rng):
    ids = rng.integers(5, 512, size=(4, 10)).astype(np.int32)
    mask = np.ones_like(ids)
    for row, keep in enumerate([10, 6, 2, 8]):
        ids[row, keep:], mask[row, keep:] = 1, 0
    return ids, mask


def _score(name, model, jax_side, ids, mask):
    if jax_side:
        fn = model.score_tokens if name in ("crossencoder", "t5") else model.embed_tokens
        return np.asarray(fn(model.params, jnp.asarray(ids), jnp.asarray(mask)))
    fn = model.score_tokens if name in ("crossencoder", "t5") else model.embed_tokens
    return fn(*token_tensors(ids, mask, DEVICE)).float().numpy()


@pytest.mark.parametrize("name", ["dense", "splade", "colbert", "crossencoder", "t5"])
def test_quantized_views_match_jax(models, rng, name):
    """Each model's ``quantized()`` view: the same parameter tensors, the
    int8 trunk, JAX's view's outputs."""
    jm, tm = models[name]
    view = tm.quantized()
    assert view.cfg.quantize == "int8" and tm.cfg.quantize is None
    for (k, a), b in zip(tm.module.state_dict().items(), view.module.state_dict().values()):
        assert a.data_ptr() == b.data_ptr(), k
    ids, mask = _tokens(rng)
    got = _score(name, view, False, ids, mask)
    want = _score(name, jm.quantized(), True, ids, mask)
    plain = _score(name, tm, False, ids, mask)
    assert np.abs(got - plain).max() > 1e-4  # the int8 trunk is another computation
    np.testing.assert_allclose(got, want, atol=INT8_TOL, rtol=0)


def test_quantize_encoders_matches_jax(models):
    """``quantize_encoders`` swaps the three query encoders for their int8
    views; per leg the lists match the JAX searcher's after the same call."""
    (jd, td), (js, ts), (jc, tc) = models["dense"], models["splade"], models["colbert"]
    common = dict(batch_size=4, topk=8)
    want_s = JaxSearcher.build(CORPUS, dense_model=jd, splade_model=js, colbert_model=jc, **common)
    got_s = HybridSearcher.build(CORPUS, dense_model=td, splade_model=ts, colbert_model=tc, device=DEVICE, **common)
    assert got_s.quantize_encoders() is got_s
    want_s.quantize_encoders()
    assert all(getattr(got_s, a).cfg.quantize == "int8" for a in ("dense_model", "splade_model", "colbert_model"))
    want = want_s.search_systems(QUERIES, batch_size=4, use_pallas=False)
    got = got_s.search_systems(QUERIES, batch_size=4)
    for system in ("dpr", "splade", "colbert"):
        assert_ranked_match(got[system].ids, got[system].scores, want[system].ids, want[system].scores, atol=INT8_TOL)


def test_build_encoders_int8_matches_jax(models):
    """``build(encoders_int8=True)``: the index from the full-precision
    encoders, the queries through the int8 views, as JAX builds it."""
    (jd, td) = models["dense"]
    want_s = JaxSearcher.build(CORPUS, dense_model=jd, batch_size=4, topk=8, encoders_int8=True)
    got_s = HybridSearcher.build(CORPUS, dense_model=td, batch_size=4, topk=8, encoders_int8=True, device=DEVICE)
    assert got_s.dense_model.cfg.quantize == "int8" and td.cfg.quantize is None
    w, _ = want_s.search(QUERIES, batch_size=4, use_pallas=False)
    g, _ = got_s.search(QUERIES, batch_size=4)
    assert_ranked_match(g.ids, g.scores, w.ids, w.scores, atol=INT8_TOL)


@pytest.mark.parametrize("name", ["crossencoder", "dense"])
def test_jax_checkpoint_with_quantize_loads(models, tmp_path, name):
    """A JAX model saved with ``quantize: int8`` loads in the port with the
    int8 trunk and scores as JAX's; the port writes it back."""
    jm, _ = models[name]
    if name == "crossencoder":
        jq = JaxCrossEncoder(dataclasses.replace(jm.cfg, quantize="int8"), params=jm.params, max_length=48)
        port_cls, jax_cls = CrossEncoder, JaxCrossEncoder
    else:
        jq = jm.quantized()
        port_cls, jax_cls = BiEncoder, JaxBiEncoder
    jq.save(str(tmp_path / "jax"))
    got = port_cls.load(str(tmp_path / "jax"), device=DEVICE)
    assert got.cfg.quantize == "int8"
    ids, mask = _tokens(np.random.default_rng(3))
    np.testing.assert_allclose(_score(name, got, False, ids, mask), _score(name, jq, True, ids, mask),
                               atol=INT8_TOL, rtol=0)
    got.save(str(tmp_path / "port"))
    assert jax_cls.load(str(tmp_path / "port")).cfg.quantize == "int8"
