"""fusion_tpu_torch's T5 cross-encoder (``models/t5.py``) against the JAX
package's.

The JAX model is built at ``T5Config.tiny(vocab_size=512)`` (and its
variants) in f32, its Flax params converted by
``convert.t5_crossencoder_state_dict``; seeded numpy token arrays and the
same texts feed both.  Tolerances: the bucket table is bit-equal for every
distance up to 4,096; forwards, packed rows and rerank logits at atol 1e-5
(f32 both sides, only the order of sums differs; the packed rows against
the port's own unpacked forward at the same bound); searchers match ids
with scores within rtol 1e-4 / atol 1e-5, as ``test_torch_serving_rerank.py``;
the CLI's test task within 1e-6 of JAX's on the port's trained model.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_serving import CORPUS, QUERIES
from test_torch_cli import _fixture
from torch_parity import DEVICE

from fusion_tpu.cli.main import main as jax_main
from fusion_tpu.core.ranked import RankedLists as JaxRanked
from fusion_tpu.models.biencoder import BiEncoder as JaxBiEncoder
from fusion_tpu.models.encoder import EncoderConfig as JaxConfig
from fusion_tpu.models.t5 import T5Config as JaxT5Config
from fusion_tpu.models.t5 import T5CrossEncoder as JaxT5
from fusion_tpu.models.t5 import mt5_config as jax_mt5_config
from fusion_tpu.models.t5 import relative_position_bucket as jax_bucket
from fusion_tpu.serving import HybridSearcher as JaxSearcher
from fusion_tpu_torch.cli.main import main
from fusion_tpu_torch.core.ranked import RankedLists
from fusion_tpu_torch.models import convert
from fusion_tpu_torch.models.biencoder import BiEncoder
from fusion_tpu_torch.models.crossencoder import CrossEncoder
from fusion_tpu_torch.models.encoder import EncoderConfig, token_tensors
from fusion_tpu_torch.models.t5 import T5Config, T5CrossEncoder, mt5_config, relative_position_bucket
from fusion_tpu_torch.serving import HybridSearcher

ATOL = 1e-5
SEARCH_QUERIES = QUERIES + ["loi consommateurs", "oiseaux forêt chantent"]


def _pair(**kw):
    """(JAX T5 cross-encoder, the port's) with the same weights, the
    relative bias and the matrices spread so the logits differ across
    pairs."""
    want = JaxT5(JaxT5Config.tiny(vocab_size=512, **kw), max_length=48, seed=1)
    want.params = jax.tree_util.tree_map(lambda x: x * 5 if x.ndim == 2 and x.shape[0] > 32 else x, want.params)
    cfg = T5Config.tiny(vocab_size=512, **kw)
    got = T5CrossEncoder(cfg, params=convert.t5_crossencoder_state_dict(want.params, cfg), max_length=48,
                         device=DEVICE)
    return want, got


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.mark.parametrize("num_buckets, max_distance", [(32, 128), (32, 64), (64, 256), (16, 32), (128, 4096)])
def test_relative_position_bucket_bit_equal(num_buckets, max_distance):
    d = np.arange(-4096, 4097, dtype=np.int32)
    want = np.asarray(jax_bucket(jnp.asarray(d), num_buckets, max_distance))
    got = relative_position_bucket(torch.from_numpy(d), num_buckets, max_distance).numpy()
    np.testing.assert_array_equal(got, want)
    grid = d[:, None] - d[None, ::512]  # any shape, as the attention's [B, T, T]
    np.testing.assert_array_equal(relative_position_bucket(torch.from_numpy(grid), num_buckets, max_distance).numpy(),
                                  np.asarray(jax_bucket(jnp.asarray(grid), num_buckets, max_distance)))


def _tokens(rng, n=4, length=20):
    ids = rng.integers(5, 512, size=(n, length)).astype(np.int32)
    mask = np.ones_like(ids)
    for r, keep in enumerate([length, 7, 1, 13][:n]):
        ids[r, keep:], mask[r, keep:] = 0, 0
    mask[1, 3:5] = 0  # mid-sequence pads: positions count attended slots
    return ids, mask


@pytest.mark.parametrize("kw", [{}, {"gated_ffn": True}, {"pooling_mode": "max"}, {"pooling_mode": "first"}],
                         ids=["relu_mean", "gated", "max", "first"])
def test_forward_matches_jax(rng, kw):
    want, got = _pair(**kw)
    ids, mask = _tokens(rng)
    w = np.asarray(want.score_tokens(want.params, jnp.asarray(ids), jnp.asarray(mask)))
    g = got.score_tokens(*token_tensors(ids, mask, DEVICE)).numpy()
    assert np.ptp(w) > 1e-2  # the pairs' logits differ
    np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def test_mt5_config_is_gated():
    assert mt5_config().gated_ffn and jax_mt5_config().gated_ffn
    assert T5Config().d_model == JaxT5Config().d_model == 512 and T5Config(vocab_size=32005).num_layers == 6


def _head(rng, n_docs, q=3, k=5):
    head = rng.integers(0, n_docs, size=(q, k)).astype(np.int32)
    head[1, 3:] = -1
    return head


@pytest.fixture(scope="module")
def tokens(pair):
    want, got = pair
    docs = list(CORPUS.values()) * 2
    w = want.prepare_corpus_tokens(docs, max_doc_tokens=16, return_lens=True)
    g = got.prepare_corpus_tokens(docs, max_doc_tokens=16, return_lens=True)
    q_ids, q_mask = want.encode_queries_raw(QUERIES, max_query_tokens=6)
    return w, g, (np.asarray(q_ids), np.asarray(q_mask))


@pytest.mark.parametrize("pooling", ["mean", "max", "first"])
def test_packed_rerank_matches_jax_and_unpacked(rng, pooling):
    want, got = _pair(pooling_mode=pooling)
    docs = list(CORPUS.values()) * 2
    w_tok, w_msk, lens = want.prepare_corpus_tokens(docs, max_doc_tokens=16, return_lens=True)
    g_tok, g_msk, _ = got.prepare_corpus_tokens(docs, max_doc_tokens=16, return_lens=True)
    q_ids, q_mask = want.encode_queries_raw(QUERIES, max_query_tokens=6)
    q_lens = np.asarray(q_mask).sum(axis=1).astype(np.int32)
    head = _head(rng, len(docs))
    w = want.rerank_tokens_packed(want.params, jnp.asarray(q_ids), jnp.asarray(q_mask), w_tok, w_msk, head, lens,
                                  q_lens, row_width=64)
    qt, qm = torch.as_tensor(q_ids), torch.as_tensor(q_mask)
    g = got.rerank_tokens_packed(qt, qm, g_tok, g_msk, head, lens, q_lens, row_width=64)
    np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)
    # the packed rows score every real pair as the flat (one pair a row) rerank
    safe = torch.as_tensor(head).clamp(min=0).long()
    flat = got.rerank_tokens(qt, qm, got._token_ids(g_tok[safe]), g_msk[safe].long(), pair_chunk=4)
    real = head >= 0
    np.testing.assert_allclose(g.numpy()[real], flat.numpy()[real], atol=ATOL, rtol=0)


def test_assembled_packed_rows_equal_jax(pair, tokens, rng):
    want, got = pair
    (w_tok, _, lens), (g_tok, _, _), (q_ids, q_mask) = tokens
    q_lens = q_mask.sum(axis=1).astype(np.int32)
    head = _head(rng, w_tok.shape[0])
    desc, *_ = got.plan_packed(head, lens, q_lens, q_ids.shape[1], g_tok.shape[1], g_tok.shape[0], row_width=64)
    desc_w, *_ = want.plan_packed(head, lens, q_lens, q_ids.shape[1], w_tok.shape[1], w_tok.shape[0], row_width=64)
    np.testing.assert_array_equal(desc, desc_w)
    rows_w = want.assemble_packed_rows(jnp.asarray(desc), jnp.asarray(q_ids), w_tok[jnp.asarray(desc[1])].astype(
        jnp.int32), 3, 64, want._packed_consts)
    d = torch.as_tensor(desc)
    rows_g = got.assemble_packed_rows(d, torch.as_tensor(q_ids), got._token_ids(g_tok[d[1].long()]), 3, 64,
                                      got._packed_consts)
    for g, w in zip(rows_g, rows_w):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("method, kw", [
    ("rerank_tokens", {}), ("rerank_tokens_cascade", {"keep": 2, "stage1_tokens": 5}),
])
def test_flat_and_cascade_rerank_match_jax(pair, tokens, rng, method, kw):
    want, got = pair
    (w_tok, w_msk, _), (g_tok, g_msk, _), (q_ids, q_mask) = tokens
    head = np.clip(_head(rng, w_tok.shape[0]), 0, None)
    w = getattr(want, method)(want.params, jnp.asarray(q_ids), jnp.asarray(q_mask),
                              w_tok[jnp.asarray(head)].astype(jnp.int32), w_msk[jnp.asarray(head)].astype(jnp.int32),
                              pair_chunk=4, **kw)
    safe = torch.as_tensor(head).long()
    g = getattr(got, method)(torch.as_tensor(q_ids), torch.as_tensor(q_mask), got._token_ids(g_tok[safe]),
                             g_msk[safe].long(), pair_chunk=4, **kw)
    np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


def test_bucketed_rerank_matches_jax(pair, tokens, rng):
    want, got = pair
    (w_tok, w_msk, lens), (g_tok, g_msk, _), (q_ids, q_mask) = tokens
    head = _head(rng, w_tok.shape[0])
    assert got.aligned_buckets(6, 16) == want.aligned_buckets(6, 16)  # T5's one special slot
    w = want.rerank_tokens_bucketed(want.params, jnp.asarray(q_ids), jnp.asarray(q_mask), w_tok, w_msk, head, lens,
                                    buckets=(6, 12), pair_chunk=4)
    g = got.rerank_tokens_bucketed(torch.as_tensor(q_ids), torch.as_tensor(q_mask), g_tok, g_msk, head, lens,
                                   buckets=(6, 12), pair_chunk=4)
    np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


def test_predict_and_rerank_match_jax(pair):
    want, got = pair
    pairs = [(q, d) for q in QUERIES for d in list(CORPUS.values())[:4]]
    np.testing.assert_allclose(got.predict(pairs, batch_size=5), want.predict(pairs, batch_size=5), atol=ATOL)
    cand = np.array([[11, 22, 33, -1], [44, 55, 11, 22], [33, -1, -1, 66]], np.int32)
    scores = np.linspace(1.0, 0.0, 4, dtype=np.float32)[None].repeat(3, 0)
    w = want.rerank(QUERIES, JaxRanked(jnp.asarray(cand), jnp.asarray(scores)), CORPUS, top_k=4)
    g = got.rerank(QUERIES, RankedLists(torch.from_numpy(cand), torch.from_numpy(scores)), CORPUS, top_k=4)
    np.testing.assert_array_equal(g.ids.numpy(), np.asarray(w.ids))
    np.testing.assert_allclose(g.scores.numpy(), np.asarray(w.scores), atol=ATOL, rtol=0)


@pytest.mark.parametrize("packed", [False, None], ids=["flat", "packed"])
def test_searcher_with_t5_matches_jax(pair, packed):
    want_ce, got_ce = pair
    jd = JaxBiEncoder(JaxConfig.tiny(vocab_size=512), head="dense", max_query_length=8, max_doc_length=16)
    td = BiEncoder(EncoderConfig.tiny(vocab_size=512), params=convert.encoder_state_dict(jd.params), head="dense",
                   max_query_length=8, max_doc_length=16, device=DEVICE)
    common = dict(batch_size=4, topk=8, rerank_depth=5, rerank_packed=packed, ce_max_doc_tokens=16)
    want_s = JaxSearcher.build(CORPUS, dense_model=jd, cross_encoder=want_ce, **common)
    got_s = HybridSearcher.build(CORPUS, dense_model=td, cross_encoder=got_ce, device=DEVICE, **common)
    assert got_s.rerank_packed == want_s.rerank_packed == (packed is None)
    if packed is None:
        want_s.rerank_row_width = got_s.rerank_row_width = 64
    want, _ = want_s.search(SEARCH_QUERIES, batch_size=4, use_pallas=False)
    got, _ = got_s.search(SEARCH_QUERIES, batch_size=4)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-4, atol=1e-5)


def test_save_load_both_ways(pair, tmp_path):
    want, got = pair
    pairs = [(q, d) for q in QUERIES for d in list(CORPUS.values())[:3]]
    want.save(str(tmp_path / "jax"))
    from_jax = T5CrossEncoder.load(str(tmp_path / "jax"), device=DEVICE)
    assert from_jax.cfg == got.cfg
    np.testing.assert_allclose(from_jax.predict(pairs), want.predict(pairs), atol=ATOL)
    got.save(str(tmp_path / "port"))
    with open(tmp_path / "port" / "config_fusion_tpu.json") as f:
        assert json.load(f)["model_type"] == "t5_crossencoder"
    np.testing.assert_allclose(JaxT5.load(str(tmp_path / "port")).predict(pairs), got.predict(pairs), atol=ATOL)
    with pytest.raises(ValueError, match="T5CrossEncoder.load"):
        CrossEncoder.load(str(tmp_path / "port"), device=DEVICE)


def test_cli_backbone_t5_trains_and_tests_as_jax(tmp_path):
    """``monobert --backbone t5`` trains a T5 cross-encoder (the CE step
    under autograd), saves a ``t5_crossencoder`` checkpoint, and its test
    task scores as the JAX CLI's does on that checkpoint."""
    fx = tmp_path / "fixture.json"
    fx.write_text(json.dumps(_fixture()))
    base = ["--fixture", str(fx), "--tiny"]
    main(["monobert", "--task", "train", "--backbone", "t5", "--steps", "3", "--train_batch_size", "2",
          "--output_dir", str(tmp_path / "train"), "--device", DEVICE, *base])
    final = str(tmp_path / "train" / "final")
    trained = T5CrossEncoder.load(final, device=DEVICE)
    fresh = T5CrossEncoder(T5Config.tiny(), seed=42, device=DEVICE)
    assert any(not torch.equal(a, b) for a, b in zip(trained.module.state_dict().values(),
                                                     fresh.module.state_dict().values()))
    out = {}
    for pkg, run, extra in (("jax", jax_main, []), ("port", main, ["--device", DEVICE])):
        out_dir = tmp_path / f"test_{pkg}"
        run(["monobert", "--task", "test", "--model_path", final, "--output_dir", str(out_dir), *base, *extra])
        with open(out_dir / "rerank_eval_results.csv") as f:
            header, row = f.read().strip().splitlines()[:2]
        out[pkg] = dict(zip(header.split(","), row.split(",")))
    for k, v in out["jax"].items():
        if "ms" not in k:
            assert abs(float(out["port"][k]) - float(v)) <= 1e-6, (k, out["port"][k], v)
    assert os.path.isfile(os.path.join(final, "params.msgpack"))
