"""fusion_tpu_torch's cascade and length-bucketed rerank stages against the
JAX package's.

The JAX cross-encoder is built at ``EncoderConfig.tiny(vocab_size=512)``
in f32 with its matrices ten times the seeded init (so the logits spread
and the cascade's select is decided by more than rounding), converted into
the port, and both score the same seeded token arrays.  Tolerances: logits
at atol 2e-5 (the JAX package's own bound between its rerank stages,
``tests/test_serving.py``); the ladder, the resolved cascade and the
degenerate cascade (one flat pass) are exact; searchers match ids with
scores within rtol 1e-4 / atol 1e-5, as ``test_torch_serving_rerank.py``.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_serving import CORPUS, QUERIES
from torch_parity import DEVICE

from fusion_tpu import serving as jax_serving
from fusion_tpu.models.biencoder import BiEncoder as JaxBiEncoder
from fusion_tpu.models.crossencoder import CrossEncoder as JaxCrossEncoder
from fusion_tpu.models.encoder import EncoderConfig as JaxConfig
from fusion_tpu.serving import HybridSearcher as JaxSearcher
from fusion_tpu_torch import serving
from fusion_tpu_torch.models import convert
from fusion_tpu_torch.models.biencoder import BiEncoder
from fusion_tpu_torch.models.crossencoder import CrossEncoder
from fusion_tpu_torch.models.encoder import EncoderConfig
from fusion_tpu_torch.serving import CascadeTruncationWarning, HybridSearcher

TOL = 2e-5
SEARCH_QUERIES = QUERIES + ["loi consommateurs", "oiseaux forêt chantent"]
DEPTH, TOPK = 6, 8


@pytest.fixture(scope="module")
def pair():
    want = JaxCrossEncoder(JaxConfig.tiny(vocab_size=512), max_length=64, seed=3)
    want.params = jax.tree_util.tree_map(lambda x: x * 10 if x.ndim == 2 else x, want.params)
    got = CrossEncoder(EncoderConfig.tiny(vocab_size=512), params=convert.crossencoder_state_dict(want.params),
                       max_length=64, device=DEVICE)
    return want, got


def _candidates(rng, q=3, k=6, lq=5, ld=20):
    """Query tokens [Q, Lq] and candidate doc tokens [Q, K, Ld] with ragged
    masks, one pad candidate (mask all 0) per query."""
    q_ids = rng.integers(5, 512, size=(q, lq)).astype(np.int32)
    q_mask = (np.arange(lq)[None] < rng.integers(2, lq + 1, size=(q, 1))).astype(np.int32)
    d_ids = rng.integers(5, 512, size=(q, k, ld)).astype(np.int32)
    d_mask = (np.arange(ld)[None, None] < rng.integers(1, ld + 1, size=(q, k, 1))).astype(np.int32)
    d_mask[:, -1] = 0
    return q_ids, q_mask, d_ids, d_mask


def _both(pair, method, arrays, **kw):
    want, got = pair
    w = getattr(want, method)(want.params, *map(jnp.asarray, arrays), **kw)
    g = getattr(got, method)(*(torch.as_tensor(a, dtype=torch.int64) for a in arrays), **kw)
    return g.numpy(), np.asarray(w)


@pytest.mark.parametrize("keep, stage1", [(2, 8), (3, 4), (1, 12), (4, 0)])
def test_cascade_matches_jax(pair, rng, keep, stage1):
    got, want = _both(pair, "rerank_tokens_cascade", _candidates(rng), keep=keep, stage1_tokens=stage1,
                      pair_chunk=4)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # one total order: every kept slot above every other
    order_w, order_g = np.argsort(-want, axis=1, kind="stable"), np.argsort(-got, axis=1, kind="stable")
    np.testing.assert_array_equal(np.sort(order_g[:, :keep], axis=1), np.sort(order_w[:, :keep], axis=1))


@pytest.mark.parametrize("keep, stage1", [(6, 8), (9, 8), (2, 20), (2, 64)])
def test_degenerate_cascade_is_the_flat_rerank(pair, rng, keep, stage1):
    """keep >= K or stage1 >= Ld: one flat pass, bit-equal to rerank_tokens."""
    _, got = pair
    arrays = [torch.as_tensor(a, dtype=torch.int64) for a in _candidates(rng)]
    flat = got.rerank_tokens(*arrays, pair_chunk=4)
    assert torch.equal(got.rerank_tokens_cascade(*arrays, keep=keep, stage1_tokens=stage1, pair_chunk=4), flat)


def test_cascade_keeps_real_candidates_only(pair, rng):
    """Pad slots (doc mask all 0) never take a full-width slot."""
    _, got = pair
    arrays = [torch.as_tensor(a, dtype=torch.int64) for a in _candidates(rng)]
    out = got.rerank_tokens_cascade(*arrays, keep=5, stage1_tokens=4, pair_chunk=4)
    kept = torch.argsort(-out, dim=1, stable=True)[:, :5]
    assert not (kept == 5).any()  # slot 5 is the pad candidate of every query


@pytest.mark.parametrize("lq, ld, align", [(32, 220, 128), (5, 20, 16), (6, 250, 64), (126, 500, 128), (30, 1, 32)])
def test_aligned_buckets_equal(pair, lq, ld, align):
    want, got = pair
    assert got.aligned_buckets(lq, ld, align) == want.aligned_buckets(lq, ld, align)
    assert CrossEncoder.aligned_buckets(lq, ld, align) == JaxCrossEncoder.aligned_buckets(lq, ld, align)


def _corpus_tokens(pair):
    want, got = pair
    docs = list(CORPUS.values()) * 3
    w = want.prepare_corpus_tokens(docs, max_doc_tokens=12, return_lens=True)
    g = got.prepare_corpus_tokens(docs, max_doc_tokens=12, return_lens=True)
    np.testing.assert_array_equal(g[2], w[2])
    return w, g


@pytest.mark.parametrize("buckets", [None, (4, 8), (3,), ()], ids=["aligned", "two", "narrow", "empty"])
def test_bucketed_matches_jax(pair, rng, buckets):
    want, got = pair
    (w_tok, w_msk, lens), (g_tok, g_msk, _) = _corpus_tokens(pair)
    q_ids, q_mask = want.encode_queries_raw(QUERIES, max_query_tokens=6)
    head = rng.integers(0, g_tok.shape[0], size=(3, 5)).astype(np.int32)
    head[1, 3:] = -1
    w = want.rerank_tokens_bucketed(want.params, jnp.asarray(q_ids), jnp.asarray(q_mask), w_tok, w_msk, head, lens,
                                    buckets=buckets, pair_chunk=4)
    g = got.rerank_tokens_bucketed(torch.as_tensor(q_ids), torch.as_tensor(q_mask), g_tok, g_msk, head, lens,
                                   buckets=buckets, pair_chunk=4)
    np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)


def test_bucketed_equals_the_flat_rerank(pair, rng):
    """A doc scores as at full width in its bucket (pads carry attention 0
    and do not move RoBERTa positions)."""
    _, got = pair
    (_, _, lens), (g_tok, g_msk, _) = _corpus_tokens(pair)
    q_ids, q_mask = got.encode_queries_raw(QUERIES, max_query_tokens=6)
    q_ids, q_mask = torch.as_tensor(q_ids), torch.as_tensor(q_mask)
    head = rng.integers(0, g_tok.shape[0], size=(3, 5)).astype(np.int32)
    bucketed = got.rerank_tokens_bucketed(q_ids, q_mask, g_tok, g_msk, head, lens, pair_chunk=4)
    safe = torch.as_tensor(head).long()
    flat = got.rerank_tokens(q_ids, q_mask, got._token_ids(g_tok[safe]), g_msk[safe].long(), pair_chunk=4)
    np.testing.assert_allclose(bucketed.numpy(), flat.numpy(), atol=TOL, rtol=0)


@pytest.mark.parametrize("cascade, lens", [
    ((5, "auto"), [10, 40, 80, 120, 200]), ((5, 0), [3] * 9 + [100]), ((5, None), []), ((3, 48), [10, 20]),
    ((2, "auto"), [300] * 4),
])
def test_resolve_cascade_equal(cascade, lens):
    lens = np.asarray(lens, np.int32)
    assert serving._resolve_cascade(cascade, lens, 256) == jax_serving._resolve_cascade(cascade, lens, 256)


def test_cascade_truncation_warning():
    lens = np.arange(1, 101)
    with pytest.warns(CascadeTruncationWarning, match="p90"):
        serving._check_cascade_stage1_depth(40, lens)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        serving._check_cascade_stage1_depth(91, lens)
        serving._check_cascade_stage1_depth(10, None)
    assert issubclass(CascadeTruncationWarning, UserWarning)


@pytest.fixture(scope="module")
def models(pair):
    jce, tce = pair
    jd = JaxBiEncoder(JaxConfig.tiny(vocab_size=512), head="dense", max_query_length=8, max_doc_length=16)
    td = BiEncoder(EncoderConfig.tiny(vocab_size=512), params=convert.encoder_state_dict(jd.params), head="dense",
                   max_query_length=8, max_doc_length=16, device=DEVICE)
    return (jd, jce), (td, tce)


@pytest.mark.parametrize("option", [
    dict(rerank_cascade=(2, 6)), dict(rerank_cascade=(3, 0)), dict(rerank_cascade=(10, 64)),
    dict(rerank_buckets=(6, 12)), dict(rerank_buckets=(40,)),
], ids=["cascade", "cascade_auto", "cascade_degenerate", "buckets", "buckets_wide"])
def test_searcher_stages_match_jax(models, option):
    (jd, jce), (td, tce) = models
    common = dict(batch_size=4, topk=TOPK, rerank_depth=DEPTH, ce_max_doc_tokens=24, **option)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", CascadeTruncationWarning)
        warnings.simplefilter("ignore", jax_serving.CascadeTruncationWarning)
        want_s = JaxSearcher.build(CORPUS, dense_model=jd, cross_encoder=jce, **common)
        got_s = HybridSearcher.build(CORPUS, dense_model=td, cross_encoder=tce, device=DEVICE, **common)
    assert not got_s.rerank_packed and not want_s.rerank_packed
    assert got_s.rerank_cascade == want_s.rerank_cascade and got_s.rerank_buckets == want_s.rerank_buckets
    want, _ = want_s.search(SEARCH_QUERIES, batch_size=4, use_pallas=False)
    got, _ = got_s.search(SEARCH_QUERIES, batch_size=4)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-4, atol=1e-5)


def test_build_warns_below_the_p90_length(models):
    (_, _), (td, tce) = models
    with pytest.warns(CascadeTruncationWarning):
        HybridSearcher.build(CORPUS, dense_model=td, cross_encoder=tce, device=DEVICE, batch_size=4,
                             rerank_cascade=(2, 1))


def test_cascade_and_buckets_are_mutually_exclusive(models):
    (_, _), (td, tce) = models
    with pytest.raises(ValueError, match="rerank_cascade and rerank_buckets"):
        HybridSearcher.build(CORPUS, dense_model=td, cross_encoder=tce, device=DEVICE, batch_size=4,
                             rerank_cascade=(2, 8), rerank_buckets=(8,))
    got_s = HybridSearcher.build(CORPUS, dense_model=td, cross_encoder=tce, device=DEVICE, batch_size=4,
                                 rerank_depth=DEPTH, rerank_buckets=(8,))
    got_s.rerank_cascade = (2, 8)  # set after the build, as JAX's searcher checks at search time
    with pytest.raises(ValueError, match="mutually exclusive"):
        got_s.search(QUERIES, batch_size=4)
