"""The fusion_tpu_torch HybridSearcher with the monoBERT rerank stage against
the JAX searcher: same corpus, queries and (converted) weights, DPR + SPLADE
+ the cross-encoder, flat and packed.

Ids must be equal and scores within rtol 1e-4 / atol 1e-5, the JAX
package's own bound between its rerank stages (``tests/test_serving.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_serving import CORPUS, QUERIES
from torch_parity import DEVICE

from fusion_tpu.core.ranked import RankedLists as JaxRanked
from fusion_tpu.models.biencoder import BiEncoder as JaxBiEncoder
from fusion_tpu.models.crossencoder import CrossEncoder as JaxCrossEncoder
from fusion_tpu.models.encoder import EncoderConfig as JaxConfig
from fusion_tpu.serving import HybridSearcher as JaxSearcher
from fusion_tpu.serving import rerank_head_merge as jax_head_merge
from fusion_tpu_torch.core.ranked import RankedLists
from fusion_tpu_torch.models import convert
from fusion_tpu_torch.models.biencoder import BiEncoder
from fusion_tpu_torch.models.crossencoder import CrossEncoder
from fusion_tpu_torch.models.encoder import EncoderConfig
from fusion_tpu_torch.serving import HybridSearcher, rerank_head_merge

# five queries at batch 4: the second batch is a padded tail
SEARCH_QUERIES = QUERIES + ["loi consommateurs", "oiseaux forêt chantent"]
DEPTH, TOPK = 4, 8


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = JaxConfig.tiny(vocab_size=512), EncoderConfig.tiny(vocab_size=512)
    kw = dict(max_query_length=8, max_doc_length=16)
    jd = JaxBiEncoder(jcfg, head="dense", **kw)
    js = JaxBiEncoder(jcfg, head="splade", **kw)
    jce = JaxCrossEncoder(jcfg, max_length=48)
    td = BiEncoder(tcfg, params=convert.encoder_state_dict(jd.params), head="dense", device=DEVICE, **kw)
    ts = BiEncoder(tcfg, params=convert.encoder_with_mlm_state_dict(js.params), head="splade", device=DEVICE, **kw)
    tce = CrossEncoder(tcfg, params=convert.crossencoder_state_dict(jce.params), max_length=48, device=DEVICE)
    return (jd, js, jce), (td, ts, tce)


def _build(models, packed, **extra):
    (jd, js, jce), (td, ts, tce) = models
    common = dict(batch_size=4, topk=TOPK, rerank_depth=DEPTH, rerank_packed=packed, **extra)
    want = JaxSearcher.build(CORPUS, dense_model=jd, splade_model=js, cross_encoder=jce, **common)
    got = HybridSearcher.build(CORPUS, device=DEVICE, dense_model=td, splade_model=ts, cross_encoder=tce, **common)
    return want, got


@pytest.mark.parametrize("packed", [False, None], ids=["flat", "packed_default"])
def test_rerank_search_matches_jax(models, packed):
    want_s, got_s = _build(models, packed, **({"rerank_row_width": 128} if packed is None else {}))
    assert got_s.active_systems == want_s.active_systems == ["dpr", "splade", "monobert"]
    assert got_s.rerank_packed == want_s.rerank_packed == (packed is None)
    want, _ = want_s.search(SEARCH_QUERIES, batch_size=4, use_pallas=False)
    got, _ = got_s.search(SEARCH_QUERIES, batch_size=4)
    assert got.ids.dtype == torch.int32 and got.ids.shape == (len(SEARCH_QUERIES), TOPK)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-4, atol=1e-5)


def test_rerank_head_is_a_permutation_and_tail_is_kept(models):
    _, (td, ts, tce) = models
    kw = dict(device=DEVICE, dense_model=td, splade_model=ts, batch_size=4, topk=TOPK)
    base, _ = HybridSearcher.build(CORPUS, **kw).search(SEARCH_QUERIES, batch_size=4)
    for packed in (True, False):
        rr = HybridSearcher.build(CORPUS, cross_encoder=tce, rerank_depth=DEPTH, rerank_packed=packed, **kw)
        got, _ = rr.search(SEARCH_QUERIES, batch_size=4)
        b_ids, g_ids, g_scores = base.ids.numpy(), got.ids.numpy(), got.scores.numpy()
        for qi in range(len(SEARCH_QUERIES)):
            assert set(g_ids[qi, :DEPTH]) == set(b_ids[qi, :DEPTH])  # permutation of the head
            np.testing.assert_array_equal(g_ids[qi, DEPTH:], b_ids[qi, DEPTH:])  # tail kept
            np.testing.assert_array_equal(g_scores[qi, DEPTH:], base.scores.numpy()[qi, DEPTH:])
            row = g_scores[qi][np.isfinite(g_scores[qi])]
            assert np.all(np.diff(row) <= 0)  # the whole row descending
            assert g_scores[qi, 0] > g_scores[qi, DEPTH:].max()  # head above tail


def test_rerank_head_merge_matches_jax(rng):
    """Pads in the head, exact ties (equal logits keep head order), a
    finite and a -inf tail."""
    ids = np.array([[5, 3, 9, -1, 7, 2], [4, 1, 0, 8, -1, -1]], np.int32)
    scores = np.array([[0.9, 0.8, 0.7, -np.inf, 0.5, 0.4], [0.6, 0.5, 0.4, 0.3, -np.inf, -np.inf]], np.float32)
    head = ids[:, :4]
    logits = rng.normal(size=head.shape).astype(np.float32)
    logits[1, 1] = logits[1, 2] = logits[1, 0]
    w = jax_head_merge(JaxRanked(jnp.asarray(ids), jnp.asarray(scores)), jnp.asarray(head), jnp.asarray(logits))
    g = rerank_head_merge(RankedLists(torch.from_numpy(ids), torch.from_numpy(scores)),
                          torch.from_numpy(head), torch.from_numpy(logits))
    np.testing.assert_array_equal(g.ids.numpy(), np.asarray(w.ids))
    np.testing.assert_allclose(g.scores.numpy(), np.asarray(w.scores), rtol=0, atol=1e-7)


def test_packed_with_buckets_or_cascade_is_mutually_exclusive(models):
    _, (td, _, tce) = models
    kw = dict(device=DEVICE, dense_model=td, cross_encoder=tce, batch_size=4, topk=TOPK)
    for option in (dict(rerank_buckets=(8, 16)), dict(rerank_cascade=(2, 8))):
        with pytest.raises(ValueError, match="mutually exclusive"):
            HybridSearcher.build(CORPUS, rerank_packed=True, **option, **kw)
    assert HybridSearcher.build(CORPUS, **kw).rerank_packed


@pytest.mark.parametrize("option", [dict(rerank_buckets=(8, 16)), dict(rerank_cascade=(2, 8))])
def test_bucketed_and_cascade_stages_are_not_ported(models, option):
    """Both stages are ported: the searcher with each ranks as JAX's (more
    settings in test_torch_rerank_stages.py)."""
    want_s, got_s = _build(models, None, **option)
    assert not got_s.rerank_packed and not want_s.rerank_packed
    assert got_s.rerank_buckets == want_s.rerank_buckets and got_s.rerank_cascade == want_s.rerank_cascade
    want, _ = want_s.search(SEARCH_QUERIES, batch_size=4, use_pallas=False)
    got, _ = got_s.search(SEARCH_QUERIES, batch_size=4)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-4, atol=1e-5)
