"""The fusion_tpu_torch HybridSearcher in scale mode and with int8 corpora,
end to end against the JAX searcher: same corpus, queries and (converted)
weights, on the CPU, where both take the plain paths of the binned and
scatter scorers.

Tolerances: BM25 (impact index and int8 impacts) and the scatter / rescore
SPLADE leg at atol 1e-5 (f32 sums in another order); the legs that round an
f32 query to bf16 (int8 DPR and SPLADE, ColBERT) at atol 2^-8, since an ulp
of difference in the f32 query flips some of those roundings; ids equal
except that ids whose JAX scores lie within the tolerance of each other must
match as sets.  Where no leg reorders, the fused RRF lists match at 1e-6."""

import numpy as np
import pytest
import torch
from torch_parity import assert_ranked_match

from fusion_tpu.models.biencoder import BiEncoder as JaxBiEncoder
from fusion_tpu.models.colbert import ColBERT as JaxColBERT
from fusion_tpu.models.encoder import EncoderConfig as JaxConfig
from fusion_tpu.serving import HybridSearcher as JaxSearcher
from fusion_tpu_torch.index.dense_quant import QuantizedDenseIndex
from fusion_tpu_torch.index.inverted import ChunkedImpactIndex, ImpactIndex
from fusion_tpu_torch.models import convert
from fusion_tpu_torch.models.biencoder import BiEncoder
from fusion_tpu_torch.models.colbert import ColBERT
from fusion_tpu_torch.models.encoder import EncoderConfig
from fusion_tpu_torch.ops import dense_topk, scatter_score
from fusion_tpu_torch.serving import HybridSearcher

ATOL = {"bm25": 1e-5, "dpr": 2.0**-8, "splade": 1e-5, "colbert": 2.0**-8}
BF16_QUERY_ATOL = 2.0**-8

# the build options of each configuration; scale mode at this size needs a
# small impact cap so that Kq·cap_per_chunk fits the scatter layout
CONFIGS = {
    "scale_scatter": dict(
        scale_mode=True, int8_corpus=True, dense_impl="fused", splade_impl="scatter",
        impact_cap=48, splade_query_terms=16, splade_rescore_depth=24,
    ),
    "scale_impact": dict(
        scale_mode=True, int8_corpus=True, dense_impl="exact", splade_impl="impact",
        impact_cap=8, splade_query_terms=16, splade_prune_topk=32,
    ),
    "int8": dict(int8_corpus=True),
}


def _corpus(seed=3, n=61, vocab=90):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    docs = {
        100 + i: " ".join(f"w{t}" for t in rng.choice(vocab, size=rng.integers(4, 18), p=p))
        for i in range(n)
    }
    queries = [" ".join(f"w{t}" for t in rng.choice(vocab, size=3, p=p)) for _ in range(6)]
    return docs, queries + ["", "w7"]


CORPUS, QUERIES = _corpus()


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = JaxConfig.tiny(vocab_size=512), EncoderConfig.tiny(vocab_size=512)
    kw = dict(max_query_length=8, max_doc_length=24)
    jd = JaxBiEncoder(jcfg, head="dense", **kw)
    js = JaxBiEncoder(jcfg, head="splade", **kw)
    jc = JaxColBERT(jcfg, dim=16, **kw)
    td = BiEncoder(tcfg, params=convert.encoder_state_dict(jd.params), head="dense", **kw)
    ts = BiEncoder(tcfg, params=convert.encoder_with_mlm_state_dict(js.params), head="splade", **kw)
    tc = ColBERT(tcfg, params=convert.colbert_state_dict(jc.params), dim=16, **kw)
    return (jd, js, jc), (td, ts, tc)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def searchers(request, models):
    (jd, js, jc), (td, ts, tc) = models
    common = dict(bm25_docs=list(CORPUS.values()), batch_size=16, topk=20, **CONFIGS[request.param])
    want = JaxSearcher.build(CORPUS, dense_model=jd, splade_model=js, colbert_model=jc, **common)
    got = HybridSearcher.build(CORPUS, dense_model=td, splade_model=ts, colbert_model=tc, **common)
    return request.param, want, got


def _assert_int8_close(got, want):
    diff = np.abs(got.numpy().astype(np.int32) - np.asarray(want).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01, (diff.max(), (diff > 0).mean())


def test_build_forms(searchers):
    config, want, got = searchers
    assert got.active_systems == want.active_systems == ["bm25", "dpr", "splade", "colbert"]
    assert isinstance(got.dense_corpus, QuantizedDenseIndex)
    # the encoders agree to ~1e-6, so a stored value may round to its neighbour
    _assert_int8_close(got.dense_corpus.values, want.dense_corpus.values)
    if config == "int8":
        assert isinstance(got.bm25_impacts, QuantizedDenseIndex)
        _assert_int8_close(got.bm25_impacts.values, want.bm25_impacts.values)
        return
    assert isinstance(got.bm25_impact_index, ImpactIndex)
    np.testing.assert_array_equal(
        got.bm25_impact_index.post_doc.numpy(), np.asarray(want.bm25_impact_index.post_doc)
    )
    assert got.splade_rescore_depth == want.splade_rescore_depth
    sparse = got.splade_scatter_index if config == "scale_scatter" else got.splade_impact_index
    assert isinstance(sparse, ChunkedImpactIndex if config == "scale_scatter" else ImpactIndex)
    want_sparse = (
        want.splade_scatter_index if config == "scale_scatter" else want.splade_impact_index
    )
    assert sparse.post_doc.shape == want_sparse.post_doc.shape
    assert sparse.nnz_kept == want_sparse.nnz_kept


@pytest.mark.parametrize("system", ["bm25", "dpr", "splade", "colbert"])
def test_search_systems_leg_matches_jax(searchers, system):
    config, want_s, got_s = searchers
    want = want_s.search_systems(QUERIES, batch_size=4, use_pallas=False)[system]
    got = got_s.search_systems(QUERIES, batch_size=4)[system]
    # outside scale mode the SPLADE leg is the int8 cosine matrix
    atol = BF16_QUERY_ATOL if (config, system) == ("int8", "splade") else ATOL[system]
    # a bf16 rounding may also move a doc across the depth cut
    cut_ties = atol == BF16_QUERY_ATOL
    assert_ranked_match(got.ids, got.scores, want.ids, want.scores, atol=atol, cut_ties=cut_ties)


def test_fused_search_matches_jax(searchers):
    config, want_s, got_s = searchers
    before = (dense_topk.binmax_cuda.launches, scatter_score.scatter_binmax_cuda.launches)
    want, _ = want_s.search(QUERIES, batch_size=4, use_pallas=False)
    got, ms = got_s.search(QUERIES, batch_size=4)
    assert got.ids.dtype == torch.int32 and got.ids.shape == (len(QUERIES), 20) and ms > 0
    if config == "int8":
        # the int8 SPLADE leg reorders near-ties (see above), which shifts
        # RRF ranks: hold the fusion to the port's own legs, and the lists to
        # JAX by overlap
        legs = got_s.search_systems(QUERIES, batch_size=4, external_ids=False)
        fused = got_s._fuse(legs).remap_ids(got_s.corpus_ids)
        np.testing.assert_array_equal(got.ids.numpy(), fused.ids.numpy())
        np.testing.assert_array_equal(got.scores.numpy(), fused.scores.numpy())
        overlap = np.mean([len(set(a) & set(b)) / len(a) for a, b in zip(got.ids.tolist(), want.ids.tolist())])
        assert overlap >= 0.9, overlap
    else:
        # RRF scores are rank reciprocals, exact where no leg reorders
        assert_ranked_match(got.ids, got.scores, want.ids, want.scores, atol=1e-6)
    # on the CPU the kernels are never launched
    assert before == (dense_topk.binmax_cuda.launches, scatter_score.scatter_binmax_cuda.launches)


def test_auto_impls_take_the_exact_paths_on_the_cpu(models):
    _, (td, ts, _) = models
    got = HybridSearcher.build(
        CORPUS, dense_model=td, splade_model=ts, scale_mode=True, int8_corpus=True, topk=5,
    )
    assert not got._dense_fused_active()
    assert got.splade_scatter_index is None and got.splade_impact_index is not None
    with pytest.raises(ValueError, match="scatter"):
        HybridSearcher.build(CORPUS, splade_model=ts, scale_mode=True, splade_impl="scatter")


@pytest.mark.parametrize("option", ["colbert_plaid", "colbert_compressed"])
def test_colbert_scale_forms_still_raise(option):
    with pytest.raises(NotImplementedError, match="next slice"):
        HybridSearcher.build(CORPUS, bm25_docs=list(CORPUS.values()), scale_mode=True, **{option: True})
