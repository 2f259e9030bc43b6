"""The fusion_tpu_torch HybridSearcher with compressed and PLAID ColBERT,
end to end against the JAX searcher on the CPU: the same corpus, queries and
(converted) weights, and the JAX searcher's own compressed index and IVF
converted into the port (the two packages' k-means draw different numbers,
so each package's own build gives a different index).

Tolerances: the ColBERT leg rounds f32 query tokens to bf16 in both
packages, and an ulp of difference between the encoders flips some of those
roundings, so its scores agree to 2^-8 (ids equal except within ties at that
tolerance, and across the depth cut); BM25 and SPLADE at 1e-5 as in
test_torch_serving_scale.py."""

import numpy as np
import pytest
import torch
from torch_parity import DEVICE, assert_ranked_match

from fusion_tpu.models.biencoder import BiEncoder as JaxBiEncoder
from fusion_tpu.models.colbert import ColBERT as JaxColBERT
from fusion_tpu.models.encoder import EncoderConfig as JaxConfig
from fusion_tpu.serving import HybridSearcher as JaxSearcher
from fusion_tpu_torch.index.compression import (
    CompressedTokenIndex,
    maxsim_search_compressed,
)
from fusion_tpu_torch.index.plaid import IVFIndex, plaid_search
from fusion_tpu_torch.models import convert
from fusion_tpu_torch.models.biencoder import BiEncoder
from fusion_tpu_torch.models.colbert import ColBERT
from fusion_tpu_torch.models.encoder import EncoderConfig
from fusion_tpu_torch.ops import gather_rows
from fusion_tpu_torch.serving import HybridSearcher

ATOL = {"bm25": 1e-5, "splade": 1e-5, "colbert": 2.0**-8}
CONFIGS = {
    "plaid": dict(colbert_compressed=True, colbert_plaid=True, plaid_topk_impl="exact"),
    "plaid_factored_pruned": dict(
        colbert_compressed=True, colbert_plaid=True, plaid_topk_impl="exact",
        plaid_rescore_impl="factored", plaid_ncand_rescore=64, plaid_ncand=128, ivf_cap=16,
    ),
    "compressed": dict(colbert_compressed=True),
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
    js = JaxBiEncoder(jcfg, head="splade", **kw)
    jc = JaxColBERT(jcfg, dim=16, **kw)
    ts = BiEncoder(tcfg, params=convert.encoder_with_mlm_state_dict(js.params), head="splade", device=DEVICE, **kw)
    tc = ColBERT(tcfg, params=convert.colbert_state_dict(jc.params), dim=16, device=DEVICE, **kw)
    return (js, jc), (ts, tc)


def _converted(want: JaxSearcher):
    ci, ivf = want.colbert_index, want.colbert_ivf
    return convert.plaid_index_from_arrays(
        ci.centroids, ci.centroid_ids, ci.codes, ci.mask, ci.bucket_weights, ci.nbits,
        ivf_doc=None if ivf is None else ivf.ivf_doc,
        n_docs=None if ivf is None else ivf.n_docs, cap=None if ivf is None else ivf.cap,
        device=DEVICE,
    )


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def searchers(request, models):
    """The JAX searcher and the port's, the port's ColBERT index replaced by
    the conversion of JAX's."""
    (js, jc), (ts, tc) = models
    opts = CONFIGS[request.param]
    common = dict(bm25_docs=list(CORPUS.values()), batch_size=16, topk=20, scale_mode=True,
                  impact_cap=8, splade_impl="impact", splade_query_terms=16, splade_prune_topk=32)
    want = JaxSearcher.build(CORPUS, splade_model=js, colbert_model=jc, **common, **opts)
    got = HybridSearcher.build(CORPUS, device=DEVICE, splade_model=ts, colbert_model=tc, **common, **opts)
    got.colbert_index, got.colbert_ivf = _converted(want)
    return request.param, want, got


def test_build_defaults_are_the_jax_searcher_s():
    import inspect

    port = inspect.signature(HybridSearcher.build).parameters
    ref = inspect.signature(JaxSearcher.build).parameters
    for name in ("colbert_compressed", "colbert_nbits", "colbert_plaid", "plaid_nprobe",
                 "plaid_ncand", "plaid_ncand_rescore", "plaid_rescore_impl", "plaid_topk_impl",
                 "ivf_cap"):
        assert port[name].default == ref[name].default, name
    # the one difference: the port picks the gather by device
    assert port["plaid_gather_impl"].default == "auto"


def test_build_forms_and_defaults(searchers):
    config, want, got = searchers
    assert got.active_systems == want.active_systems == ["bm25", "splade", "colbert"]
    assert isinstance(got.colbert_index, CompressedTokenIndex)
    assert (got.colbert_ivf is None) == (config == "compressed")
    for knob in ("plaid_nprobe", "plaid_ncand", "plaid_ncand_rescore", "plaid_rescore_impl"):
        assert getattr(got, knob) == getattr(want, knob), knob


@pytest.mark.parametrize("system", ["bm25", "splade", "colbert"])
def test_search_systems_leg_matches_jax(searchers, system):
    _, want_s, got_s = searchers
    want = want_s.search_systems(QUERIES, batch_size=4, use_pallas=False)[system]
    got = got_s.search_systems(QUERIES, batch_size=4)[system]
    atol = ATOL[system]
    assert_ranked_match(got.ids, got.scores, want.ids, want.scores, atol=atol,
                        cut_ties=atol == ATOL["colbert"])


def test_fused_search_matches_jax(searchers):
    _, want_s, got_s = searchers
    before = gather_rows.gather_rows_cuda.launches
    want, _ = want_s.search(QUERIES, batch_size=4, use_pallas=False)
    got, ms = got_s.search(QUERIES, batch_size=4)
    assert got.ids.dtype == torch.int32 and got.ids.shape == (len(QUERIES), 20) and ms > 0
    # a ColBERT near-tie may reorder (see above) and shift RRF ranks: hold the
    # fusion to the port's own legs, and the lists to JAX by overlap
    legs = got_s.search_systems(QUERIES, batch_size=4, external_ids=False)
    fused = got_s._fuse(legs).remap_ids(got_s.corpus_ids)
    np.testing.assert_array_equal(got.ids.numpy(), fused.ids.numpy())
    overlap = np.mean([len(set(a) & set(b)) / len(a) for a, b in zip(got.ids.tolist(), want.ids.tolist())])
    assert overlap >= 0.9, overlap
    assert gather_rows.gather_rows_cuda.launches == before  # never on the CPU


@pytest.fixture(scope="module")
def own_builds(models):
    """The port's own build of the compressed index, with and without PLAID,
    beside its bf16 token index."""
    _, (_, tc) = models
    kw = dict(colbert_model=tc, topk=20, batch_size=16)
    return {
        "tokens": HybridSearcher.build(CORPUS, device=DEVICE, **kw),
        "compressed": HybridSearcher.build(CORPUS, device=DEVICE, colbert_compressed=True, **kw),
        "plaid": HybridSearcher.build(CORPUS, device=DEVICE, colbert_compressed=True, colbert_plaid=True,
                                      ivf_cap=64, **kw),
    }


@pytest.mark.parametrize("form", ["compressed", "plaid"])
def test_own_build_serves_the_leg(own_builds, form):
    searcher = own_builds[form]
    index = searcher.colbert_index
    assert isinstance(index, CompressedTokenIndex) and index.nbits == 2
    n = index.num_docs
    assert index.codes.shape == (n, 24, 4) and int(index.centroid_ids.max()) < index.centroids.shape[0]
    assert set(searcher.build_seconds) == {"colbert_encode", "colbert_kmeans", "colbert_compress"} | (
        {"colbert_ivf"} if form == "plaid" else set()
    )
    ranked = searcher.search_systems(QUERIES, batch_size=4, external_ids=False)["colbert"]
    inputs = searcher._prepare_inputs(QUERIES)
    q_tok = searcher.colbert_model.embed_tokens(inputs["cb_ids"], inputs["cb_mask"])
    q_mask = inputs["cb_mask"].float()
    if form == "plaid":
        ivf = searcher.colbert_ivf
        assert isinstance(ivf, IVFIndex) and ivf.cap == 64 and ivf.n_docs == n
        rows = ivf.ivf_doc.numpy()
        for row in rows:  # duplicate-free lists, as plaid_candidates needs
            real = row[row < n]
            assert len(set(real.tolist())) == len(real)
        want = plaid_search(q_tok.float(), q_mask, index, ivf, k=20, ncand=min(1024, n),
                            ncand_rescore=None)
    else:
        want = maxsim_search_compressed(q_tok, q_mask, index, k=20)
    np.testing.assert_array_equal(ranked.ids.numpy(), want.ids.numpy())
    np.testing.assert_array_equal(ranked.scores.numpy(), want.scores.numpy())


def test_own_compressed_build_ranks_like_the_token_index(own_builds):
    """2-bit residuals keep most of the bf16 token index's top-5 (a quality
    check of the port's own k-means and codec, not a parity check)."""
    legs = {
        form: own_builds[form].search_systems(QUERIES[:6], batch_size=4)["colbert"].ids.numpy()
        for form in ("tokens", "compressed")
    }
    overlap = np.mean([len(set(a[:5]) & set(b[:5])) / 5 for a, b in zip(legs["tokens"], legs["compressed"])])
    assert overlap >= 0.6, overlap


@pytest.mark.parametrize(
    "bad,match",
    [
        (dict(colbert_plaid=True), "colbert_compressed"),
        (dict(colbert_compressed=True, plaid_gather_impl="pallas_interpret"), "by device"),
        (dict(colbert_compressed=True, plaid_gather_impl="xla"), "by device"),
        (dict(colbert_compressed=True, plaid_rescore_impl="fused"), "plaid_rescore_impl"),
        (dict(colbert_compressed=True, plaid_topk_impl="fast"), "plaid_topk_impl"),
    ],
)
def test_bad_colbert_options_raise(bad, match):
    with pytest.raises(ValueError, match=match):
        HybridSearcher.build(CORPUS, device=DEVICE, bm25_docs=list(CORPUS.values()), **bad)
