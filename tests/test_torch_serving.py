"""The fusion_tpu_torch HybridSearcher slice end to end against the JAX
searcher: same corpus, queries and (converted) weights, four systems, RRF.

Scores must match at atol 1e-6; ids must be equal, except that ids whose JAX
scores lie within 1e-6 of each other must match as sets."""

import os
import subprocess
import sys

import pytest
import torch
from test_serving import CORPUS, QUERIES
from torch_parity import assert_ranked_match

from fusion_tpu.data.preprocessor import TextPreprocessor
from fusion_tpu.models.biencoder import BiEncoder as JaxBiEncoder
from fusion_tpu.models.colbert import ColBERT as JaxColBERT
from fusion_tpu.models.encoder import EncoderConfig as JaxConfig
from fusion_tpu.serving import HybridSearcher as JaxSearcher
from fusion_tpu_torch.models import convert
from fusion_tpu_torch.models.biencoder import BiEncoder
from fusion_tpu_torch.models.colbert import ColBERT
from fusion_tpu_torch.models.encoder import EncoderConfig
from fusion_tpu_torch.serving import HybridSearcher

ATOL = 1e-6
# five queries at batch 4: the second batch is a padded tail
SEARCH_QUERIES = QUERIES + ["loi consommateurs", "oiseaux forêt chantent"]


@pytest.fixture(scope="module")
def searchers():
    jcfg, tcfg = JaxConfig.tiny(vocab_size=512), EncoderConfig.tiny(vocab_size=512)
    kw = dict(max_query_length=8, max_doc_length=16)
    jd = JaxBiEncoder(jcfg, head="dense", **kw)
    js = JaxBiEncoder(jcfg, head="splade", **kw)
    jc = JaxColBERT(jcfg, dim=16, **kw)
    td = BiEncoder(tcfg, params=convert.encoder_state_dict(jd.params), head="dense", **kw)
    ts = BiEncoder(tcfg, params=convert.encoder_with_mlm_state_dict(js.params), head="splade", **kw)
    tc = ColBERT(tcfg, params=convert.colbert_state_dict(jc.params), dim=16, **kw)
    prep = TextPreprocessor(spacy_model=None)
    common = dict(
        bm25_docs=prep.preprocess(list(CORPUS.values())),
        batch_size=4,
        topk=8,
        bm25_preprocess=lambda texts: prep.preprocess(list(texts)),
    )
    want = JaxSearcher.build(CORPUS, dense_model=jd, splade_model=js, colbert_model=jc, **common)
    got = HybridSearcher.build(CORPUS, dense_model=td, splade_model=ts, colbert_model=tc, **common)
    return want, got


def test_search_matches_jax(searchers):
    want_s, got_s = searchers
    assert got_s.active_systems == want_s.active_systems == ["bm25", "dpr", "splade", "colbert"]
    want, _ = want_s.search(SEARCH_QUERIES, batch_size=4, use_pallas=False)
    got, ms = got_s.search(SEARCH_QUERIES, batch_size=4)
    assert got.ids.dtype == torch.int32 and got.ids.shape == (len(SEARCH_QUERIES), 8)
    assert ms > 0
    assert_ranked_match(got.ids, got.scores, want.ids, want.scores, atol=ATOL)


@pytest.mark.parametrize("system", ["bm25", "dpr", "splade", "colbert"])
def test_search_systems_leg_matches_jax(searchers, system):
    want_s, got_s = searchers
    want = want_s.search_systems(SEARCH_QUERIES, batch_size=4, use_pallas=False)[system]
    got = got_s.search_systems(SEARCH_QUERIES, batch_size=4)[system]
    assert_ranked_match(got.ids, got.scores, want.ids, want.scores, atol=ATOL)


@pytest.mark.parametrize(
    "option",
    [
        dict(scale_mode=True, colbert_compressed=True, colbert_plaid=True),
        dict(int8_corpus=True, colbert_compressed=True),
        dict(colbert_compressed=True),
        dict(colbert_plaid=True),
        dict(cross_encoder=object()),
        dict(encoders_int8=True),
        dict(fusion_method="nsf", normalization="percentile-rank"),
    ],
)
def test_unported_build_options_raise(option):
    with pytest.raises(NotImplementedError):
        HybridSearcher.build(CORPUS, bm25_docs=list(CORPUS.values()), **option)


def test_persistence_is_not_ported(searchers):
    _, got_s = searchers
    with pytest.raises(NotImplementedError):
        got_s.save_indexes("unused")


def test_serving_import_leaves_jax_out():
    code = (
        "import sys; import fusion_tpu_torch.serving; "
        "print(sorted(m for m in ('jax', 'flax', 'fusion_tpu') if m in sys.modules))"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=repo
    )
    assert out.stdout.strip() == "[]"
