"""Index persistence between the JAX package and fusion_tpu_torch.

Every index class writes the JAX package's file names, ``.npz`` keys and
dtypes, so a directory written by either package loads in the other: each
class is saved by one package and loaded by both, and the two loads are
held equal array for array (exactly; where the format rounds through f16,
both loads see the same rounding).  The three searcher forms (the default
four legs with the cross-encoder's tokens and percentile tables; scale mode
with int8, scatter and rescore; PLAID) are saved by one package and served
by the other, and held to the JAX searcher's lists under the tolerances of
test_torch_serving.py, test_torch_serving_scale.py and
test_torch_serving_plaid.py, each form at that test's configuration: the
default form's legs at 1e-6 and its reranked fused lists with equal ids and
scores within rtol 1e-4 / atol 1e-5 (test_torch_serving_rerank.py); in
scale mode BM25 and SPLADE at 1e-5, and the legs that round an f32 query to
bf16 (int8 DPR, ColBERT) at 2^-8, ids equal except within ties at that
tolerance and across the depth cut."""

import numpy as np
import pytest
import torch
from test_serving import CORPUS as SERVING_CORPUS
from test_serving import QUERIES as _SERVING_QUERIES
from torch_parity import DEVICE, assert_ranked_match

from fusion_tpu.data.preprocessor import TextPreprocessor as JaxPreprocessor
from fusion_tpu.index import compression as jax_compression
from fusion_tpu.index import dense_quant as jax_dense_quant
from fusion_tpu.index import inverted as jax_inverted
from fusion_tpu.index import plaid as jax_plaid
from fusion_tpu.index import sparse as jax_sparse
from fusion_tpu.models.biencoder import BiEncoder as JaxBiEncoder
from fusion_tpu.models.bm25 import BM25Index as JaxBM25
from fusion_tpu.models.colbert import ColBERT as JaxColBERT
from fusion_tpu.models.colbert import TokenIndex as JaxTokenIndex
from fusion_tpu.models.crossencoder import CrossEncoder as JaxCrossEncoder
from fusion_tpu.models.encoder import EncoderConfig as JaxConfig
from fusion_tpu.serving import HybridSearcher as JaxSearcher
from fusion_tpu_torch.index import compression, dense_quant, inverted, plaid, sparse
from fusion_tpu_torch.models import convert
from fusion_tpu_torch.models.biencoder import BiEncoder
from fusion_tpu_torch.models.bm25 import BM25Index
from fusion_tpu_torch.models.colbert import ColBERT, TokenIndex
from fusion_tpu_torch.models.crossencoder import CrossEncoder
from fusion_tpu_torch.models.encoder import EncoderConfig
from fusion_tpu_torch.serving import HybridSearcher


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
DOCS = list(CORPUS.values())
# five queries at batch 4: the second batch is a padded tail
SERVING_QUERIES = _SERVING_QUERIES + ["loi consommateurs", "oiseaux forêt chantent"]
V = 50  # the sparse indexes' vocabulary


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _activations(seed=5, n=40, v=V):
    rng = np.random.default_rng(seed)
    acts = np.maximum(rng.normal(size=(n, v)), 0).astype(np.float32) * (rng.random((n, v)) < 0.3)
    return acts


def _tokens(seed=6, n=30, ld=6, d=16):
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(n, ld, d)).astype(np.float32)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    mask = (rng.random((n, ld)) < 0.8).astype(np.float32)
    mask[:, 0] = 1.0
    return t, mask


# per class: (JAX object, port object, JAX load, port load, fields compared)
def _bm25():
    return (JaxBM25.build(DOCS, k1=1.2, b=0.7), BM25Index.build(DOCS, k1=1.2, b=0.7, device=DEVICE),
            JaxBM25.load, lambda p: BM25Index.load(p, device=DEVICE),
            ("entry_term", "entry_doc", "entry_tf", "idf", "doc_len", "n_docs", "nnz", "k1", "b", "avgdl",
             "vocab", "variant"))


def _impact():
    jb, tb = JaxBM25.build(DOCS), BM25Index.build(DOCS, device=DEVICE)
    return (jb.to_impact_index(cap=8), tb.to_impact_index(cap=8), jax_inverted.ImpactIndex.load,
            lambda p: inverted.ImpactIndex.load(p, device=DEVICE),
            ("post_doc", "post_impact", "n_docs", "vocab_size", "cap", "nnz_kept", "term_df"))


def _sparse_pair(prune_topk=8):
    acts = _activations()
    js = jax_sparse.build_sparse_index(iter([acts[:20], acts[20:]]), vocab_size=V, prune_topk=prune_topk)
    ts = sparse.build_sparse_index(iter([acts[:20], acts[20:]]), vocab_size=V, prune_topk=prune_topk, device=DEVICE)
    return js, ts


def _chunked():
    js, ts = _sparse_pair()
    return (jax_inverted.sparse_to_chunked_impact_index(js, docs_per_chunk=16, cap_per_chunk=4),
            inverted.sparse_to_chunked_impact_index(ts, docs_per_chunk=16, cap_per_chunk=4),
            jax_inverted.ChunkedImpactIndex.load, lambda p: inverted.ChunkedImpactIndex.load(p, device=DEVICE),
            ("post_doc", "post_impact", "n_docs", "docs_per_chunk", "vocab_size", "cap_per_chunk", "nnz_kept"))


def _quantized():
    x = np.random.default_rng(7).normal(size=(25, 12)).astype(np.float32)
    return (jax_dense_quant.quantize_dense_index(x), dense_quant.quantize_dense_index(torch.from_numpy(x)),
            jax_dense_quant.QuantizedDenseIndex.load, lambda p: dense_quant.QuantizedDenseIndex.load(p, device=DEVICE),
            ("values", "scales", "normalized"))


def _sparse_index():
    js, ts = _sparse_pair()
    return (js, ts, jax_sparse.SparseIndex.load, lambda p: sparse.SparseIndex.load(p, device=DEVICE),
            ("entry_term", "entry_weight", "n_docs", "vocab_size", "nnz"))


def _rescore():
    js, ts = _sparse_pair()
    return (jax_sparse.build_rescore_store(js), sparse.build_rescore_store(ts), jax_sparse.SpladeRescoreStore.load,
            lambda p: sparse.SpladeRescoreStore.load(p, device=DEVICE), ("packed", "n_docs", "vocab_size", "prune_topk"))


def _compressed():
    t, m = _tokens()
    return (jax_compression.compress_token_index(t, m, num_centroids=8, nbits=2),
            compression.compress_token_index(torch.from_numpy(t), torch.from_numpy(m), num_centroids=8, nbits=2),
            jax_compression.CompressedTokenIndex.load, lambda p: compression.CompressedTokenIndex.load(p, device=DEVICE),
            ("centroids", "centroid_ids", "codes", "mask", "bucket_weights", "nbits"))


def _ivf():
    rng = np.random.default_rng(8)
    cid = rng.integers(0, 8, size=(30, 6)).astype(np.int32)
    _, m = _tokens()
    return (jax_plaid.build_ivf(cid, m, 8, cap=5), plaid.build_ivf(cid, m, 8, cap=5, device=DEVICE),
            jax_plaid.IVFIndex.load, lambda p: plaid.IVFIndex.load(p, device=DEVICE), ("ivf_doc", "n_docs", "cap"))


def _token_index():
    t, m = _tokens()
    import jax.numpy as jnp

    return (JaxTokenIndex(jnp.asarray(t, jnp.bfloat16), jnp.asarray(m)),
            TokenIndex(torch.from_numpy(t).to(torch.bfloat16), torch.from_numpy(m)),
            JaxTokenIndex.load, lambda p: TokenIndex.load(p, device=DEVICE), ("tokens", "mask"))


INDEXES = {
    "BM25Index": _bm25, "ImpactIndex": _impact, "ChunkedImpactIndex": _chunked,
    "QuantizedDenseIndex": _quantized, "SparseIndex": _sparse_index, "SpladeRescoreStore": _rescore,
    "CompressedTokenIndex": _compressed, "IVFIndex": _ivf, "TokenIndex": _token_index,
}


def _value(obj, field):
    v = getattr(obj, field)
    if v is None or isinstance(v, (int, float, bool, str, dict)):
        return v
    if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
        return v.float().numpy()
    arr = _host(v)
    if arr.dtype == np.int16:  # the port's uint16 ids held as int16 bits
        arr = arr.view(np.uint16)
    return arr.astype(np.float32) if arr.dtype.name == "bfloat16" else arr


def _assert_same(got, want, fields):
    for field in fields:
        g, w = _value(got, field), _value(want, field)
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray), field
            np.testing.assert_array_equal(g.astype(w.dtype) if g.dtype != w.dtype and field == "mask" else g, w,
                                          err_msg=field)
            if field != "mask":  # a compressed index built by the port may hold an f32 or u8 mask
                assert g.dtype == w.dtype, (field, g.dtype, w.dtype)
        else:
            assert g == w, (field, g, w)


@pytest.mark.parametrize("name", sorted(INDEXES))
def test_jax_saved_index_loads_in_the_port(name, tmp_path):
    jax_obj, _, jax_load, port_load, fields = INDEXES[name]()
    jax_obj.save(str(tmp_path))
    _assert_same(port_load(str(tmp_path)), jax_load(str(tmp_path)), fields)


@pytest.mark.parametrize("name", sorted(INDEXES))
def test_port_saved_index_loads_in_jax(name, tmp_path):
    _, port_obj, jax_load, port_load, fields = INDEXES[name]()
    port_obj.save(str(tmp_path))
    loaded = port_load(str(tmp_path))
    _assert_same(loaded, jax_load(str(tmp_path)), fields)
    # every array the format does not round through f16 comes back as saved
    rounded = {("TokenIndex", "tokens"), ("CompressedTokenIndex", "centroids"), ("SparseIndex", "entry_weight")}
    exact = [f for f in fields if (name, f) not in rounded]
    _assert_same(loaded, port_obj, exact)


def test_f16_stored_arrays_are_the_f16_rounding(tmp_path):
    _, port_obj, _, port_load, _ = _token_index()
    port_obj.save(str(tmp_path))
    got = port_load(str(tmp_path))
    assert torch.equal(got.tokens, port_obj.tokens.to(torch.float16).to(torch.bfloat16))


# ----------------------------------------------------------------------
# searchers in three forms, saved by one package and served by the other,
# each at the configuration (corpus, widths, options) of the searcher test
# that holds the form to the JAX package
# ----------------------------------------------------------------------
PREP = JaxPreprocessor(spacy_model=None)
FORMS = {
    # test_torch_serving.py + test_torch_serving_rerank.py
    "default": dict(corpus=SERVING_CORPUS, queries=SERVING_QUERIES, doc_len=16, topk=8, batch=4,
                    legs=("dense", "splade", "colbert", "ce"),
                    opts=dict(bm25_docs=PREP.preprocess(list(SERVING_CORPUS.values())),
                              bm25_preprocess=lambda texts: PREP.preprocess(list(texts)),
                              rerank_depth=4, rerank_row_width=128)),
    # test_torch_serving_scale.py, "scale_scatter"
    "scale": dict(corpus=CORPUS, queries=QUERIES, doc_len=24, topk=20, batch=16, legs=("dense", "splade", "colbert"),
                  opts=dict(bm25_docs=DOCS, scale_mode=True, int8_corpus=True, dense_impl="fused",
                            splade_impl="scatter", impact_cap=48, splade_query_terms=16, splade_rescore_depth=24)),
    # test_torch_serving_plaid.py, "plaid"
    "plaid": dict(corpus=CORPUS, queries=QUERIES, doc_len=24, topk=20, batch=16, legs=("splade", "colbert"),
                  opts=dict(bm25_docs=DOCS, scale_mode=True, impact_cap=8, splade_impl="impact",
                            splade_query_terms=16, splade_prune_topk=32, colbert_compressed=True,
                            colbert_plaid=True)),
}
LEG_ATOL = {
    "default": {"bm25": 1e-6, "dpr": 1e-6, "splade": 1e-6, "colbert": 1e-6},
    "scale": {"bm25": 1e-5, "dpr": 2.0**-8, "splade": 1e-5, "colbert": 2.0**-8},
    "plaid": {"bm25": 1e-5, "splade": 1e-5, "colbert": 2.0**-8},
}


def _models(doc_len: int):
    jcfg, tcfg = JaxConfig.tiny(vocab_size=512), EncoderConfig.tiny(vocab_size=512)
    kw = dict(max_query_length=8, max_doc_length=doc_len)
    jd, js = JaxBiEncoder(jcfg, head="dense", **kw), JaxBiEncoder(jcfg, head="splade", **kw)
    jc, jx = JaxColBERT(jcfg, dim=16, **kw), JaxCrossEncoder(jcfg, max_length=48)
    td = BiEncoder(tcfg, params=convert.encoder_state_dict(jd.params), head="dense", device=DEVICE, **kw)
    ts = BiEncoder(tcfg, params=convert.encoder_with_mlm_state_dict(js.params), head="splade", device=DEVICE, **kw)
    tc = ColBERT(tcfg, params=convert.colbert_state_dict(jc.params), dim=16, device=DEVICE, **kw)
    tx = CrossEncoder(tcfg, params=convert.crossencoder_state_dict(jx.params), max_length=48, device=DEVICE)
    return {"dense": jd, "splade": js, "colbert": jc, "ce": jx}, {"dense": td, "splade": ts, "colbert": tc, "ce": tx}


def _model_kw(form: str, models: dict) -> dict:
    names = {"dense": "dense_model", "splade": "splade_model", "colbert": "colbert_model", "ce": "cross_encoder"}
    return {names[leg]: models[leg] for leg in FORMS[form]["legs"]}


def _fresh(jax_side: bool, form: str, models: dict):
    """An empty searcher of ``form``'s models and serving options, for
    ``load_indexes``."""
    f = FORMS[form]
    opts = f["opts"]
    kw = dict(corpus_ids=np.array([]), topk=f["topk"], **_model_kw(form, models))
    for key in ("bm25_preprocess", "rerank_depth", "rerank_row_width", "dense_impl", "splade_query_terms",
                "splade_rescore_depth"):
        if key in opts:
            kw[key] = opts[key]
    if "ce" in f["legs"]:
        kw["rerank_packed"] = True
    if form == "plaid" and jax_side:
        kw["plaid_topk_impl"] = "exact"  # every PLAID select in the port is exact
    return JaxSearcher(**kw) if jax_side else HybridSearcher(device=DEVICE, **kw)


def _save_pair(form, tmp_path_factory):
    """(form, JAX models, port models, a directory the JAX package wrote, the
    port's searcher, a directory the port wrote)."""
    f = FORMS[form]
    jax_models, port_models = _models(f["doc_len"])
    common = dict(batch_size=f["batch"], topk=f["topk"], **f["opts"])
    want = JaxSearcher.build(f["corpus"], **common, **_model_kw(form, jax_models),
                             **({"plaid_topk_impl": "exact"} if form == "plaid" else {}))
    got = HybridSearcher.build(f["corpus"], device=DEVICE, **common, **_model_kw(form, port_models))
    if form == "default":
        want.build_percentile_distributions(f["queries"], num_points=50, batch_size=4, use_pallas=False)
        got.build_percentile_distributions(f["queries"], num_points=50, batch_size=4)
    jax_dir, port_dir = tmp_path_factory.mktemp(f"jax_{form}"), tmp_path_factory.mktemp(f"port_{form}")
    want.save_indexes(str(jax_dir))
    got.save_indexes(str(port_dir))
    return form, jax_models, port_models, str(jax_dir), got, str(port_dir), want


@pytest.fixture(scope="module", params=sorted(FORMS))
def saved(request, tmp_path_factory):
    return _save_pair(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def saved_default(tmp_path_factory):
    """The default form, which carries the cross-encoder's tokens and the
    percentile tables."""
    return _save_pair("default", tmp_path_factory)


def _legs(searcher, form, jax_side):
    kw = {"use_pallas": False} if jax_side else {}
    return searcher.search_systems(FORMS[form]["queries"], batch_size=4, **kw)


def _fused(searcher, form, jax_side):
    kw = {"use_pallas": False} if jax_side else {}
    return searcher.search(FORMS[form]["queries"], batch_size=4, **kw)[0]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_directory_served_by_both_packages(saved, writer):
    """One directory, written by either package, served by a fresh JAX
    searcher and a fresh port searcher: the same lists per leg, and for the
    default form the same reranked fused lists (ids equal, scores within
    rtol 1e-4 / atol 1e-5, the rerank test's bound)."""
    form, jax_models, port_models, jax_dir, _, port_dir, _ = saved
    path = jax_dir if writer == "jax" else port_dir
    want = _fresh(True, form, jax_models).load_indexes(path)
    got = _fresh(False, form, port_models).load_indexes(path)
    assert got.active_systems == want.active_systems
    want_legs, got_legs = _legs(want, form, True), _legs(got, form, False)
    assert sorted(got_legs) == sorted(want_legs)
    for system, w in want_legs.items():
        g = got_legs[system]
        atol = LEG_ATOL[form][system]
        assert_ranked_match(g.ids, g.scores, w.ids, w.scores, atol=atol, cut_ties=atol == 2.0**-8)
    if form == "default":
        assert got.active_systems[-1] == "monobert"
        w, g = _fused(want, form, True), _fused(got, form, False)
        np.testing.assert_array_equal(g.ids.numpy(), np.asarray(w.ids))
        np.testing.assert_allclose(g.scores.numpy(), np.asarray(w.scores), rtol=1e-4, atol=1e-5)


def test_port_directory_reloads_in_the_port(saved):
    """The port's own round trip: a fresh searcher over the port's directory
    gives the in-memory searcher's BM25 lists bit for bit (its arrays
    round-trip exactly) and the other legs' within 2^-8 (the f16 rounding
    of the bf16 matrices and of the compressed index's centroids)."""
    form, _, port_models, _, got, port_dir, _ = saved
    again = _fresh(False, form, port_models).load_indexes(port_dir)
    reloaded = _legs(again, form, False)
    for system, w in _legs(got, form, False).items():
        g = reloaded[system]
        if system == "bm25":
            assert torch.equal(g.ids, w.ids) and torch.equal(g.scores, w.scores)
        else:
            assert_ranked_match(g.ids, g.scores, w.ids, w.scores, atol=2.0**-8, cut_ties=True)


@pytest.mark.parametrize("norm", ["percentile-rank", "normal-curve-equivalent"])
def test_percentile_nsf_serves_from_a_saved_directory(saved_default, norm):
    """NSF's percentile normalizations read the directory's tables, in both
    packages alike: the fused lists of a JAX-written directory at 1e-5."""
    form, jax_models, port_models, jax_dir, _, _, _ = saved_default
    w_s, g_s = _fresh(True, form, jax_models), _fresh(False, form, port_models)
    for s in (w_s, g_s):
        s.fusion_method, s.normalization, s.rerank_depth = "nsf", norm, 0
        s.load_indexes(jax_dir)
    assert g_s.percentile_distributions is not None
    w, g = _fused(w_s, form, True), _fused(g_s, form, False)
    assert_ranked_match(g.ids, g.scores, w.ids, w.scores, atol=1e-5)


def test_ce_tokens_and_tables_round_trip(saved_default):
    form, _, port_models, jax_dir, got, port_dir, want = saved_default
    a = _fresh(False, form, port_models).load_indexes(jax_dir)
    b = _fresh(False, form, port_models).load_indexes(port_dir)
    for loaded in (a, b):
        np.testing.assert_array_equal(loaded.ce_doc_tokens.numpy(), got.ce_doc_tokens.numpy())
        np.testing.assert_array_equal(loaded.ce_doc_mask.numpy(), got.ce_doc_mask.numpy())
        np.testing.assert_array_equal(loaded.ce_doc_lens, got.ce_doc_lens)
    for system, table in got.percentile_distributions.items():
        np.testing.assert_array_equal(b.percentile_distributions[system], table)
        np.testing.assert_array_equal(a.percentile_distributions[system], want.percentile_distributions[system])
