"""Each retriever's own search in fusion_tpu_torch against the JAX package:
``ColBERT.search`` (all three branches), ``BiEncoder.search`` and
``search_sparse``, ``lexical_query_matrix`` / ``sparse_search`` and
``BM25Index``'s scorers and searches, on the CPU with tiny models whose
weights are converted from the JAX models, and indexes converted from the
JAX package's where the two packages would build them differently.

Tolerance: 1e-5 throughout (every path here is f32 on the CPU, the
encoders agree to ~1e-6 and sums run in another order); ids equal except
within ties at that tolerance.  The cos_sim searches normalize in f32 here
(tiny f32 models), so they need none of the 2^-8 that ROADMAP Queue 3
records for bf16 normalization."""

import numpy as np
import pytest
import torch
from torch_parity import DEVICE, assert_ranked_match

import jax.numpy as jnp

from fusion_tpu.index import sparse as jax_sparse
from fusion_tpu.models.biencoder import BiEncoder as JaxBiEncoder
from fusion_tpu.models.bm25 import BM25Index as JaxBM25
from fusion_tpu.models.colbert import ColBERT as JaxColBERT
from fusion_tpu.models.encoder import EncoderConfig as JaxConfig
from fusion_tpu_torch.index import sparse
from fusion_tpu_torch.models import convert
from fusion_tpu_torch.models.biencoder import BiEncoder
from fusion_tpu_torch.models.bm25 import BM25Index
from fusion_tpu_torch.models.colbert import ColBERT, TokenIndex
from fusion_tpu_torch.models.encoder import EncoderConfig

ATOL = 1e-5
K = 20


def _corpus(seed=5, n=61, vocab=90):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    docs = [" ".join(f"w{t}" for t in rng.choice(vocab, size=rng.integers(4, 18), p=p)) for _ in range(n)]
    queries = [" ".join(f"w{t}" for t in rng.choice(vocab, size=3, p=p)) for _ in range(6)]
    return docs, queries + ["", "w7 zz"]


DOCS, QUERIES = _corpus()


def _match(got, want, atol=ATOL, cut_ties=False):
    assert got.ids.dtype == torch.int32
    assert_ranked_match(got.ids.cpu(), got.scores.cpu(), np.asarray(want.ids), np.asarray(want.scores),
                        atol=atol, cut_ties=cut_ties)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = JaxConfig.tiny(vocab_size=512), EncoderConfig.tiny(vocab_size=512)
    kw = dict(max_query_length=8, max_doc_length=24)
    jd = JaxBiEncoder(jcfg, head="dense", **kw)
    js = JaxBiEncoder(jcfg, head="splade", **kw)
    jc = JaxColBERT(jcfg, dim=16, **kw)
    td = BiEncoder(tcfg, params=convert.encoder_state_dict(jd.params), head="dense", device=DEVICE, **kw)
    ts = BiEncoder(tcfg, params=convert.encoder_with_mlm_state_dict(js.params), head="splade",
                   device=DEVICE, **kw)
    tc = ColBERT(tcfg, params=convert.colbert_state_dict(jc.params), dim=16, device=DEVICE, **kw)
    return {"dense": (jd, td), "splade": (js, ts), "colbert": (jc, tc)}


# ----------------------------------------------------------------------
# ColBERT
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def colbert_indexes(models):
    """JAX's token index (61 docs padded to 64: three fully masked docs) and
    compressed index, each with its conversion into the port."""
    jc, _ = models["colbert"]
    j_tok = jc.index(DOCS, batch_size=8, pad_docs_to=16)
    t_tok = TokenIndex(
        tokens=torch.from_numpy(np.asarray(j_tok.tokens, dtype=np.float32)).to(torch.bfloat16),
        mask=torch.from_numpy(np.asarray(j_tok.mask)),
    )
    j_cmp = jc.index_compressed(DOCS, batch_size=8, pad_docs_to=16, num_centroids=32)
    t_cmp, _ = convert.plaid_index_from_arrays(
        j_cmp.centroids, j_cmp.centroid_ids, j_cmp.codes, j_cmp.mask, j_cmp.bucket_weights,
        j_cmp.nbits, device=DEVICE,
    )
    return {"tokens": (j_tok, t_tok), "compressed": (j_cmp, t_cmp)}


@pytest.mark.parametrize("branch", ["prepared", "doc_major", "compressed"])
def test_colbert_search_matches_jax(models, colbert_indexes, branch):
    jc, tc = models["colbert"]
    j_index, t_index = colbert_indexes["compressed" if branch == "compressed" else "tokens"]
    kw = dict(k=K, batch_size=4, use_pallas=branch != "doc_major")
    want = jc.search(QUERIES, j_index, **kw)
    got = tc.search(QUERIES, t_index, **kw)
    _match(got, want)
    assert not ({61, 62, 63} & set(got.ids.numpy().ravel().tolist()))  # pads never rank


def test_colbert_search_takes_precomputed_queries(models, colbert_indexes):
    _, tc = models["colbert"]
    _, t_index = colbert_indexes["tokens"]
    assert t_index.num_docs == 64
    q_tok, q_mask = tc.encode_queries(QUERIES, batch_size=4)
    for use_pallas in (True, False):
        a = tc.search((q_tok, q_mask), t_index, k=K, use_pallas=use_pallas)
        b = tc.search(QUERIES, t_index, k=K, batch_size=4, use_pallas=use_pallas)
        np.testing.assert_array_equal(a.ids.numpy(), b.ids.numpy())
        np.testing.assert_array_equal(a.scores.numpy(), b.scores.numpy())


# ----------------------------------------------------------------------
# bi-encoders
# ----------------------------------------------------------------------
@pytest.mark.parametrize("form", ["texts", "embeddings"])
@pytest.mark.parametrize("head", ["dense", "splade"])
def test_biencoder_search_matches_jax(models, head, form):
    jm, tm = models[head]
    if form == "texts":
        want = jm.search(QUERIES, DOCS, topk=K, batch_size=8)
        got = tm.search(QUERIES, DOCS, topk=K, batch_size=8)
    else:
        want = jm.search(jm.encode(QUERIES, batch_size=8), jnp.asarray(jm.encode(DOCS, query_mode=False)),
                         topk=K)
        got = tm.search(tm.encode(QUERIES, batch_size=8), tm.encode(DOCS, query_mode=False), topk=K)
    _match(got, want)


def test_splade_search_sparse_matches_jax(models):
    js, ts = models["splade"]
    j_index = js.build_sparse_index(DOCS, prune_topk=16, batch_size=8)
    t_index = ts.build_sparse_index(DOCS, prune_topk=16, batch_size=8)
    np.testing.assert_array_equal(t_index.entry_term.numpy(), np.asarray(j_index.entry_term))
    np.testing.assert_allclose(t_index.entry_weight.numpy(), np.asarray(j_index.entry_weight), atol=1e-5)
    converted = sparse.SparseIndex(
        entry_term=torch.from_numpy(np.asarray(j_index.entry_term)),
        entry_weight=torch.from_numpy(np.asarray(j_index.entry_weight)),
        n_docs=j_index.n_docs, vocab_size=j_index.vocab_size, nnz=j_index.nnz,
    )
    want = js.search_sparse(QUERIES, j_index, topk=K)
    _match(ts.search_sparse(QUERIES, converted, topk=K), want)


# ----------------------------------------------------------------------
# the fixed-K sparse index
# ----------------------------------------------------------------------
def test_lexical_query_matrix_matches_jax(rng):
    v = 50
    terms = rng.integers(0, v + 3, size=(5, 7)).astype(np.int32)  # ids >= V are pads
    terms[0, :3] = [4, 4, 9]  # a repeated term adds up
    weights = rng.random((5, 7)).astype(np.float32)
    want = np.asarray(jax_sparse.lexical_query_matrix(jnp.asarray(terms), jnp.asarray(weights), v))
    got = sparse.lexical_query_matrix(torch.from_numpy(terms), torch.from_numpy(weights), v)
    assert got.shape == (5, v)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("doc_block", [16384, 8, 37])
def test_sparse_search_matches_jax(rng, doc_block):
    """doc_block 8 clamps the tail block over N 37."""
    n, kk, v = 37, 6, 50
    term = np.sort(rng.choice(v + 1, size=(n, kk)), axis=1).astype(np.int32)  # V = pad slot
    weight = np.where(term < v, rng.random((n, kk)), 0.0).astype(np.float32)
    qa = np.where(rng.random((5, v)) < 0.3, rng.random((5, v)), 0.0).astype(np.float32)
    j_index = jax_sparse.SparseIndex(jnp.asarray(term), jnp.asarray(weight), n, v, int((term < v).sum()))
    t_index = sparse.SparseIndex(torch.from_numpy(term), torch.from_numpy(weight), n, v, j_index.nnz)
    want = jax_sparse.sparse_search(jnp.asarray(qa), j_index, k=10, doc_block=doc_block)
    got = sparse.sparse_search(torch.from_numpy(qa), t_index, k=10, doc_block=doc_block)
    _match(got, want)


# ----------------------------------------------------------------------
# BM25
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def bm25():
    want = JaxBM25.build(DOCS, k1=2.5, b=0.2, use_native=False)
    got = BM25Index.build(DOCS, k1=2.5, b=0.2, device=DEVICE)
    return want, got


@pytest.mark.parametrize("query_batch", [256, 3])
@pytest.mark.parametrize("method", ["gather", "matmul"])
def test_bm25_search_all_matches_jax(bm25, method, query_batch):
    """query_batch 3 over 8 queries pads the last batch with empty queries."""
    want_i, got_i = bm25
    want = want_i.search_all(QUERIES, top_k=K, method=method, query_batch=query_batch)
    got = got_i.search_all(QUERIES, top_k=K, method=method, query_batch=query_batch)
    assert got.ids.shape == (len(QUERIES), K)
    _match(got, want)


def test_bm25_scorers_match_jax(bm25):
    want_i, got_i = bm25
    jt, jw = want_i.encode_queries(QUERIES)
    tt, tw = got_i.encode_queries(QUERIES)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    k1, b = jnp.float32(want_i.k1), jnp.float32(want_i.b)
    gather = got_i.score_gather(tt, tw, got_i.k1, got_i.b, query_chunk=3)
    np.testing.assert_allclose(gather.numpy(), np.asarray(want_i.score_gather(jt, jw, k1, b)), atol=ATOL)
    blocked = got_i.score_matmul(tt, tw, got_i.k1, got_i.b, doc_block=16)  # 61 docs: a ragged block
    want = np.asarray(want_i.score_matmul(jt, jw, k1, b, doc_block=16))
    assert blocked.shape == (len(QUERIES), 61)
    np.testing.assert_allclose(blocked.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(blocked.numpy(), gather.numpy(), atol=ATOL)
    ranked = got_i.score_matmul(tt, tw, got_i.k1, got_i.b, doc_block=16, top_k=K)
    _match(ranked, want_i.score_matmul(jt, jw, k1, b, doc_block=16, top_k=K))


@pytest.mark.parametrize("form", ["dense", "impact", "sparse", "sparse_pruned"])
def test_bm25_index_forms_search_like_jax(bm25, form):
    want_i, got_i = bm25
    if form == "dense":
        want = want_i.search_dense(QUERIES, want_i.build_dense_impacts(), top_k=K)
        got = got_i.search_dense(QUERIES, got_i.build_dense_impacts(), top_k=K)
    elif form == "impact":
        want = want_i.search_impact(QUERIES, want_i.to_impact_index(cap=8), top_k=K)
        got = got_i.search_impact(QUERIES, got_i.to_impact_index(cap=8), top_k=K)
    else:
        prune = 3 if form == "sparse_pruned" else None
        j_index, t_index = want_i.to_sparse_index(prune), got_i.to_sparse_index(prune)
        np.testing.assert_array_equal(t_index.entry_term.numpy(), np.asarray(j_index.entry_term))
        np.testing.assert_allclose(t_index.entry_weight.numpy(), np.asarray(j_index.entry_weight),
                                   rtol=1e-6)
        assert t_index.nnz == j_index.nnz
        want = want_i.search_sparse(QUERIES, j_index, top_k=K, doc_block=16)
        got = got_i.search_sparse(QUERIES, t_index, top_k=K, doc_block=16)
    _match(got, want)


def test_bm25_update_params_rescores_without_a_rebuild():
    want_i = JaxBM25.build(DOCS, k1=2.5, b=0.2, use_native=False)
    got_i = BM25Index.build(DOCS, k1=2.5, b=0.2, device=DEVICE)
    before = got_i.search_all(QUERIES, top_k=K)
    for index in (want_i, got_i):
        index.update_params(1.2, 0.75)
    assert (got_i.k1, got_i.b) == (1.2, 0.75)
    got = got_i.search_all(QUERIES, top_k=K)
    _match(got, want_i.search_all(QUERIES, top_k=K))
    assert not torch.equal(got.scores, before.scores)


def test_bm25_search_all_rejects_an_unknown_method(bm25):
    with pytest.raises(ValueError, match="method"):
        bm25[1].search_all(QUERIES, method="scan")


# ----------------------------------------------------------------------
# entry points default to the card
# ----------------------------------------------------------------------
def _entry_points():
    from fusion_tpu_torch.models.encoder import init_encoder_params
    from fusion_tpu_torch.serving import HybridSearcher

    cfg = EncoderConfig.tiny(vocab_size=64)
    return {
        "BiEncoder": lambda: BiEncoder(cfg),
        "ColBERT": lambda: ColBERT(cfg, dim=16),
        "BM25Index.build": lambda: BM25Index.build(DOCS),
        "HybridSearcher.build": lambda: HybridSearcher.build(dict(enumerate(DOCS)), bm25_docs=DOCS),
        "HybridSearcher": lambda: HybridSearcher(corpus_ids=np.arange(3)),
        "init_encoder_params": lambda: init_encoder_params(cfg),
        "plaid_index_from_arrays": lambda: convert.plaid_index_from_arrays(
            np.zeros((4, 16)), np.zeros((2, 3)), np.zeros((2, 3, 4)), np.ones((2, 3)),
            np.zeros(4), 2,
        ),
    }


@pytest.mark.parametrize("entry", sorted(_entry_points()))
def test_entry_points_without_a_device_need_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        _entry_points()[entry]()
