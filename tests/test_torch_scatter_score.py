"""fusion_tpu_torch's scale-mode sparse path against the JAX package: the
numpy index build functions, the segmented run sums, the flat impact search, query
pruning, the scatter scorer (the plain version of kernel K3, which a CPU
tensor runs, against ``use_pallas=False``) and the two-stage rescore.

The index builds, the run sums, the impact search, the posting gather and the
chunk scores are bit-exact (same additions in the same order).  The rescore
sums K products in another order than XLA: atol 1e-5 at scores up to ~15."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_ranked_match

from fusion_tpu.index import inverted as jax_inv
from fusion_tpu.index import sparse as jax_sparse
from fusion_tpu.ops import scatter_score as jax_scatter
from fusion_tpu.ops import segscan as jax_segscan
from fusion_tpu_torch.index import inverted, sparse
from fusion_tpu_torch.ops import _kernels, scatter_score, segscan


def _postings(rng, n_docs, vocab, terms_per_doc):
    """Unique (term, doc) pairs with impacts in [0.1, 2)."""
    doc = np.repeat(np.arange(n_docs, dtype=np.int64), terms_per_doc)
    term = rng.integers(0, vocab, size=doc.size)
    pair = np.unique(term * n_docs + doc)
    term, doc = pair // n_docs, pair % n_docs
    return term, doc, rng.uniform(0.1, 2.0, size=term.size).astype(np.float32)


def _f16_bits(x) -> np.ndarray:
    return np.asarray(x).astype(np.float16).view(np.uint16)


def _query(rng, vocab, q, kq, pads=True):
    terms = rng.integers(0, vocab, size=(q, kq)).astype(np.int32)
    weights = rng.uniform(0.2, 1.5, size=(q, kq)).astype(np.float32)
    if pads:  # pad slots (term V, weight 0) and a query of only pads
        terms[0, kq // 2 :] = vocab
        weights[0, kq // 2 :] = 0.0
        terms[-1], weights[-1] = vocab, 0.0
    return terms, weights


@pytest.mark.parametrize("cap", [4, 64])
def test_flat_build_and_impact_search_bit_exact(rng, cap):
    n, vocab = 3000, 120
    term, doc, imp = _postings(rng, n, vocab, 4)
    want = jax_inv.build_impact_index(term, doc, imp, vocab, n, cap=cap, use_native=False)
    got = inverted.build_impact_index(term, doc, imp, vocab, n, cap=cap)
    np.testing.assert_array_equal(got.post_doc.numpy(), np.asarray(want.post_doc))
    np.testing.assert_array_equal(_f16_bits(got.post_impact), _f16_bits(want.post_impact))
    assert got.nnz_kept == want.nnz_kept
    np.testing.assert_array_equal(got.term_df, want.term_df)
    qt, qw = _query(rng, vocab, 5, 8)
    k = min(40, 8 * cap)  # at most the flattened posting width
    w = jax_inv.impact_search(jnp.asarray(qt), jnp.asarray(qw), want, k=k)
    g = inverted.impact_search(torch.from_numpy(qt), torch.from_numpy(qw), got, k=k)
    np.testing.assert_array_equal(g.ids.numpy(), np.asarray(w.ids))
    np.testing.assert_array_equal(g.scores.numpy(), np.asarray(w.scores))
    assert (g.ids.numpy()[-1] == -1).all()  # nothing matches a query of pads


@pytest.mark.parametrize("docs_per_chunk, cap", [(2048, 8), (4096, 64)])
def test_chunked_build_bit_exact(rng, docs_per_chunk, cap):
    n, vocab = 9000, 96
    term, doc, imp = _postings(rng, n, vocab, 5)
    want = jax_inv.build_chunked_impact_index(
        term, doc, imp, vocab, n, docs_per_chunk, cap, use_native=False
    )
    got = inverted.build_chunked_impact_index(term, doc, imp, vocab, n, docs_per_chunk, cap)
    assert got.post_doc.dtype == torch.int16 and got.num_chunks == want.num_chunks
    np.testing.assert_array_equal(got.post_doc.numpy().view(np.uint16), np.asarray(want.post_doc))
    np.testing.assert_array_equal(_f16_bits(got.post_impact), _f16_bits(want.post_impact))
    assert got.nnz_kept == want.nnz_kept


def test_unsafe_term_warning(rng):
    term = np.zeros(500, np.int64)  # one term in every doc, far past 8 × cap
    doc = np.arange(500)
    imp = np.ones(500, np.float32)
    with pytest.warns(inverted.ImpactCapTruncationWarning):
        inverted.build_impact_index(term, doc, imp, vocab_size=4, n_docs=500, cap=8)


@pytest.mark.parametrize("max_run", [1, 3, 8, 1000])
def test_segmented_run_totals_bit_exact(rng, max_run):
    keys = np.sort(rng.integers(0, 40, size=(4, 97)), axis=1).astype(np.int32)
    vals = rng.normal(size=(4, 97)).astype(np.float32)
    w_seg, w_end = jax_segscan.segmented_run_totals(jnp.asarray(keys), jnp.asarray(vals), max_run)
    g_seg, g_end = segscan.segmented_run_totals(torch.from_numpy(keys), torch.from_numpy(vals), max_run)
    np.testing.assert_array_equal(g_seg.numpy(), np.asarray(w_seg))
    np.testing.assert_array_equal(g_end.numpy(), np.asarray(w_end))


def test_activations_to_query_terms_matches(rng):
    acts = np.maximum(rng.normal(size=(4, 50)), 0).astype(np.float32)
    acts[1, :45] = 0.0  # fewer positive terms than kq: pads
    acts[2, 10:20] = 0.5  # ties keep the lower term id
    w_t, w_w = jax_inv.activations_to_query_terms(jnp.asarray(acts), 12)
    g_t, g_w = inverted.activations_to_query_terms(torch.from_numpy(acts), 12)
    assert g_t.dtype == torch.int32
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(w_t))
    np.testing.assert_array_equal(g_w.numpy(), np.asarray(w_w))


def _chunked(rng, n=5000, vocab=64, dpc=2048, cap=32):
    term, doc, imp = _postings(rng, n, vocab, 3)
    want = jax_inv.build_chunked_impact_index(term, doc, imp, vocab, n, dpc, cap, use_native=False)
    got = inverted.build_chunked_impact_index(term, doc, imp, vocab, n, dpc, cap)
    return want, got


@pytest.mark.parametrize("chunk_block", [1, 2, 16])
def test_gather_postings_and_chunk_scores_bit_exact(rng, chunk_block):
    want, got = _chunked(rng)
    qt, qw = _query(rng, 64, 4, 6)
    w_docs, w_vals = jax_scatter._gather_postings(
        jnp.asarray(qt), jnp.asarray(qw), want.post_doc, want.post_impact, chunk_block
    )
    g_docs, g_vals = scatter_score._gather_postings(
        torch.from_numpy(qt), torch.from_numpy(qw), got.post_doc, got.post_impact, chunk_block
    )
    np.testing.assert_array_equal(g_docs.numpy(), np.asarray(w_docs))
    np.testing.assert_array_equal(g_vals.float().numpy(), np.asarray(w_vals, dtype=np.float32))
    w_sc = jax_scatter._chunk_scores(w_docs, w_vals, 16)
    g_sc = scatter_score._chunk_scores(g_docs, g_vals, 16)
    np.testing.assert_array_equal(g_sc.numpy(), np.asarray(w_sc))


@pytest.mark.parametrize(
    "n, dpc, cap, kq, k",
    [
        (5000, 2048, 32, 8, 50),  # 3 chunks, the last one partly beyond n_docs
        (3000, 4096, 8, 5, 3000),  # k past the bins: padded columns
        (20000, 2048, 16, 6, 40),  # 10 chunks: the plain path pads a chunk block
    ],
)
def test_scatter_impact_search_matches(rng, n, dpc, cap, kq, k):
    want, got = _chunked(rng, n=n, vocab=48, dpc=dpc, cap=cap)
    qt, qw = _query(rng, 48, 4, kq)
    w = jax_scatter.scatter_impact_search(jnp.asarray(qt), jnp.asarray(qw), want, k=k, use_pallas=False)
    g = scatter_score.scatter_impact_search(torch.from_numpy(qt), torch.from_numpy(qw), got, k=k)
    assert g.ids.dtype == torch.int32 and g.ids.shape == (4, min(k, n))
    # scores bit-exact; ids too, up to the order of exactly equal packed
    # scores (JAX's approx_max_k on the CPU does not order those by position)
    assert_ranked_match(g.ids, g.scores, w.ids, w.scores, atol=0.0)
    assert (g.ids.numpy()[-1] == -1).all()  # a query of pads matches nothing


def test_scatter_rejects_bad_chunk_width(rng):
    term, doc, imp = _postings(rng, 2000, 32, 2)
    index = inverted.build_chunked_impact_index(term, doc, imp, 32, 2000, 1000, 16)
    with pytest.raises(ValueError, match="docs_per_chunk"):
        scatter_score.scatter_impact_search(torch.zeros((1, 2), dtype=torch.int32), torch.ones(1, 2), index)


def _sparse_pair(rng, n=80, vocab=200, k=24):
    acts = np.maximum(rng.normal(size=(n, vocab)) - 1.0, 0).astype(np.float32)
    acts[3] = 0.0  # an empty doc
    batches = [acts[i : i + 32] for i in range(0, n, 32)]
    want = jax_sparse.build_sparse_index(iter(batches), vocab, prune_topk=k)
    got = sparse.build_sparse_index(iter(batches), vocab, prune_topk=k)
    return want, got


def test_sparse_index_and_rescore_store_bit_exact(rng):
    want, got = _sparse_pair(rng)
    np.testing.assert_array_equal(got.entry_term.numpy(), np.asarray(want.entry_term))
    np.testing.assert_array_equal(got.entry_weight.numpy(), np.asarray(want.entry_weight))
    assert (got.n_docs, got.nnz) == (want.n_docs, want.nnz)
    w_store = jax_sparse.build_rescore_store(want)
    g_store = sparse.build_rescore_store(got)
    np.testing.assert_array_equal(g_store.packed.numpy().view(np.uint16), np.asarray(w_store.packed))
    assert (g_store.n_docs, g_store.vocab_size, g_store.prune_topk) == (
        w_store.n_docs, w_store.vocab_size, w_store.prune_topk
    )
    # the impact forms built from it
    w_flat = jax_inv.sparse_to_impact_index(want, cap=16)
    g_flat = inverted.sparse_to_impact_index(got, cap=16)
    np.testing.assert_array_equal(g_flat.post_doc.numpy(), np.asarray(w_flat.post_doc))
    w_ch = jax_inv.sparse_to_chunked_impact_index(want, docs_per_chunk=2048, cap_per_chunk=8)
    g_ch = inverted.sparse_to_chunked_impact_index(got, docs_per_chunk=2048, cap_per_chunk=8)
    np.testing.assert_array_equal(g_ch.post_doc.numpy().view(np.uint16), np.asarray(w_ch.post_doc))


@pytest.mark.parametrize("cand_chunk", [4096, 8])
def test_sparse_rescore_matches(rng, cand_chunk):
    want, got = _sparse_pair(rng)
    w_store, g_store = jax_sparse.build_rescore_store(want), sparse.build_rescore_store(got)
    qv = np.maximum(rng.normal(size=(3, 200)), 0).astype(np.float32)
    cand = rng.integers(0, 80, size=(3, 24)).astype(np.int32)
    cand[:, :5] = np.arange(5)  # distinct ids first
    cand[0, -3:] = -1  # pads
    cand[1, -1] = 80  # out of range
    cand[2] = np.arange(24)  # no duplicates in this row
    w = jax_sparse.sparse_rescore(jnp.asarray(qv), jnp.asarray(cand), w_store, k=20, cand_chunk=cand_chunk)
    g = sparse.sparse_rescore(torch.from_numpy(qv), torch.from_numpy(cand), g_store, k=20, cand_chunk=cand_chunk)
    assert g.ids.dtype == torch.int32
    assert_ranked_match(g.ids, g.scores, w.ids, w.scores, atol=1e-5)


def test_cpu_tensors_never_reach_the_kernel(rng):
    _, got = _chunked(rng)
    qt, qw = _query(rng, 64, 2, 4)
    before = scatter_score.scatter_binmax_cuda.launches
    scatter_score.scatter_impact_search(torch.from_numpy(qt), torch.from_numpy(qw), got, k=5)
    assert scatter_score.scatter_binmax_cuda.launches == before == 0
    assert _kernels.load.cache_info().currsize == 0  # nothing was built
    with pytest.raises(ValueError, match="CUDA"):
        scatter_score.scatter_binmax_cuda(
            torch.from_numpy(qt), torch.from_numpy(qw), got.post_doc, got.post_impact, 2048
        )
