"""The port's mesh, collectives and sharded index forms (``parallel/``, the
``shard_*`` builders and ``sharded_*`` searches) against the JAX package's
mesh programs on the conftest's 8 virtual CPU devices.

Two layers, in one process:

  * host repacking: ``shard_impact_index``, ``shard_chunked_impact_index``,
    ``shard_plaid_index`` (u8 codes: JAX's ``dma_codes=False``) and the
    searcher's ``_shard_dense_matrix`` keep, for each rank r of 8, exactly
    row r of JAX's stacked arrays (byte-equal; the chunked index's uint16
    doc ids are held in int16);
  * shard-local search and merge at S = 8: each of the eight shards searched
    by the port's single-device search (the plain versions, on the CPU), its
    ids made global, and ``merge_shards`` over the stacked lists, against
    JAX's 8-device ``sharded_*`` result on the JAX tests' own cases
    (``test_mips.py``, ``test_plaid.py``, ``test_compression.py``,
    ``test_scatter_score.py``, ``test_distributed.py``).  The integer and f16
    paths (impact, scatter, PLAID's candidates) agree bit for bit; the f32
    matmul paths within 1e-5 (another summation order), ids equal except
    inside runs of scores that tie within the bound.

Besides: the mesh of one rank without a process group (its collectives the
identity, a larger one refused), ``merge_shards``' tie order, and the
training half's ``NotImplementedError``.  JAX's
``test_sharded_programs_are_cached`` has no counterpart: the port compiles
no mesh program.  The collective path in real processes is
``tests/test_torch_serving_sharded.py`` and ``test_torch_multihost.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_compression import make_tokens
from test_scatter_score import _random_postings
from torch_parity import DEVICE, assert_ranked_match

from fusion_tpu.index import compression as jc
from fusion_tpu.index import inverted as jinv
from fusion_tpu.index import plaid as jp
from fusion_tpu.ops import mips as jmips
from fusion_tpu.ops import scatter_score as jscatter
from fusion_tpu.parallel import sharding as jsharding
from fusion_tpu import serving_sharded as jss
from fusion_tpu_torch.core.ranked import RankedLists
from fusion_tpu_torch.index import inverted, plaid
from fusion_tpu_torch.index.compression import CompressedTokenIndex, maxsim_search_compressed
from fusion_tpu_torch.index.dense_quant import QuantizedDenseIndex
from fusion_tpu_torch.models.convert import plaid_index_from_arrays
from fusion_tpu_torch.ops import maxsim, mips, scatter_score
from fusion_tpu_torch.parallel import sharding
from fusion_tpu_torch import serving_sharded

S = 8
ATOL = 1e-5


@pytest.fixture(scope="module")
def mesh8():
    return jsharding.make_mesh(data=1, model=1, index=S)


def _merged(locals_, per, k):
    """Eight shard-local lists → the merged global top-k, as the ranks'
    all-gather and ``merge_shards`` give it."""
    ids = torch.stack([sharding.globalize(r, i, per) for i, r in enumerate(locals_)])
    scores = torch.stack([r.scores for r in locals_])
    return sharding.merge_shards(ids, scores, k)


def _t(x):
    return torch.from_numpy(np.array(x))


# ----------------------------------------------------------------------
# the mesh and the collectives
# ----------------------------------------------------------------------
def test_one_rank_mesh_needs_no_group():
    mesh = sharding.make_mesh(index=1, devices=[DEVICE])
    assert mesh.shape == {"data": 1, "model": 1, "index": 1} and mesh.size == 1
    assert mesh.coords["index"] == 0 and mesh.device.type == "cpu"
    assert all(g is None for g in mesh.groups.values())
    x = torch.arange(6.0).view(2, 3)
    assert torch.equal(sharding.all_gather(x, mesh), x[None])
    assert sharding.all_reduce_sum(x, mesh) is x
    assert sharding.make_mesh(devices=[DEVICE]).shape["data"] == 1
    with pytest.raises(ValueError, match="process group"):
        sharding.make_mesh(data=1, index=2, devices=[DEVICE, DEVICE])
    with pytest.raises(ValueError, match="not divisible"):
        sharding.make_mesh(index=2)
    with pytest.raises(ValueError, match="one device per rank"):
        sharding.make_mesh(index=1, devices=[DEVICE, DEVICE])
    with pytest.raises(ValueError, match="rank="):
        sharding.default_index_rank(2)


def test_merge_shards_tie_order_matches_lax_top_k():
    """Equal scores: the lower shard first, then the lower local rank, as
    ``lax.top_k`` over JAX's ``[Q, S·kl]`` layout; non-finite → id -1."""
    rng = np.random.default_rng(0)
    scores = rng.choice([0.5, 1.0, 2.0, -np.inf], size=(4, 3, 5)).astype(np.float32)  # [S, Q, kl]
    ids = rng.integers(0, 100, size=scores.shape).astype(np.int32)
    got = sharding.merge_shards(_t(ids), _t(scores), 12)
    flat_s = scores.transpose(1, 0, 2).reshape(3, -1)
    flat_i = ids.transpose(1, 0, 2).reshape(3, -1)
    import jax

    w_s, pos = jax.lax.top_k(jnp.asarray(flat_s), 12)
    w_i = np.where(np.isfinite(np.asarray(w_s)), np.take_along_axis(flat_i, np.asarray(pos), 1), -1)
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(w_s))
    np.testing.assert_array_equal(got.ids.numpy(), w_i)
    assert got.ids.dtype == torch.int32


def test_training_half_raises_with_item_18():
    """The training half (item 18) is ported: the specs and a rank's slice
    come back (held to JAX's in ``test_torch_train_parallel.py``); and
    tensor parallelism of the T5 trunk no longer raises: under
    ``model = 2`` ``shard_module`` keeps every T5 parameter whole, as JAX's
    rules, which match none of its paths, do."""
    from fusion_tpu_torch.models.t5 import T5Config, T5CrossEncoder
    from fusion_tpu_torch.parallel import encoder_param_spec, shard_params
    from fusion_tpu_torch.parallel.sharding import shard_module

    tree = {"layer_0": {"ffn_in": {"kernel": np.arange(12.0).reshape(3, 4), "bias": np.arange(4.0)}}}
    assert encoder_param_spec(tree) == {"layer_0": {"ffn_in": {"kernel": (None, "model"), "bias": ("model",)}}}
    mesh = sharding.make_mesh(1, 1, 1, [DEVICE])
    assert shard_params(tree, mesh) is not tree and shard_params(tree, mesh)["layer_0"]["ffn_in"]["bias"] is tree[
        "layer_0"]["ffn_in"]["bias"]
    two = dataclasses.replace(mesh, shape={**mesh.shape, "model": 2}, coords={**mesh.coords, "model": 1})
    got = shard_params(tree, two)["layer_0"]["ffn_in"]
    np.testing.assert_array_equal(got["kernel"], tree["layer_0"]["ffn_in"]["kernel"][:, 2:])
    np.testing.assert_array_equal(got["bias"], [2.0, 3.0])
    t5 = T5CrossEncoder(T5Config.tiny(), max_length=16, device=DEVICE)
    shapes = {k: v.shape for k, v in t5.module.state_dict().items()}
    shard_module(t5.module, two, t5.cfg.num_heads)
    assert {k: v.shape for k, v in t5.module.state_dict().items()} == shapes
    assert not any(hasattr(p, "tp_shard") for p in t5.module.parameters())


# ----------------------------------------------------------------------
# host repacking, byte-equal to JAX's stacked arrays
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def impact_pair():
    """test_distributed.py's impact index (40 terms, 64 docs, cap 64), both
    packages' copies, and its queries."""
    rng = np.random.default_rng(42)
    v, n, nnz = 40, 64, 600
    term = rng.integers(0, v, size=nnz)
    doc = rng.integers(0, n, size=nnz)
    pairs = np.unique(term * n + doc)
    term, doc = pairs // n, pairs % n
    imp = rng.uniform(0.1, 3.0, size=term.size).astype(np.float32)
    want = jinv.build_impact_index(term, doc, imp, vocab_size=v, n_docs=n, cap=64)
    got = inverted.build_impact_index(term, doc, imp, vocab_size=v, n_docs=n, cap=64, device=DEVICE)
    qt = rng.integers(0, v, size=(5, 6)).astype(np.int32)
    qw = rng.uniform(0.5, 2.0, size=(5, 6)).astype(np.float32)
    return want, got, qt, qw


def test_shard_impact_index_byte_equal(impact_pair):
    want, got, _, _ = impact_pair
    stacked = jinv.shard_impact_index(want, S)
    shards = [inverted.shard_impact_index(got, S, rank=r) for r in range(S)]
    for r, sh in enumerate(shards):
        assert (sh.n_docs, sh.docs_per_shard, sh.vocab_size, sh.cap) == (
            stacked.n_docs, stacked.docs_per_shard, stacked.vocab_size, stacked.cap)
        assert sh.post_doc.dtype == torch.int32 and sh.post_impact.dtype == torch.float16
        np.testing.assert_array_equal(sh.post_doc.numpy(), np.asarray(stacked.post_doc)[r])
        np.testing.assert_array_equal(sh.post_impact.numpy().view(np.uint16),
                                      np.asarray(stacked.post_impact)[r].view(np.uint16))
    q = np.array([[0, 1, 39, 40]])
    assert shards[0].unsafe_query_term_frac(q) == stacked.unsafe_query_term_frac(q)


@pytest.fixture(scope="module")
def scatter_pair():
    """test_scatter_score.py's sharded case: 40,000 docs, 200 terms, 2,048
    docs a chunk (20 chunks: S = 8 pads them to 24)."""
    rng = np.random.default_rng(7)
    n_docs, vocab, kq = 40_000, 200, 8
    term, doc, imp = _random_postings(rng, n_docs, vocab, terms_per_doc=4)
    want = jinv.build_chunked_impact_index(term, doc, imp, vocab_size=vocab, n_docs=n_docs,
                                           docs_per_chunk=2048, cap_per_chunk=64)
    got = inverted.build_chunked_impact_index(term, doc, imp, vocab_size=vocab, n_docs=n_docs,
                                              docs_per_chunk=2048, cap_per_chunk=64, device=DEVICE)
    qt = rng.integers(0, vocab, size=(4, kq)).astype(np.int32)
    qw = rng.uniform(0.2, 1.5, size=(4, kq)).astype(np.float32)
    return want, got, qt, qw


def test_shard_chunked_impact_index_byte_equal(scatter_pair):
    want, got, _, _ = scatter_pair
    stacked = jscatter.shard_chunked_impact_index(want, S)
    for r in range(S):
        sh = scatter_score.shard_chunked_impact_index(got, S, rank=r)
        assert (sh.n_docs, sh.docs_per_chunk, sh.docs_per_shard, sh.vocab_size, sh.cap_per_chunk) == (
            stacked.n_docs, stacked.docs_per_chunk, stacked.docs_per_shard, stacked.vocab_size,
            stacked.cap_per_chunk)
        assert sh.post_doc.dtype == torch.int16 and sh.post_doc.is_contiguous()
        np.testing.assert_array_equal(sh.post_doc.numpy().view(np.uint16), np.asarray(stacked.post_doc)[r])
        np.testing.assert_array_equal(sh.post_impact.numpy().view(np.uint16),
                                      np.asarray(stacked.post_impact)[r].view(np.uint16))


@pytest.fixture(scope="module")
def plaid_pair():
    """test_torch_plaid.py's index (96 docs of ≤ 8 tokens, D 16, 32
    centroids, JAX-built and converted) and its 4 queries."""
    rng = np.random.default_rng(5)
    n, ld, d, c = 96, 8, 16, 32
    toks = rng.standard_normal((n, ld, d)).astype(np.float32)
    toks /= np.linalg.norm(toks, axis=-1, keepdims=True)
    lens = rng.integers(3, ld + 1, size=n)
    mask = (np.arange(ld)[None, :] < lens[:, None]).astype(np.float32)
    want = jc.compress_token_index(jnp.asarray(toks), jnp.asarray(mask), nbits=2, kmeans_iters=4, num_centroids=c)
    got, _ = plaid_index_from_arrays(want.centroids, want.centroid_ids, want.codes, want.mask,
                                     want.bucket_weights, want.nbits, device=DEVICE)
    q = rng.standard_normal((4, 5, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    qm = np.ones((4, 5), np.float32)
    qm[1, 3:] = 0.0
    return want, got, q, qm


def test_shard_plaid_index_byte_equal(plaid_pair):
    want, got, _, _ = plaid_pair
    stacked = jp.shard_plaid_index(want, S, ivf_cap=96, dma_codes=False)
    assert stacked.codes_seg is None
    for r in range(S):
        sh = plaid.shard_plaid_index(got, S, ivf_cap=96, rank=r)
        assert (sh.nbits, sh.n_docs, sh.docs_per_shard, sh.codes_seg) == (
            stacked.nbits, stacked.n_docs, stacked.docs_per_shard, None)
        for name in ("centroid_ids", "codes", "mask", "ivf_doc"):
            np.testing.assert_array_equal(getattr(sh, name).numpy(), np.asarray(getattr(stacked, name))[r],
                                          err_msg=name)
        assert sh.codes.dtype == torch.uint8 and sh.ivf_doc.dtype == torch.int32
        np.testing.assert_array_equal(sh.centroids.numpy(), np.asarray(stacked.centroids))
    with pytest.raises(ValueError, match="dma_codes"):
        plaid.shard_plaid_index(got, S, 96, "yes", rank=0)


@pytest.mark.parametrize("form", ["int8", "bf16_cos", "bf16_dot"])
def test_shard_dense_matrix_byte_equal(form):
    """``_shard_dense_matrix``: docs per shard rounded up to 2,048, pad rows
    zero with scale 0, a bf16 matrix normalized in f32 for cos_sim."""
    from fusion_tpu.index.dense_quant import quantize_dense_index

    rng = np.random.default_rng(11)
    x = rng.normal(size=(2500, 24)).astype(np.float32)
    if form == "int8":
        j_corpus = quantize_dense_index(jnp.asarray(x), similarity="cos_sim")
        t_corpus = QuantizedDenseIndex(_t(j_corpus.values), _t(j_corpus.scales), bool(j_corpus.normalized))
    else:
        j_corpus = jnp.asarray(x, jnp.bfloat16)
        t_corpus = torch.from_numpy(x).to(torch.bfloat16)
    sim = "dot_score" if form == "bf16_dot" else "cos_sim"
    stacked = jss._shard_dense_matrix(j_corpus, sim, S)
    for r in range(S):
        leg = serving_sharded._shard_dense_matrix(t_corpus, sim, S, rank=r)
        assert (leg.normalized, leg.n_docs, leg.docs_per_shard) == (
            stacked.normalized, stacked.n_docs, stacked.docs_per_shard)
        want_v = np.asarray(stacked.values)[r]
        if form == "int8":
            np.testing.assert_array_equal(leg.values.numpy(), want_v)
        else:
            np.testing.assert_array_equal(leg.values.view(torch.int16).numpy(), want_v.view(np.int16))
        np.testing.assert_array_equal(leg.scales.numpy(), np.asarray(stacked.scales)[r])


# ----------------------------------------------------------------------
# shard-local search + merge at S = 8 against JAX's mesh programs
# ----------------------------------------------------------------------
def test_sharded_impact_search_matches_jax(impact_pair, mesh8):
    want_idx, got_idx, qt, qw = impact_pair
    want = jinv.sharded_impact_search(jnp.asarray(qt), jnp.asarray(qw), jinv.shard_impact_index(want_idx, S),
                                      mesh8, k=8)
    shards = [inverted.shard_impact_index(got_idx, S, rank=r) for r in range(S)]
    k = min(8, shards[0].docs_per_shard)
    locals_ = [inverted.impact_search(_t(qt), _t(qw), sh.local(), k=k) for sh in shards]
    got = _merged(locals_, shards[0].docs_per_shard, k)
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))


def test_sharded_scatter_search_matches_jax(scatter_pair, mesh8):
    want_idx, got_idx, qt, qw = scatter_pair
    want = jscatter.sharded_scatter_search(jnp.asarray(qt), jnp.asarray(qw),
                                           jscatter.shard_chunked_impact_index(want_idx, S), mesh8, k=50,
                                           use_pallas=False)
    locals_ = []
    for r in range(S):
        sh = scatter_score.shard_chunked_impact_index(got_idx, S, rank=r)
        locals_.append(scatter_score.local_scatter_search(_t(qt), _t(qw), sh.post_doc, sh.post_impact,
                                                          sh.docs_per_chunk, sh.docs_per_shard, 50))
    got = _merged(locals_, sh.docs_per_shard, 50)
    assert_ranked_match(got.ids, got.scores, want.ids, want.scores, atol=0.0)


def test_sharded_dense_search_matches_jax(mesh8):
    """test_mips.py's sharded case: 200 docs, cos_sim, k 12, doc_block 32."""
    rng = np.random.default_rng(42)
    q = rng.normal(size=(5, 32)).astype(np.float32)
    c = rng.normal(size=(S * 25, 32)).astype(np.float32)
    want = jmips.sharded_dense_search(jnp.asarray(q), jnp.asarray(c), mesh8, k=12, doc_block=32)
    locals_ = [mips.dense_search(_t(q), _t(c[r * 25 : (r + 1) * 25]), k=12, doc_block=32) for r in range(S)]
    got = _merged(locals_, 25, 12)
    assert_ranked_match(got.ids, got.scores, want.ids, want.scores, atol=ATOL)


def test_sharded_bm25_via_dense_search_matches_jax(mesh8):
    """test_mips.py's BM25 case: the [V+1, N] impacts transposed into the
    corpus matrix of the dense search, dot_score."""
    from fusion_tpu.models.bm25 import BM25Index

    rng = np.random.default_rng(42)
    corpus = [" ".join(f"t{t}" for t in rng.integers(0, 50, size=12)) for _ in range(64)]
    idx = BM25Index.build(corpus, k1=1.2, b=0.6)
    impacts = np.asarray(idx.build_dense_impacts(dtype=jnp.float32, on_device=False))
    queries = [" ".join(f"t{t}" for t in rng.integers(0, 50, size=4)) for _ in range(5)]
    q_terms, q_weights = idx.encode_queries(queries)
    qmat = np.zeros((5, impacts.shape[0]), dtype=np.float32)
    np.add.at(qmat, (np.repeat(np.arange(5), q_terms.shape[1]), np.asarray(q_terms).ravel()),
              np.asarray(q_weights).ravel())
    want = jmips.sharded_dense_search(jnp.asarray(qmat), jnp.asarray(impacts.T), mesh8, k=8,
                                      similarity="dot_score", doc_block=8)
    corpus_t = np.ascontiguousarray(impacts.T)
    locals_ = [mips.dense_search(_t(qmat), _t(corpus_t[r * 8 : (r + 1) * 8]), k=8, similarity="dot_score",
                                 doc_block=8) for r in range(S)]
    got = _merged(locals_, 8, 8)
    assert_ranked_match(got.ids, got.scores, want.ids, want.scores, atol=ATOL, cut_ties=True)


def _tokens(seed=42):
    rng = np.random.default_rng(seed)
    n, ld, d = S * 8, 5, 16
    qt = rng.normal(size=(3, 4, d)).astype(np.float32)
    ct = rng.normal(size=(n, ld, d)).astype(np.float32)
    cm = np.ones((n, ld), dtype=np.float32)
    cm[3, -2:] = 0
    cm[9] = 0  # a fully masked pad doc
    return qt, ct, cm


def test_sharded_maxsim_search_matches_jax(mesh8):
    qt, ct, cm = _tokens()
    qm = np.ones((3, 4), np.float32)
    want = jmips.sharded_maxsim_search(jnp.asarray(qt), jnp.asarray(qm), jnp.asarray(ct), jnp.asarray(cm),
                                       mesh8, k=6, doc_block=4)
    locals_ = [maxsim.maxsim_search(_t(qt), _t(qm), _t(ct[r * 8 : (r + 1) * 8]), _t(cm[r * 8 : (r + 1) * 8]),
                                    k=6, doc_block=4) for r in range(S)]
    got = _merged(locals_, 8, 6)
    assert_ranked_match(got.ids, got.scores, want.ids, want.scores, atol=ATOL)
    assert 9 not in got.ids.numpy()


def test_sharded_maxsim_search_tm_matches_jax(mesh8):
    """The prepared (token-major, bf16) layout, the serving path of K1."""
    from fusion_tpu.ops.maxsim import prepare_token_corpus

    qt, ct, cm = _tokens()
    qm = np.ones((3, 4), np.float32)
    c_tm, valid = prepare_token_corpus(jnp.asarray(ct), jnp.asarray(cm))
    want = jmips.sharded_maxsim_search_tm(jnp.asarray(qt), jnp.asarray(qm), c_tm, valid, mesh8, k=6)
    t_tm, t_valid = maxsim.prepare_token_corpus(_t(ct), _t(cm))
    np.testing.assert_array_equal(t_tm.view(torch.int16).numpy(), np.asarray(c_tm).view(np.int16))
    locals_ = [maxsim.maxsim_search_tm(_t(qt), _t(qm), t_tm[:, r * 8 : (r + 1) * 8], t_valid[r * 8 : (r + 1) * 8],
                                       k=6) for r in range(S)]
    got = _merged(locals_, 8, 6)
    assert_ranked_match(got.ids, got.scores, want.ids, want.scores, atol=ATOL)
    assert 9 not in got.ids.numpy()


def test_sharded_maxsim_search_compressed_matches_jax(mesh8):
    """test_compression.py's sharded case: 64 docs compressed to 2 bits over
    32 centroids by JAX, each rank's rows a CompressedTokenIndex."""
    rng = np.random.default_rng(42)
    tokens, mask = make_tokens(rng, n=64)
    q = rng.normal(size=(3, 5, 16)).astype(np.float32)
    qm = np.ones((3, 5), np.float32)
    j_index = jc.compress_token_index(tokens, mask, num_centroids=32, nbits=2)
    want = jmips.sharded_maxsim_search_compressed(jnp.asarray(q), jnp.asarray(qm), j_index, mesh8, k=6,
                                                  doc_block=8)
    t_index, _ = plaid_index_from_arrays(j_index.centroids, j_index.centroid_ids, j_index.codes, j_index.mask,
                                         j_index.bucket_weights, j_index.nbits, device=DEVICE)
    locals_ = []
    for r in range(S):
        rows = slice(r * 8, (r + 1) * 8)
        shard = CompressedTokenIndex(t_index.centroids, t_index.centroid_ids[rows], t_index.codes[rows],
                                     t_index.mask[rows], t_index.bucket_weights, t_index.nbits)
        locals_.append(maxsim_search_compressed(_t(q), _t(qm), shard, k=6, doc_block=8))
    got = _merged(locals_, 8, 6)
    assert_ranked_match(got.ids, got.scores, want.ids, want.scores, atol=ATOL)


@pytest.mark.parametrize("rescore_impl", ["gather", "factored"])
def test_sharded_plaid_search_matches_jax(plaid_pair, mesh8, rescore_impl):
    """test_plaid.py's sharded cases at exhaustive knobs (nprobe 32, ncand
    96: every shard doc a candidate), both rescore forms."""
    want_idx, got_idx, q, qm = plaid_pair
    want = jp.sharded_plaid_search(jnp.asarray(q), jnp.asarray(qm), jp.shard_plaid_index(want_idx, S, ivf_cap=96),
                                   mesh8, k=12, nprobe=32, ncand=96, cand_chunk=12, rescore_impl=rescore_impl,
                                   topk_impl="exact")
    locals_ = []
    for r in range(S):
        sh = plaid.shard_plaid_index(got_idx, S, ivf_cap=96, rank=r)
        per = sh.docs_per_shard  # ncand 96 → 12 per shard, the chunk 12, no prune tier
        locals_.append(plaid._plaid_shard_search(_t(q), _t(qm), sh, 32, per, 12, 0, rescore_impl, 12))
    got = _merged(locals_, per, 12)
    assert_ranked_match(got.ids, got.scores, want.ids, want.scores, atol=ATOL)


def test_sharded_functions_at_one_rank_equal_the_single_device_search(impact_pair, scatter_pair, plaid_pair):
    """Each public ``sharded_*`` function on a mesh of one rank (no group)
    returns its single-device search."""
    mesh = sharding.make_mesh(index=1, devices=[DEVICE])
    _, idx, qt, qw = impact_pair
    one = inverted.shard_impact_index(idx, 1)
    got = inverted.sharded_impact_search(_t(qt), _t(qw), one, mesh, k=8)
    want = inverted.impact_search(_t(qt), _t(qw), idx, k=8)
    assert torch.equal(got.ids, want.ids) and torch.equal(got.scores, want.scores)
    _, cidx, qt, qw = scatter_pair
    got = scatter_score.sharded_scatter_search(_t(qt), _t(qw), scatter_score.shard_chunked_impact_index(cidx, 1),
                                               mesh, k=50)
    want = scatter_score.scatter_impact_search(_t(qt), _t(qw), cidx, k=50)
    assert torch.equal(got.ids, want.ids) and torch.equal(got.scores, want.scores)
    _, pidx, q, qm = plaid_pair
    ivf = plaid.build_ivf(pidx.centroid_ids, pidx.mask, pidx.centroids.shape[0], cap=96)
    got = plaid.sharded_plaid_search(_t(q), _t(qm), plaid.shard_plaid_index(pidx, 1, ivf_cap=96), mesh, k=12,
                                     nprobe=32, ncand=96, cand_chunk=12)
    want = plaid.plaid_search(_t(q), _t(qm), pidx, ivf, k=12, nprobe=32, ncand=96, cand_chunk=12)
    assert torch.equal(got.ids, want.ids) and torch.equal(got.scores, want.scores)
    qt, ct, cm = _tokens()
    qm = torch.ones((3, 4))
    got = mips.sharded_dense_search(_t(ct[:, 0]), _t(ct[:, 1]), mesh, k=7, similarity="dot_score")
    want = mips.dense_search(_t(ct[:, 0]), _t(ct[:, 1]), k=7, similarity="dot_score")
    assert torch.equal(got.ids, want.ids) and torch.equal(got.scores, want.scores)
    got = mips.sharded_maxsim_search(_t(qt), qm, _t(ct), _t(cm), mesh, k=6)
    want = maxsim.maxsim_search(_t(qt), qm, _t(ct), _t(cm), k=6)
    assert torch.equal(got.ids, want.ids) and torch.equal(got.scores, want.scores)
    t_tm, valid = maxsim.prepare_token_corpus(_t(ct), _t(cm))
    got = mips.sharded_maxsim_search_tm(_t(qt), qm, t_tm, valid, mesh, k=6)
    want = maxsim.maxsim_search_tm(_t(qt), qm, t_tm, valid, k=6)
    assert torch.equal(got.ids, want.ids) and torch.equal(got.scores, want.scores)
    got = mips.sharded_maxsim_search_compressed(_t(q), _t(qm := np.ones((4, 5), np.float32)), pidx, mesh, k=6)
    want = maxsim_search_compressed(_t(q), _t(qm), pidx, k=6)
    assert torch.equal(got.ids, want.ids) and torch.equal(got.scores, want.scores)
    assert isinstance(got, RankedLists)
