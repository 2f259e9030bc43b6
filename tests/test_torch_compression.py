"""The residual-compressed ColBERT index of fusion_tpu_torch
(index/compression.py) against the JAX package's: the same numpy-seeded
tokens through both, on the CPU.

Tolerances: the codec, the centroid assignment, the codes, the IVF-free
decompression (bf16) and the quantile cutoffs are bit-equal; Lloyd steps
from JAX's initial centroids agree within 1e-5 (f32 sums in another order);
the bucket weights within one f32 ulp (rtol 2.4e-7: numpy averages in f32
pairwise, the port in f64); the exhaustive compressed search within 1e-5
(on the CPU both packages score f32 queries)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import DEVICE

from fusion_tpu.index import compression as jc
from fusion_tpu_torch.index import compression as tc
from fusion_tpu_torch.models.convert import plaid_index_from_arrays


def _tokens(seed=5, n=48, ld=8, d=16):
    rng = np.random.default_rng(seed)
    toks = rng.standard_normal((n, ld, d)).astype(np.float32)
    toks /= np.linalg.norm(toks, axis=-1, keepdims=True)
    lens = rng.integers(2, ld + 1, size=n)
    mask = (np.arange(ld)[None, :] < lens[:, None]).astype(np.float32)
    mask[-1] = 0.0  # a fully padded doc
    return toks, mask


@pytest.fixture(scope="module")
def indexes():
    """A JAX-built index and the port's conversion of it."""
    toks, mask = _tokens()
    want = jc.compress_token_index(
        jnp.asarray(toks), jnp.asarray(mask), num_centroids=32, nbits=2, kmeans_iters=4
    )
    got, _ = plaid_index_from_arrays(
        want.centroids, want.centroid_ids, want.codes, want.mask, want.bucket_weights, want.nbits,
        device=DEVICE,
    )
    return toks, mask, want, got


@pytest.mark.parametrize("nbits", [1, 2, 4, 8])
def test_pack_and_unpack_match_jax(nbits):
    rng = np.random.default_rng(nbits)
    codes = rng.integers(0, 1 << nbits, size=(3, 5, 16))
    want = jc._pack_codes(codes, nbits)
    np.testing.assert_array_equal(tc._pack_codes(codes, nbits), want)
    np.testing.assert_array_equal(tc._pack_codes(torch.from_numpy(codes), nbits).numpy(), want)
    unpacked = tc._unpack_codes(torch.from_numpy(want), nbits, 16)
    assert unpacked.dtype == torch.int32
    np.testing.assert_array_equal(unpacked.numpy(), np.asarray(jc._unpack_codes_jnp(jnp.asarray(want), nbits, 16)))


@pytest.mark.parametrize("block_points", [7, 16384])
def test_assign_centroids_matches_jax(block_points):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((50, 8)).astype(np.float32)
    cents = rng.standard_normal((12, 8)).astype(np.float32)
    want = np.asarray(jc.assign_centroids(jnp.asarray(x), jnp.asarray(cents), block_points=block_points))
    got = tc.assign_centroids(torch.from_numpy(x), torch.from_numpy(cents), block_points=block_points)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,iters,block_points", [(8, 4, 16384), (16, 6, 64), (24, 3, 100)])
def test_lloyd_steps_from_jax_init_match_jax(k, iters, block_points):
    toks, mask = _tokens(seed=k)
    x = toks.reshape(-1, toks.shape[-1])[mask.reshape(-1) > 0]
    init = jc._kmeanspp_init(jnp.asarray(x), k, jax.random.PRNGKey(3))
    want = np.asarray(jc.kmeans(jnp.asarray(x), k=k, iters=iters, seed=3, block_points=block_points))
    got = tc.kmeans(torch.from_numpy(x), k, iters=iters, block_points=block_points,
                    init=torch.from_numpy(np.array(init)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_empty_clusters_reseed_like_jax(monkeypatch):
    """Duplicate initial centroids leave clusters empty; both re-seed them
    from the farthest points.  JAX's kmeans runs unjitted with its k-means++
    seeding replaced by the same initial centroids."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((40, 4)).astype(np.float32)
    init = np.repeat(x[:2], 3, axis=0)  # 6 centroids, 4 of them duplicates
    monkeypatch.setattr(jc, "_kmeanspp_init", lambda x_, k, key: jnp.asarray(init))
    want = np.asarray(jc.kmeans.__wrapped__(jnp.asarray(x), 6, iters=2, seed=0))
    got = tc.kmeans(torch.from_numpy(x), 6, iters=2, init=torch.from_numpy(init))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_own_kmeans_is_seeded_and_recovers_clusters():
    rng = np.random.default_rng(42)
    centers = np.array([[5.0, 0.0], [-5.0, 0.0], [0.0, 5.0], [0.0, -5.0]], dtype=np.float32)
    pts = np.concatenate([c + 0.1 * rng.normal(size=(50, 2)) for c in centers]).astype(np.float32)
    a = tc.kmeans(torch.from_numpy(pts), 4, iters=8, seed=7)
    b = tc.kmeans(torch.from_numpy(pts), 4, iters=8, seed=7)
    assert torch.equal(a, b)
    for c in centers:
        assert np.min(np.linalg.norm(a.numpy() - c, axis=-1)) < 0.5


def test_kmeans_seeds_from_a_permutation_above_kmeanspp_range(monkeypatch):
    rng = np.random.default_rng(1)
    pts = rng.standard_normal((30, 3)).astype(np.float32)
    monkeypatch.setattr(tc, "KMEANSPP_MAX_K", 2)
    got = tc.kmeans(torch.from_numpy(pts), 5, iters=0, seed=7)
    want = pts[np.random.default_rng(7).permutation(30)[:5]]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 5, 1001, 4096])
@pytest.mark.parametrize("levels", [2, 4, 16])
def test_quantile_cutoffs_and_codes_match_numpy(n, levels):
    rng = np.random.default_rng(n)
    vals = rng.standard_normal(n).astype(np.float32)
    want = np.quantile(vals, np.linspace(0, 1, levels + 1)[1:-1])
    got = tc._quantile_cutoffs(torch.from_numpy(vals), levels)
    np.testing.assert_array_equal(got, want)
    x = np.concatenate([
        rng.standard_normal(500).astype(np.float32), want.astype(np.float32),
        np.nextafter(want.astype(np.float32), np.float32(np.inf)),
        np.nextafter(want.astype(np.float32), np.float32(-np.inf)),
    ])
    np.testing.assert_array_equal(
        tc._bucketize(torch.from_numpy(x), want).numpy(), np.searchsorted(want, x)
    )


def _with_centroids(monkeypatch, centroids):
    """Make the port's k-means return the given (JAX's) centroids."""
    cents = torch.from_numpy(np.array(centroids))
    monkeypatch.setattr(tc, "kmeans", lambda *args, **kwargs: cents)


def test_compress_given_jax_centroids_matches_jax(indexes, monkeypatch):
    toks, mask, want, _ = indexes
    _with_centroids(monkeypatch, want.centroids)
    got = tc.compress_token_index(torch.from_numpy(toks), torch.from_numpy(mask), nbits=2)
    np.testing.assert_array_equal(got.centroid_ids.numpy(), np.asarray(want.centroid_ids))
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.bucket_weights.numpy(), np.asarray(want.bucket_weights), rtol=2.4e-7)
    assert got.nbits == 2 and got.nbytes() == want.nbytes()


def test_decompress_is_bit_equal_to_jax(indexes):
    _, _, want, got = indexes
    w = np.asarray(want.decompress(want.centroid_ids, want.codes).astype(jnp.float32))
    g = got.decompress(got.centroid_ids, got.codes)
    assert g.dtype == torch.bfloat16
    np.testing.assert_array_equal(g.float().numpy(), w)


def test_decompress_tm_and_layout_are_bit_equal_to_jax(indexes):
    _, _, want, got = indexes
    w_prep, g_prep = want.prepared(), got.prepared()
    assert got.prepared()[0] is g_prep[0]  # cached
    for w, g in zip(w_prep, g_prep):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    w = np.asarray(want.decompress_tm(*w_prep[:3]).astype(jnp.float32))
    np.testing.assert_array_equal(got.decompress_tm(*g_prep[:3]).float().numpy(), w)


@pytest.mark.parametrize("doc_block", [16, 48, 8192])
def test_maxsim_search_compressed_matches_jax(indexes, doc_block):
    _, _, want_index, got_index = indexes
    rng = np.random.default_rng(9)
    q = rng.standard_normal((4, 5, 16)).astype(np.float32)
    qm = np.ones((4, 5), np.float32)
    qm[2, 3:] = 0.0
    # on the CPU both packages score f32 queries (bf16 only on the card)
    want = jc.maxsim_search_compressed(
        jnp.asarray(q), jnp.asarray(qm), want_index, k=20, doc_block=doc_block, use_pallas=False
    )
    got = tc.maxsim_search_compressed(
        torch.from_numpy(q), torch.from_numpy(qm), got_index, k=20, doc_block=doc_block
    )
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    # the fully padded doc never ranks
    assert (got.ids.numpy() != 47).all()


def test_own_build_reconstructs_and_compresses():
    toks, mask = _tokens(seed=11, n=64)
    timings = {}
    index = tc.compress_token_index(
        torch.from_numpy(toks), torch.from_numpy(mask), num_centroids=32, nbits=2,
        kmeans_iters=6, timings=timings,
    )
    assert set(timings) == {"kmeans", "compress"}
    assert index.centroids.shape == (32, 16) and index.codes.shape == (64, 8, 4)
    recon = index.decompress(index.centroid_ids, index.codes).float().numpy()
    err = np.abs(recon - toks)[mask > 0].mean()
    assert err < 0.15, err
    assert index.nbytes() < 0.35 * toks.nbytes
    bw = index.bucket_weights.numpy()
    assert (np.diff(bw) > 0).all()  # bucket means rise with the quantiles


def test_colbert_index_compressed_from_converted_weights(monkeypatch):
    from fusion_tpu.models.colbert import ColBERT as JaxColBERT
    from fusion_tpu.models.encoder import EncoderConfig as JaxConfig
    from fusion_tpu_torch.models import convert
    from fusion_tpu_torch.models.colbert import ColBERT
    from fusion_tpu_torch.models.encoder import EncoderConfig

    docs = [f"document numéro {i} avec des mots t{i} t{i + 1}" for i in range(12)]
    jm = JaxColBERT(JaxConfig.tiny(vocab_size=256), dim=16, max_query_length=8, max_doc_length=16)
    tm = ColBERT(EncoderConfig.tiny(vocab_size=256), params=convert.colbert_state_dict(jm.params),
                 dim=16, max_query_length=8, max_doc_length=16, device=DEVICE)
    want = jm.index_compressed(docs, batch_size=4, pad_docs_to=4, nbits=2, num_centroids=32)
    timings = {}
    got = tm.index_compressed(docs, batch_size=4, pad_docs_to=4, nbits=2, num_centroids=32, timings=timings)
    assert set(timings) == {"encode", "kmeans", "compress"}
    assert got.codes.shape == tuple(want.codes.shape) and got.centroids.shape == tuple(want.centroids.shape)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    # the same tokens compressed against JAX's centroids give JAX's index
    raw = tm.index(docs, batch_size=4, pad_docs_to=4)
    _with_centroids(monkeypatch, want.centroids)
    again = tc.compress_token_index(raw.tokens.float(), raw.mask, nbits=2)
    agree = (again.centroid_ids.numpy() == np.asarray(want.centroid_ids)).mean()
    assert agree >= 0.99, agree  # the encoders agree to ~1e-6, so a near-tie may flip
