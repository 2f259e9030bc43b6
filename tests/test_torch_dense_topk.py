"""fusion_tpu_torch's binned dense top-k (the plain version of kernel K2,
which a CPU tensor runs) and int8 corpus against the JAX package's
reference path (``use_pallas=False``).

Bit-exact where both sides see the same f32 inputs: the bin reduction and
packing, the unpack and selection, int8 quantization.  Where the scores come
from a matmul (XLA and torch sum in another order), scores agree at atol
1e-6 and ids except inside runs of near-ties (``assert_ranked_match``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_ranked_match

from fusion_tpu.index import dense_quant as jax_quant
from fusion_tpu.ops import dense_topk as jax_topk
from fusion_tpu_torch.index import dense_quant
from fusion_tpu_torch.ops import _kernels, dense_topk

ATOL = 1e-6


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def _scores(rng, kind: str, q=5, b=256) -> np.ndarray:
    s = rng.normal(size=(q, b)).astype(np.float32)
    if kind == "neg_inf":  # masked docs, and a whole bin of them
        s[0, 3] = -np.inf
        s[1, 7::16] = -np.inf
        s[2, :] = -np.inf
    elif kind == "dead":  # dead rows beside real negative scores
        s[:, ::3] = jax_topk._DEAD
        s[:, 1::3] = -np.abs(s[:, 1::3])
    elif kind == "ties":  # equal scores inside a bin: the lowest offset wins
        s[:, 5::16] = 0.75
        s[1] = 0.0
    return s


@pytest.mark.parametrize("kind", ["normal", "neg_inf", "dead", "ties"])
@pytest.mark.parametrize("doc0, n_docs", [(0, 256), (512, 700), (0, 200)])
def test_bin_reduce_pack_bit_exact(rng, kind, doc0, n_docs):
    s = _scores(rng, kind)
    want = jax_topk._bin_reduce_pack(jnp.asarray(s), jnp.int32(doc0), n_docs)
    got = dense_topk._bin_reduce_pack(torch.from_numpy(s), doc0, n_docs)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("kind", ["normal", "neg_inf", "dead", "ties"])
@pytest.mark.parametrize("k", [7, 40])  # 40 > the 32 bins: padded columns
def test_unpack_and_select_bit_exact(rng, kind, k):
    doc_block = 128
    s = _scores(rng, kind)  # 2 blocks of 128 docs → 32 bins
    packed = np.concatenate(
        [np.asarray(jax_topk._bin_reduce_pack(jnp.asarray(s[:, i : i + 128]), jnp.int32(i), 250))
         for i in (0, 128)],
        axis=1,
    )
    want = jax_topk._select_topk(jnp.asarray(packed), 250, k, doc_block, 0.99)
    got = dense_topk._select_topk(torch.from_numpy(packed), 250, k, doc_block)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(_bits(got.scores.numpy()), _bits(want.scores))


@pytest.mark.parametrize("similarity", ["dot_score", "cos_sim"])
def test_quantize_dense_index_matches(rng, similarity):
    x = rng.normal(size=(300, 48)).astype(np.float32)
    x[7] = 0.0  # an all-zero row: scale clamps to 1e-12
    want = jax_quant.quantize_dense_index(jnp.asarray(x), similarity)
    got = dense_quant.quantize_dense_index(torch.from_numpy(x), similarity)
    assert got.normalized == want.normalized
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    if similarity == "dot_score":
        np.testing.assert_array_equal(_bits(got.scales.numpy()), _bits(want.scales))
    else:  # the l2 norm sums in another order: an ulp apart
        np.testing.assert_allclose(got.scales.numpy(), np.asarray(want.scales), rtol=2e-7)


@pytest.mark.parametrize("doc_block", [65536, 64, 37])
def test_quantized_dense_search_matches(rng, doc_block):
    x = rng.normal(size=(203, 32)).astype(np.float32)
    q = rng.normal(size=(4, 32)).astype(np.float32)
    want_idx = jax_quant.quantize_dense_index(jnp.asarray(x), "cos_sim")
    got_idx = dense_quant.quantize_dense_index(torch.from_numpy(x), "cos_sim")
    # scale-0 pad rows (the binned kernel's layout) never rank
    want_idx = want_idx._replace(
        values=jnp.pad(want_idx.values, ((0, 21), (0, 0))), scales=jnp.pad(want_idx.scales, (0, 21))
    )
    pad = torch.nn.functional.pad
    got_idx = got_idx._replace(
        values=pad(got_idx.values, (0, 0, 0, 21)), scales=pad(got_idx.scales, (0, 21))
    )
    want = jax_quant.quantized_dense_search(jnp.asarray(q), want_idx, k=210, doc_block=doc_block)
    got = dense_quant.quantized_dense_search(torch.from_numpy(q), got_idx, k=210, doc_block=doc_block)
    assert_ranked_match(got.ids, got.scores, want.ids, want.scores, atol=ATOL)
    assert (got.ids.numpy()[:, :203] < 203).all() and (got.ids.numpy()[:, 203:] == -1).all()


@pytest.mark.parametrize(
    "n, k, n_docs, dead",
    [
        (300, 20, None, False),  # N not a multiple of the block: a padded copy
        (256, 100, None, True),  # dead rows, k past the bins (padded columns)
        (512, 30, 450, False),  # a pre-padded index with its real row count
    ],
)
def test_fused_dense_topk_matches(rng, n, k, n_docs, dead):
    x = rng.normal(size=(n, 32)).astype(np.float32)
    q = rng.normal(size=(3, 32)).astype(np.float32)
    want_idx = jax_quant.quantize_dense_index(jnp.asarray(x), "cos_sim")
    got_idx = dense_quant.quantize_dense_index(torch.from_numpy(x), "cos_sim")
    if dead:  # scale 0: the dead-row convention of build pads
        rows = np.arange(0, n, 3)
        want_idx = want_idx._replace(scales=want_idx.scales.at[rows].set(0.0))
        got_idx.scales[torch.from_numpy(rows)] = 0.0
    want = jax_topk.fused_dense_topk(
        jnp.asarray(q), want_idx, k=k, doc_block=64, use_pallas=False, n_docs=n_docs
    )
    got = dense_topk.fused_dense_topk(torch.from_numpy(q), got_idx, k=k, doc_block=64, n_docs=n_docs)
    assert got.ids.dtype == torch.int32 and got.ids.shape == (3, k)
    assert_ranked_match(got.ids, got.scores, want.ids, want.scores, atol=ATOL)
    real = got.ids.numpy()[np.isfinite(got.scores.numpy())]
    assert (real >= 0).all() and (real < (n_docs or n)).all()


def test_binmax_plain_steps_agree(rng):
    """The plain version's multi-block matmul steps give the same packed
    maxima whatever the step size."""
    q = torch.from_numpy(rng.normal(size=(3, 32)).astype(np.float32)).to(torch.bfloat16)
    idx = dense_quant.quantize_dense_index(torch.from_numpy(rng.normal(size=(4096, 32)).astype(np.float32)))
    one = dense_topk.binmax_plain(q, idx.values, idx.scales, 4000, doc_block=512, rows_per_step=512)
    many = dense_topk.binmax_plain(q, idx.values, idx.scales, 4000, doc_block=512)
    np.testing.assert_array_equal(_bits(one.numpy()), _bits(many.numpy()))


def test_cpu_tensors_never_reach_the_kernel(rng):
    idx = dense_quant.quantize_dense_index(torch.from_numpy(rng.normal(size=(2048, 32)).astype(np.float32)))
    q = torch.from_numpy(rng.normal(size=(2, 32)).astype(np.float32))
    before = dense_topk.binmax_cuda.launches
    dense_topk.fused_dense_topk(q, idx, k=5)
    assert dense_topk.binmax_cuda.launches == before == 0
    assert _kernels.load.cache_info().currsize == 0  # nothing was built
    with pytest.raises(ValueError, match="CUDA"):
        dense_topk.binmax_cuda(q.to(torch.bfloat16), idx.values, idx.scales, 2048)
