"""fusion_tpu_torch core ranking ops against the JAX package: ranked lists,
top-k merges and blocked scans, on inputs full of ties.  Ids and scores must
be exactly equal (ties rank by ascending index in both)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusion_tpu.core.ranked import RankedLists as JaxRanked
from fusion_tpu.core.ranked import ranked_from_scores as jax_ranked_from_scores
from fusion_tpu.ops import topk as jax_topk
from fusion_tpu_torch.core.ranked import PAD_ID, RankedLists, ranked_from_scores, stable_topk
from fusion_tpu_torch.ops import topk as torch_topk


def _tied_scores(rng, q, n, levels=5):
    """Scores drawn from a few levels (dense ties) plus -inf holes."""
    s = rng.integers(0, levels, size=(q, n)).astype(np.float32) / levels
    s[rng.random((q, n)) < 0.1] = -np.inf
    return s


def _assert_same(got: RankedLists, want):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))


def test_stable_topk_keeps_lower_index_on_ties():
    vals, idx = stable_topk(torch.tensor([1.0, 3.0, 3.0, 2.0, 3.0]), 3)
    assert idx.tolist() == [1, 2, 4] and vals.tolist() == [3.0, 3.0, 3.0]


@pytest.mark.parametrize("k", [1, 7, 40])
def test_ranked_from_scores_matches_jax(rng, k):
    s = _tied_scores(rng, 4, 40)
    _assert_same(ranked_from_scores(torch.from_numpy(s), k), jax_ranked_from_scores(jnp.asarray(s), k))


def test_merge_topk_matches_jax(rng):
    acc = _tied_scores(rng, 3, 8)
    acc_ids = rng.integers(0, 100, size=(3, 8)).astype(np.int32)
    blk = _tied_scores(rng, 3, 12)
    blk_ids = rng.integers(100, 200, size=(3, 12)).astype(np.int32)
    got = torch_topk.merge_topk(*map(torch.from_numpy, (acc, acc_ids, blk, blk_ids)))
    want = jax_topk.merge_topk(*map(jnp.asarray, (acc, acc_ids, blk, blk_ids)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("local_topk", [None, "exact"])
def test_blockwise_topk_matches_jax(rng, local_topk):
    q, n, block, k = 3, 70, 16, 5
    s = _tied_scores(rng, q, n + block)  # the tail block overhangs: masked
    s[:, n:] = -np.inf
    nb = -(-n // block)

    def jax_block(bi):  # bi is traced inside lax.scan
        blk = jax.lax.dynamic_slice_in_dim(jnp.asarray(s), bi * block, block, axis=1)
        return blk, jnp.broadcast_to(bi * block + jnp.arange(block, dtype=jnp.int32), (q, block))

    def torch_block(bi):
        ids = bi * block + torch.arange(block)
        return torch.from_numpy(s)[:, ids], ids.expand(q, block)

    want = jax_topk.blockwise_topk(jax_block, nb, q, k, local_topk=local_topk)
    got = torch_topk.blockwise_topk(torch_block, nb, q, k, local_topk=local_topk)
    _assert_same(got, want)

    want_off = jax_topk.blockwise_topk_offset(
        lambda bi: (jax_block(bi)[0], bi * block), nb, q, k, local_topk=local_topk
    )
    got_off = torch_topk.blockwise_topk_offset(
        lambda bi: (torch_block(bi)[0], bi * block), nb, q, k, local_topk=local_topk
    )
    _assert_same(got_off, want_off)


def test_approx_local_topk_is_not_ported():
    """``local_topk='approx'`` is served now, by the exact select."""
    scores = torch.arange(40, dtype=torch.float32).reshape(2, 20).flip(-1)
    block = lambda bi: (scores[:, bi * 5 : bi * 5 + 5], torch.arange(bi * 5, bi * 5 + 5).expand(2, 5))  # noqa: E731
    got = torch_topk.blockwise_topk(block, 4, 2, 2, local_topk="approx")
    want = torch_topk.blockwise_topk(block, 4, 2, 2, local_topk="exact")
    assert torch.equal(got.ids, want.ids) and torch.equal(got.scores, want.scores)


def test_remap_ids_keeps_pads():
    ranked = RankedLists(
        torch.tensor([[2, 0, PAD_ID]], dtype=torch.int32), torch.tensor([[3.0, 2.0, -np.inf]])
    )
    table = np.array([11, 22, 33], dtype=np.int64)
    got = ranked.remap_ids(table)
    want = JaxRanked(jnp.asarray(ranked.ids.numpy()), jnp.asarray(ranked.scores.numpy())).remap_ids(table)
    _assert_same(got, want)
    assert got.id_lists() == [[33, 11]]
