"""fusion_tpu_torch BM25 index, exact dense search and rank fusion against
the JAX package, on the same seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import DEVICE, assert_ranked_match

from fusion_tpu.core.ranked import RankedLists as JaxRanked
from fusion_tpu.fusion.aggregator import Aggregator as JaxAggregator
from fusion_tpu.fusion.aggregator import transform_scores as jax_transform
from fusion_tpu.models.bm25 import BM25Index as JaxBM25
from fusion_tpu.ops.mips import dense_search as jax_dense_search
from fusion_tpu_torch.core.ranked import RankedLists
from fusion_tpu_torch.fusion.aggregator import Aggregator, transform_scores
from fusion_tpu_torch.models.bm25 import BM25Index
from fusion_tpu_torch.ops.mips import dense_search


def _zipf_docs(rng, n, vocab=60):
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    return [
        " ".join(f"t{t}" for t in rng.choice(vocab, size=rng.integers(3, 15), p=p))
        for _ in range(n)
    ]


@pytest.mark.parametrize("variant", ["bm25", "atire", "tfidf"])
def test_bm25_build_and_dense_impacts_equal(rng, variant):
    docs = _zipf_docs(rng, 40)
    want = JaxBM25.build(docs, k1=2.5, b=0.2, variant=variant, pad_multiple=64, use_native=False)
    got = BM25Index.build(docs, k1=2.5, b=0.2, variant=variant, pad_multiple=64, device=DEVICE)
    assert got.vocab == want.vocab and got.nnz == want.nnz and got.avgdl == want.avgdl
    for name in ("entry_term", "entry_doc", "entry_tf", "idf", "doc_len"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    np.testing.assert_array_equal(
        got.build_dense_impacts().float().numpy(),
        np.asarray(want.build_dense_impacts(), dtype=np.float32),
    )
    queries = ["t0 t3 t3 zz", "t1", ""]
    for g, w in zip(got.encode_queries_np(queries), want.encode_queries_np(queries)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("similarity", ["cos_sim", "dot_score"])
@pytest.mark.parametrize("doc_block", [65536, 16])
def test_dense_search_bf16_corpus(rng, similarity, doc_block):
    q = rng.normal(size=(5, 24)).astype(np.float32)
    corpus = rng.normal(size=(50, 24)).astype(np.float32)
    corpus[7] = corpus[3]  # an exact tie
    jq, jc = jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(corpus).astype(jnp.bfloat16)
    want = jax_dense_search(jq, jc, k=12, similarity=similarity, doc_block=doc_block)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tc = torch.from_numpy(corpus).to(torch.bfloat16)
    got = dense_search(tq, tc, k=12, similarity=similarity, doc_block=doc_block)
    # dot_score: exact bf16 products, f32 sums in another order.  cos_sim also
    # normalizes in bf16, where XLA and torch round a few elements one bf16
    # ulp apart; a cosine is at most 1, so allow one ulp of it (2^-8)
    atol = 1e-6 if similarity == "dot_score" else 2.0**-8
    assert_ranked_match(got.ids, got.scores, want.ids, want.scores, atol=atol)


def _system_lists(rng, q=4, k=10, n_docs=25):
    """Per-system ranked lists with shared ids, tied scores and pad tails."""
    lists = {}
    for s, system in enumerate(("bm25", "dpr", "colbert")):
        ids = np.stack([rng.permutation(n_docs)[:k] for _ in range(q)]).astype(np.int32)
        scores = -np.sort(-np.round(rng.normal(size=(q, k)) * 4) / 4, axis=1).astype(np.float32)
        ids[s, k - 3 :] = -1
        scores[s, k - 3 :] = -np.inf
        lists[system] = (ids, scores)
    return lists


@pytest.mark.parametrize(
    "method,normalization",
    [("rrf", None), ("bcf", None), ("nsf", "min-max"), ("nsf", "z-score"), ("nsf", "arctan")],
)
def test_fuse_matches_jax(rng, method, normalization):
    lists = _system_lists(rng)
    weights = {"bm25": 0.2, "dpr": 0.5, "colbert": 0.3} if method == "nsf" else None
    want = JaxAggregator.fuse(
        {s: JaxRanked(jnp.asarray(i), jnp.asarray(v)) for s, (i, v) in lists.items()},
        method=method, normalization=normalization, linear_weights=weights, return_topk=12,
    )
    got = Aggregator.fuse(
        {s: RankedLists(torch.from_numpy(i), torch.from_numpy(v)) for s, (i, v) in lists.items()},
        method=method, normalization=normalization, linear_weights=weights, return_topk=12,
    )
    assert_ranked_match(got.ids, got.scores, want.ids, want.scores, atol=1e-6)


@pytest.mark.parametrize("transformation", ["percentile-rank", "normal-curve-equivalent"])
def test_percentile_transforms_match_jax(rng, transformation):
    ids, scores = _system_lists(rng)["bm25"]
    table = np.quantile(rng.normal(size=500), np.linspace(0, 1, 101)).astype(np.float32)
    want = jax_transform(JaxRanked(jnp.asarray(ids), jnp.asarray(scores)), transformation, table)
    got = transform_scores(RankedLists(torch.from_numpy(ids), torch.from_numpy(scores)), transformation, table)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-5, rtol=0)
