"""``HybridPipeline`` and ``run_evaluation`` of fusion_tpu_torch against the
JAX package's, on the CPU with tiny models whose weights are converted from
the JAX models: each leg (BM25 with and without preprocessing, DPR, SPLADE,
ColBERT over the JAX token index converted into the port, the monoBERT
rerank), the fusion of one set of lists in every method, the analysis of
score distributions and the evaluation.

Tolerances: the legs at 1e-5 (f32 on the CPU; the encoders agree to ~1e-6,
sums run in another order), ids equal except within ties at that
tolerance; the fusion of identical lists at 1e-6; the metrics of identical
id lists exactly."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import DEVICE, assert_ranked_match

from fusion_tpu.core.ranked import RankedLists as JaxRanked
from fusion_tpu.hybrid import HybridPipeline as JaxPipeline
from fusion_tpu.hybrid import run_evaluation as jax_run_evaluation
from fusion_tpu.models.biencoder import BiEncoder as JaxBiEncoder
from fusion_tpu.models.colbert import ColBERT as JaxColBERT
from fusion_tpu.models.crossencoder import CrossEncoder as JaxCrossEncoder
from fusion_tpu.models.encoder import EncoderConfig as JaxConfig
from fusion_tpu_torch.core.ranked import RankedLists
from fusion_tpu_torch.hybrid import HybridPipeline, run_evaluation
from fusion_tpu_torch.models import convert
from fusion_tpu_torch.models.biencoder import BiEncoder
from fusion_tpu_torch.models.colbert import ColBERT, TokenIndex
from fusion_tpu_torch.models.crossencoder import CrossEncoder
from fusion_tpu_torch.models.encoder import EncoderConfig

ATOL = 1e-5
K = 20


def _corpus(seed=5, n=61, vocab=90):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    words = [f"mot{t}" for t in range(vocab)]
    docs = {
        500 + 3 * i: " ".join(rng.choice(words, size=rng.integers(4, 18), p=p)) for i in range(n)
    }
    queries = [" ".join(rng.choice(words, size=3, p=p)) for _ in range(6)] + ["", "mot7 zz"]
    labels = [[500 + 3 * int(i) for i in rng.choice(n, size=2, replace=False)] for _ in queries]
    return docs, queries, labels


CORPUS, QUERIES, LABELS = _corpus()


def _match(got, want, atol=ATOL):
    assert got.ids.dtype == torch.int32
    assert_ranked_match(got.ids.cpu(), got.scores.cpu(), np.asarray(want.ids), np.asarray(want.scores), atol=atol)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = JaxConfig.tiny(vocab_size=512), EncoderConfig.tiny(vocab_size=512)
    kw = dict(max_query_length=8, max_doc_length=24)
    jd, js = JaxBiEncoder(jcfg, head="dense", **kw), JaxBiEncoder(jcfg, head="splade", **kw)
    jc, jx = JaxColBERT(jcfg, dim=16, **kw), JaxCrossEncoder(jcfg, max_length=40)
    td = BiEncoder(tcfg, params=convert.encoder_state_dict(jd.params), head="dense", device=DEVICE, **kw)
    ts = BiEncoder(tcfg, params=convert.encoder_with_mlm_state_dict(js.params), head="splade", device=DEVICE, **kw)
    tc = ColBERT(tcfg, params=convert.colbert_state_dict(jc.params), dim=16, device=DEVICE, **kw)
    tx = CrossEncoder(tcfg, params=convert.crossencoder_state_dict(jx.params), max_length=40, device=DEVICE)
    return {"dense": (jd, td), "splade": (js, ts), "colbert": (jc, tc), "ce": (jx, tx)}


@pytest.fixture(scope="module")
def pipelines():
    return JaxPipeline(CORPUS), HybridPipeline(CORPUS, device=DEVICE)


@pytest.mark.parametrize("do_preprocessing", [True, False])
def test_bm25_search_matches_jax(pipelines, do_preprocessing):
    want_p, got_p = pipelines
    kw = dict(do_preprocessing=do_preprocessing, k1=1.2, b=0.75, return_topk=K)
    want = want_p.bm25_search(QUERIES, **kw)
    got = got_p.bm25_search(QUERIES, **kw)
    _match(got.ranked, want.ranked)
    assert got.latency_ms_per_query > 0
    # the index is built once per preprocessing choice and re-parameterized
    again = got_p.bm25_search(QUERIES, **{**kw, "k1": 2.5, "b": 0.2})
    _match(again.ranked, want_p.bm25_search(QUERIES, **{**kw, "k1": 2.5, "b": 0.2}).ranked)


@pytest.mark.parametrize("head", ["dense", "splade"])
def test_single_vector_search_matches_jax(pipelines, models, head):
    want_p, got_p = pipelines
    jm, tm = models[head]
    _match(got_p.single_vector_search(QUERIES, tm, return_topk=K, batch_size=16).ranked,
           want_p.single_vector_search(QUERIES, jm, return_topk=K, batch_size=16).ranked)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_multi_vector_search_matches_jax(pipelines, models, use_pallas):
    """Over JAX's token index converted into the port (the two packages'
    bf16 doc tokens may round an ulp apart); the port's prepared branch is
    the one that runs the MaxSim kernel on the card."""
    want_p, got_p = pipelines
    jc, tc = models["colbert"]
    j_index = jc.index(want_p.documents, batch_size=8)
    t_index = TokenIndex(torch.from_numpy(np.asarray(j_index.tokens, np.float32)).to(torch.bfloat16),
                         torch.from_numpy(np.array(j_index.mask)))
    want = want_p.multi_vector_search(QUERIES, jc, return_topk=K, index=j_index, use_pallas=False)
    got = got_p.multi_vector_search(QUERIES, tc, return_topk=K, index=t_index, use_pallas=use_pallas)
    _match(got.ranked, want.ranked)


def test_multi_vector_search_builds_its_own_index(pipelines, models):
    _, got_p = pipelines
    _, tc = models["colbert"]
    ranked = got_p.multi_vector_search(QUERIES, tc, return_topk=K).ranked
    assert ranked.ids.shape == (len(QUERIES), K) and bool((ranked.ids >= 0).all())


def _lists(seed: int):
    """The same per-system lists for both packages."""
    rng = np.random.default_rng(seed)
    n = len(CORPUS)
    out_j, out_t = {}, {}
    for s in ("bm25", "dpr", "splade", "colbert"):
        ids = np.stack([rng.permutation(n)[:K] for _ in QUERIES]).astype(np.int32)
        sc = -np.sort(-rng.normal(size=ids.shape), axis=1).astype(np.float32)
        ids[-1, -3:], sc[-1, -3:] = -1, -np.inf  # a short list
        out_j[s] = JaxRanked(jnp.asarray(ids), jnp.asarray(sc))
        out_t[s] = RankedLists(torch.from_numpy(ids), torch.from_numpy(sc))
    return out_j, out_t


def test_cross_encoder_search_matches_jax(pipelines, models):
    want_p, got_p = pipelines
    jx, tx = models["ce"]
    lj, lt = _lists(1)
    want = want_p.cross_encoder_search(QUERIES, lj["bm25"], jx, return_topk=8, batch_size=16)
    got = got_p.cross_encoder_search(QUERIES, lt["bm25"], tx, return_topk=8, batch_size=16)
    _match(got.ranked, want.ranked)


@pytest.mark.parametrize("method, norm", [("rrf", None), ("bcf", None), ("nsf", "min-max"), ("nsf", "z-score"),
                                          ("nsf", "arctan"), ("nsf", "percentile-rank")])
def test_fuse_matches_jax(pipelines, method, norm):
    want_p, got_p = pipelines
    lj, lt = _lists(2)
    tables = None
    if norm == "percentile-rank":
        from fusion_tpu.fusion.aggregator import build_percentile_distribution

        tables = {s: build_percentile_distribution(np.asarray(r.scores)[np.isfinite(np.asarray(r.scores))], 100)
                  for s, r in lj.items()}
    want = want_p.fuse(lj, method=method, normalization=norm, percentile_distributions=tables, return_topk=K)
    got = got_p.fuse(lt, method=method, normalization=norm, percentile_distributions=tables, return_topk=K)
    _match(got, want, atol=1e-6)


def test_evaluate_and_external_ids_match_jax(pipelines):
    want_p, got_p = pipelines
    lj, lt = _lists(3)
    fused_j = want_p.fuse(lj, return_topk=K)
    fused_t = got_p.fuse(lt, return_topk=K)
    assert got_p.to_external_ids(fused_t) == want_p.to_external_ids(fused_j)
    assert got_p.labels_to_internal(LABELS + [[1, 500]]) == want_p.labels_to_internal(LABELS + [[1, 500]])
    assert got_p.evaluate(fused_t, LABELS) == want_p.evaluate(fused_j, LABELS)
    internal = got_p.labels_to_internal(LABELS)
    assert got_p.evaluate(fused_t, internal, external_labels=False) == want_p.evaluate(
        fused_j, internal, external_labels=False)


def test_run_evaluation_matches_jax(capsys):
    preds = [[1, 2, 3], [4], [], [7, 8, 9, 10]]
    labels = [[2], [5], [1], [10, 7]]
    got = run_evaluation(preds, labels, print2console=True)
    printed = capsys.readouterr().out
    assert got == jax_run_evaluation(preds, labels, print2console=False)
    assert "- Recall@5:" in printed and len(got) == 8 + 2 + 2 + 2 + 1


@pytest.mark.parametrize("normalization", [None, "min-max"])
def test_analyze_score_distributions_matches_jax(pipelines, tmp_path, normalization):
    want_p, got_p = pipelines
    lj, lt = _lists(4)
    kw = dict(labels=LABELS, normalization=normalization, num_points=(10, 50), seed=7)
    want = want_p.analyze_score_distributions(lj, output_dir=str(tmp_path / "j"), **kw)
    got = got_p.analyze_score_distributions(lt, output_dir=str(tmp_path / "p"), **kw)
    assert sorted(got["all_scores"]) == sorted(want["all_scores"])
    for s in want["all_scores"]:
        np.testing.assert_allclose(got["all_scores"][s], want["all_scores"][s], atol=1e-6, rtol=0)
    assert sorted(got["distributions"]) == sorted(want["distributions"]) == [10, 50, len(CORPUS)]
    for n_pts, tables in want["distributions"].items():
        for s, table in tables.items():
            np.testing.assert_allclose(got["distributions"][n_pts][s], table, atol=1e-6, rtol=0)
    assert len(got["labeled"]) == len(want["labeled"])
    for g, w in zip(got["labeled"], want["labeled"]):
        assert g["label"] == w["label"]
        for s in lt:
            assert g[s] == pytest.approx(w[s], abs=1e-6)
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "j"))
