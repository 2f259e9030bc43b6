"""The host-side pieces of the port's evaluation surface against the JAX
package's, where both are numpy and must agree exactly: ``Metrics`` (every
metric, the nonstandard nDCG / IDCG included), ``relevance_matrix``,
``compute_precision_recall_f1``, the ranking TSV files, the loggers' CSV,
the percentile tables, ``simplex_grid`` and ``tune_fusion_weights``, the
BM25 preprocessor and the LLeQA loader; and the percentile-NSF searcher
against the JAX searcher's (atol 1e-5: percentile ranks of f32 scores that
agree to ~1e-6)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_serving import CORPUS, QUERIES
from torch_parity import DEVICE, assert_ranked_match

from fusion_tpu.core.ranked import RankedLists as JaxRanked
from fusion_tpu.data.lleqa import LLeQALoader as JaxLLeQA
from fusion_tpu.data.preprocessor import TextPreprocessor as JaxPreprocessor
from fusion_tpu.eval import metrics as jax_metrics
from fusion_tpu.fusion import aggregator as jax_agg
from fusion_tpu.models.biencoder import BiEncoder as JaxBiEncoder
from fusion_tpu.models.encoder import EncoderConfig as JaxConfig
from fusion_tpu.serving import HybridSearcher as JaxSearcher
from fusion_tpu.utils import loggers as jax_loggers
from fusion_tpu.utils import rankingio as jax_rankingio
from fusion_tpu_torch.core.ranked import RankedLists
from fusion_tpu_torch.data.lleqa import LLeQALoader
from fusion_tpu_torch.data.preprocessor import TextPreprocessor
from fusion_tpu_torch.eval import metrics
from fusion_tpu_torch.fusion import aggregator
from fusion_tpu_torch.models import convert
from fusion_tpu_torch.models.biencoder import BiEncoder
from fusion_tpu_torch.models.encoder import EncoderConfig
from fusion_tpu_torch.serving import HybridSearcher
from fusion_tpu_torch.utils import loggers, rankingio

SUITE = dict(recall_at_k=[1, 5, 10, 50, 100, 1000], map_at_k=[1, 10, 100], mrr_at_k=[1, 10, 100],
             ndcg_at_k=[1, 5, 10, 100], accuracy_at_k=[1, 3, 10])


def _ranked_case(seed: int, q=37, k=60, n=200, max_gold=7):
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.permutation(n)[:k] for _ in range(q)]).astype(np.int32)
    ids[rng.random(ids.shape) < 0.05] = -1  # pads inside rows (short lists)
    ids[0] = -1  # an empty result list
    gold = [list(rng.choice(n, size=rng.integers(0, max_gold + 1), replace=False)) for _ in range(q)]
    gold[1] = []  # a query without relevant docs
    gold[2] = [int(x) for x in ids[2, :3] if x >= 0]  # hits at the top
    scores = -np.sort(-rng.random(ids.shape), axis=1).astype(np.float32)
    return ids, scores, gold


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_metrics_match_jax_exactly(seed):
    ids, scores, gold = _ranked_case(seed)
    want = jax_metrics.Metrics(**SUITE).compute_all_metrics(gold, JaxRanked(jnp.asarray(ids), jnp.asarray(scores)))
    got = metrics.Metrics(**SUITE).compute_all_metrics(gold, RankedLists(torch.from_numpy(ids), torch.from_numpy(scores)))
    assert got == want  # exact: the same numpy arithmetic
    lists = [[int(x) for x in row if x >= 0] for row in ids]
    assert metrics.Metrics(**SUITE).compute_all_metrics(gold, lists) == jax_metrics.Metrics(**SUITE).compute_all_metrics(gold, lists)


@pytest.mark.parametrize("seed", [0, 1])
def test_per_query_metrics_and_relevance_matrix_match_jax(seed):
    ids, _, gold = _ranked_case(seed)
    g = jax_metrics._pad_gold(gold)
    np.testing.assert_array_equal(metrics.relevance_matrix(ids, g), jax_metrics.relevance_matrix(ids, g))
    want = jax_metrics.Metrics(**SUITE).per_query_metrics(ids, g)
    got = metrics.Metrics(**SUITE).per_query_metrics(ids, g)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_nonstandard_ndcg_by_hand():
    """Binary gains, position 0 undiscounted, position i >= 1 divided by
    log2(i + 1); IDCG puts every gold doc at the top."""
    got = metrics.Metrics(ndcg_at_k=[3]).compute_all_metrics([[7, 9]], [[5, 7, 9]])["ndcg@3"]
    dcg = 1.0 / np.log2(2) + 1.0 / np.log2(3)
    idcg = 1.0 + 1.0 / np.log2(2)
    assert got == pytest.approx(dcg / idcg, abs=0)


@pytest.mark.parametrize("gold, pred", [([1, 2, 3], [2, 3, 4, 5]), ([1], []), ([], [1]), ([4], None), ([1, 2], [1, 2])])
def test_precision_recall_f1_matches_jax(gold, pred):
    assert metrics.compute_precision_recall_f1(gold, pred) == jax_metrics.compute_precision_recall_f1(gold, pred)


def test_ranking_tsv_round_trip_and_evaluation_match_jax(tmp_path):
    ids, scores, gold = _ranked_case(4, q=9, k=12, n=30)
    idx2id = np.arange(1000, 1030)
    qids = list(range(50, 59))
    n = rankingio.write_ranking_tsv(str(tmp_path / "p.tsv"), RankedLists(torch.from_numpy(ids), torch.from_numpy(scores)),
                                    qids, idx2id=idx2id)
    m = jax_rankingio.write_ranking_tsv(str(tmp_path / "j.tsv"), JaxRanked(jnp.asarray(ids), jnp.asarray(scores)),
                                        qids, idx2id=idx2id)
    assert n == m and (tmp_path / "p.tsv").read_text() == (tmp_path / "j.tsv").read_text()
    assert rankingio.read_ranking_tsv(str(tmp_path / "p.tsv")) == jax_rankingio.read_ranking_tsv(str(tmp_path / "j.tsv"))
    qrels = {q: [int(x) + 1000 for x in g] for q, g in zip(qids + [99], gold[:9] + [[1001]])}
    assert rankingio.evaluate_ranking_file(str(tmp_path / "p.tsv"), qrels) == jax_rankingio.evaluate_ranking_file(
        str(tmp_path / "j.tsv"), qrels)


def test_loggers_write_the_jax_package_s_files(tmp_path):
    rows = [{"k1": 0.5, "b": 0.1, "recall@100": 0.25}, {"k1": 1.0, "b": 0.2, "recall@100": 0.5}]
    loggers.write_metrics_csv(str(tmp_path / "p.csv"), rows)
    loggers.write_metrics_csv(str(tmp_path / "p.csv"), rows[:1], append=True)
    jax_loggers.write_metrics_csv(str(tmp_path / "j.csv"), rows)
    jax_loggers.write_metrics_csv(str(tmp_path / "j.csv"), rows[:1], append=True)
    assert (tmp_path / "p.csv").read_text() == (tmp_path / "j.csv").read_text()
    log = loggers.JSONLLogger(str(tmp_path), "run")
    log.log_training(0, 10, 3, 1e-3, 0.5)
    log.log_eval(0, 3, "dev/recall@10", 0.75)
    records = [json.loads(line) for line in open(log.path)]
    assert [r["kind"] for r in records] == ["train", "eval"] and records[1]["value"] == 0.75
    loggers.write_tuning_heatmap(str(tmp_path / "h.pdf"), rows)
    assert (tmp_path / "h.pdf").read_bytes()[:4] == b"%PDF"


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("num_points", [10, 1000])
def test_percentile_distribution_matches_jax(seed, num_points):
    rng = np.random.default_rng(seed)
    s = np.concatenate([rng.normal(size=500), np.zeros(20), np.full(3, -9.0), np.full(2, -8.0)]).astype(np.float32)
    np.testing.assert_array_equal(aggregator.build_percentile_distribution(s, num_points),
                                  jax_agg.build_percentile_distribution(s, num_points))
    np.testing.assert_array_equal(aggregator.build_percentile_distribution(np.zeros(5), 7),
                                  jax_agg.build_percentile_distribution(np.zeros(5), 7))


@pytest.mark.parametrize("systems, step", [(["a", "b"], 0.05), (["bm25", "dpr", "splade"], 0.1),
                                           (["a", "b", "c", "d"], 0.25)])
def test_simplex_grid_matches_jax(systems, step):
    assert aggregator.simplex_grid(systems, step) == jax_agg.simplex_grid(systems, step)


@pytest.mark.parametrize("normalization", ["min-max", "z-score", "percentile-rank"])
def test_tune_fusion_weights_matches_jax(normalization):
    rng = np.random.default_rng(9)
    lists, jax_lists, tables = {}, {}, {}
    for s in ("bm25", "dpr", "colbert"):
        ids = np.stack([rng.permutation(40)[:15] for _ in range(6)]).astype(np.int32)
        sc = -np.sort(-rng.normal(size=ids.shape), axis=1).astype(np.float32)
        lists[s] = RankedLists(torch.from_numpy(ids), torch.from_numpy(sc))
        jax_lists[s] = JaxRanked(jnp.asarray(ids), jnp.asarray(sc))
        tables[s] = jax_agg.build_percentile_distribution(sc, num_points=100)
    labels = [list(rng.choice(40, size=2, replace=False)) for _ in range(6)]
    ev = metrics.Metrics(recall_at_k=[5, 10]), jax_metrics.Metrics(recall_at_k=[5, 10])
    kw = dict(normalization=normalization, step=0.25, select_by="recall@5",
              percentile_distributions=tables if normalization == "percentile-rank" else None)
    best, rows = aggregator.tune_fusion_weights(lists, labels, lambda f: ev[0].compute_all_metrics(labels, f), **kw)
    jbest, jrows = jax_agg.tune_fusion_weights(jax_lists, labels, lambda f: ev[1].compute_all_metrics(labels, f), **kw)
    assert best == jbest and len(rows) == len(jrows)
    for r, j in zip(rows, jrows):
        assert r.keys() == j.keys()
        for key in r:
            assert r[key] == pytest.approx(j[key], abs=1e-12), key


TEXTS = [
    "Les travaux du bail sont à charge du locataire depuis 2019 !",
    "L'employeur contestent les congés; d'une part les loyers augmentent.",
    "Où dort le chat noir ? Les chevaux mangent des végétaux.",
    "",
]


@pytest.mark.parametrize("stemmer", ["auto", "light"])
@pytest.mark.parametrize("lemmatize", [True, False])
def test_preprocessor_matches_jax(stemmer, lemmatize):
    want = JaxPreprocessor(spacy_model=None, stemmer=stemmer).preprocess(TEXTS, lemmatize=lemmatize)
    assert TextPreprocessor(spacy_model=None, stemmer=stemmer).preprocess(TEXTS, lemmatize=lemmatize) == want


LLEQA = {
    "corpus": [{"id": 3, "article": "art trois", "description": "titre"}, {"id": 1, "article": "art un"},
               {"id": 2, "article": None, "description": "vide"}],
    "questions": {
        "train": [{"id": 10, "question": "q dup", "article_ids": [1]}, {"id": 11, "question": "q a", "article_ids": [3]},
                  {"id": 12, "question": "q syn", "article_ids": [2], "synthetic": True}],
        "dev": [{"id": 20, "question": "q dup", "article_ids": ["3"]}],
        "test": [{"id": 30, "question": "q t", "article_ids": [1, 2]}],
    },
    "negatives": {"10": {"bm25": [2, 3], "dpr": [1]}},
}


@pytest.mark.parametrize("synthetic", [False, True])
@pytest.mark.parametrize("title", [False, True])
def test_lleqa_loader_matches_jax(synthetic, title):
    neg = {int(k): v for k, v in LLEQA["negatives"].items()}
    want = JaxLLeQA.from_records(LLEQA["corpus"], LLEQA["questions"], neg, add_doc_title=title)
    got = LLeQALoader.from_records(LLEQA["corpus"], LLEQA["questions"], neg, add_doc_title=title)
    w, g = want.load(synthetic=synthetic), got.load(synthetic=synthetic)
    assert (g.corpus, g.queries, g.qrels) == (w.corpus, w.queries, w.qrels)
    for split in ("train", "dev", "test"):
        assert g.split(split) == w.split(split)
    assert got.hard_negatives() == want.hard_negatives()


def test_lleqa_loader_without_records_names_the_fixture():
    with pytest.raises(NotImplementedError, match="fixture"):
        LLeQALoader()


@pytest.fixture(scope="module")
def nsf_searchers():
    jcfg, tcfg = JaxConfig.tiny(vocab_size=512), EncoderConfig.tiny(vocab_size=512)
    kw = dict(max_query_length=8, max_doc_length=16)
    jd, js = JaxBiEncoder(jcfg, head="dense", **kw), JaxBiEncoder(jcfg, head="splade", **kw)
    td = BiEncoder(tcfg, params=convert.encoder_state_dict(jd.params), head="dense", device=DEVICE, **kw)
    ts = BiEncoder(tcfg, params=convert.encoder_with_mlm_state_dict(js.params), head="splade", device=DEVICE, **kw)
    common = dict(bm25_docs=list(CORPUS.values()), batch_size=4, topk=8, fusion_method="nsf")
    want = JaxSearcher.build(CORPUS, dense_model=jd, splade_model=js, **common)
    got = HybridSearcher.build(CORPUS, dense_model=td, splade_model=ts, device=DEVICE, **common)
    return want, got


def test_build_percentile_distributions_match_jax(nsf_searchers):
    want, got = nsf_searchers
    w = want.build_percentile_distributions(QUERIES, num_points=100, batch_size=4, use_pallas=False)
    g = got.build_percentile_distributions(QUERIES, num_points=100, batch_size=4)
    assert sorted(g) == sorted(w) == ["bm25", "dpr", "splade"]
    for system in w:
        np.testing.assert_allclose(g[system], w[system], atol=1e-5, rtol=0)


@pytest.mark.parametrize("norm", ["percentile-rank", "normal-curve-equivalent"])
def test_percentile_nsf_searcher_matches_jax(nsf_searchers, norm):
    """The percentile normalizations no longer raise: with the same tables
    the port's NSF search gives the JAX searcher's lists."""
    want, got = nsf_searchers
    tables = want.build_percentile_distributions(QUERIES, num_points=100, batch_size=4, use_pallas=False)
    for s in (want, got):
        s.normalization = norm
        s.percentile_distributions = tables
    want._jitted.clear()
    w, _ = want.search(QUERIES, batch_size=4, use_pallas=False)
    g, _ = got.search(QUERIES, batch_size=4)
    assert_ranked_match(g.ids, g.scores, w.ids, w.scores, atol=1e-5)


def test_percentile_nsf_without_tables_raises(nsf_searchers):
    _, got = nsf_searchers
    fresh = HybridSearcher(corpus_ids=got.corpus_ids, bm25=got.bm25, bm25_impacts=got.bm25_impacts,
                           dense_model=got.dense_model, dense_corpus=got.dense_corpus, fusion_method="nsf",
                           normalization="percentile-rank", device=DEVICE)
    with pytest.raises(ValueError, match="quantile tables"):
        fresh.search(QUERIES, batch_size=4)
