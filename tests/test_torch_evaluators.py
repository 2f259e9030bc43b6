"""The port's evaluators (``fusion_tpu_torch.eval.evaluators``), utilities
(``utils/common.py``, ``WandbLogger``) and ``BM25Index.extract_negatives``
against the JAX package's, on tiny models converted from the JAX params.

Tolerances: metric values within 1e-6 (the same ranks from f32 scores
that differ in the last digits); everything else exact."""

import csv
import os

import numpy as np
import pytest
import torch
from torch_parity import DEVICE

from fusion_tpu.eval import evaluators as je
from fusion_tpu.models.biencoder import BiEncoder as JaxBiEncoder
from fusion_tpu.models.bm25 import BM25Index as JaxBM25
from fusion_tpu.models.colbert import ColBERT as JaxColBERT
from fusion_tpu.models.crossencoder import CrossEncoder as JaxCrossEncoder
from fusion_tpu.models.encoder import EncoderConfig as JaxConfig
from fusion_tpu.utils import common as jc
from fusion_tpu_torch.eval import evaluators as te
from fusion_tpu_torch.models import convert
from fusion_tpu_torch.models.biencoder import BiEncoder
from fusion_tpu_torch.models.bm25 import BM25Index
from fusion_tpu_torch.models.colbert import ColBERT
from fusion_tpu_torch.models.crossencoder import CrossEncoder
from fusion_tpu_torch.models.encoder import EncoderConfig
from fusion_tpu_torch.utils import common as tc
from fusion_tpu_torch.utils.loggers import WandbLogger

WORDS = "chat chien tribunal jugement contrat travail loi voiture route oiseau forêt tapis salon jardin".split()
KS = dict(recall_at_k=[1, 5, 10, 20], map_at_k=[10, 20], mrr_at_k=[10], ndcg_at_k=[10, 20], accuracy_at_k=[1, 3])


def _data(seed=2, n_docs=30, n_q=8):
    rng = np.random.default_rng(seed)
    corpus = {500 + i: " ".join(rng.choice(WORDS, size=rng.integers(3, 10))) for i in range(n_docs)}
    ids = list(corpus)
    qrels = {q: [ids[int(i)] for i in rng.choice(n_docs, size=rng.integers(1, 4), replace=False)] for q in range(n_q)}
    queries = {q: " ".join(corpus[qrels[q][0]].split()[:3]) for q in range(n_q)}
    return queries, corpus, qrels


def _pair(kind):
    jcfg, tcfg = JaxConfig.tiny(vocab_size=512), EncoderConfig.tiny(vocab_size=512)
    kw = dict(max_query_length=8, max_doc_length=16)
    if kind == "colbert":
        jm = JaxColBERT(jcfg, dim=16, **kw)
        return jm, ColBERT(tcfg, params=convert.colbert_state_dict(jm.params), dim=16, device=DEVICE, **kw)
    jm = JaxBiEncoder(jcfg, head=kind, **kw)
    conv = convert.encoder_with_mlm_state_dict if kind == "splade" else convert.encoder_state_dict
    return jm, BiEncoder(tcfg, params=conv(jm.params), head=kind, device=DEVICE, **kw)


def _assert_scores(got, want):
    want = {k: v for k, v in want.items() if "ms/query" not in k}
    got = {k: v for k, v in got.items() if "ms/query" not in k}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-6, (k, got[k], v)


@pytest.mark.parametrize("kind", ["dense", "splade", "colbert"])
def test_ir_evaluator_matches_jax(kind, tmp_path):
    queries, corpus, qrels = _data()
    jm, tm = _pair(kind)
    logged = []
    jev = je.InformationRetrievalEvaluator(queries, corpus, qrels, batch_size=8, **KS)
    tev = te.InformationRetrievalEvaluator(queries, corpus, qrels, batch_size=8, name="t",
                                           log_callback=lambda e, s, m, v: logged.append(m), **KS)
    want = jev(jm)
    got = tev(tm, output_path=str(tmp_path), steps=3)
    tev(tm, output_path=str(tmp_path), steps=4)
    assert abs(got - want) <= 1e-6
    _assert_scores(tev.last_scores, jev.last_scores)
    assert {"latency (ms/query)", "encoding (ms/query)", "scoring (ms/query)", "index build (ms/query)",
            "formatting (ms/query)"} <= set(tev.last_scores)
    assert "map@20" in logged
    with open(tmp_path / "ir_eval_t.csv") as f:
        assert [r["steps"] for r in csv.DictReader(f)] == ["3", "4"]


def _rerank_samples(corpus, queries, qrels):
    docs = list(corpus.values())
    return [{"query": queries[q], "positive": [corpus[p] for p in qrels[q]], "negative": docs[q:q + 5]}
            for q in queries] + [{"query": "vide", "positive": [], "negative": docs[:2]}]


def test_reranking_evaluator_matches_jax():
    queries, corpus, qrels = _data()
    jm = JaxCrossEncoder(JaxConfig.tiny(vocab_size=512), max_length=24)
    tm = CrossEncoder(EncoderConfig.tiny(vocab_size=512), params=convert.crossencoder_state_dict(jm.params),
                      max_length=24, device=DEVICE)
    samples = _rerank_samples(corpus, queries, qrels)
    jev, tev = je.RerankingEvaluator(samples, batch_size=4), te.RerankingEvaluator(samples, batch_size=4)
    assert abs(tev(tm) - jev(jm)) <= 1e-6
    _assert_scores(tev.last_scores, jev.last_scores)


def test_best_model_tracker_keeps_the_best(tmp_path):
    queries, corpus, qrels = _data()
    _, tm = _pair("dense")
    scores = iter([0.2, 0.5, 0.4])

    class Ev:
        def __call__(self, model, output_path=None, epoch=-1, steps=-1):
            return next(scores)

    tracker = te.BestModelTracker(Ev(), save_path=str(tmp_path))
    for step in (1, 2, 3):
        tracker(tm, step)
    assert (tracker.best_step, tracker.best_score) == (2, 0.5)
    assert os.path.isfile(tmp_path / "best" / "params.msgpack")


def test_extract_negatives_matches_jax():
    queries, corpus, qrels = _data()
    docs, ids = list(corpus.values()), np.asarray(list(corpus))
    jidx = JaxBM25.build(docs, k1=2.5, b=0.2)
    tidx = BM25Index.build(docs, k1=2.5, b=0.2, device=DEVICE)
    qs = list(queries.values())
    positives = [qrels[q] for q in queries]
    want = jidx.extract_negatives(jidx.search_all(qs, top_k=20), positives, num_negatives=5, idx2id=ids)
    got = tidx.extract_negatives(tidx.search_all(qs, top_k=20), positives, num_negatives=5, idx2id=ids)
    assert got == want


def test_common_utilities_match_jax(tmp_path, capsys):
    with tc.catchtime("phase") as elapsed:
        pass
    assert elapsed() >= 0 and "phase:" in capsys.readouterr().out
    assert tc.log_step(lambda x: x + 1)(1) == 2
    g = tc.set_seed(7)
    assert isinstance(g, torch.Generator) and g.initial_seed() == 7
    a = (np.random.rand(), torch.rand(1).item())
    tc.set_seed(7)
    assert (np.random.rand(), torch.rand(1).item()) == a
    assert list(tc.batchify(list(range(7)), 3)) == list(jc.batchify(list(range(7)), 3))
    tsv = tmp_path / "r.tsv"
    tsv.write_text("1\t10\t2\n1\t20\t1\n2\t30\t1\n")
    for cols in (None, ["qid", "pid", "rank"]):
        assert tc.tsv_to_jsonl(str(tsv), str(tmp_path / "t.jsonl"), cols) == jc.tsv_to_jsonl(
            str(tsv), str(tmp_path / "j.jsonl"), cols)
        assert (tmp_path / "t.jsonl").read_text() == (tmp_path / "j.jsonl").read_text()
    for ranking in ({1: [10, 20, 30], 2: [5]}, str(tsv)):
        assert tc.convert_colbert_results_to_negatives(ranking, {1: [20]}, 2) == \
            jc.convert_colbert_results_to_negatives(ranking, {1: [20]}, 2)
    (tmp_path / "train.b.jsonl").write_text("")
    (tmp_path / "train.a.jsonl").write_text("")
    assert tc.get_training_filepath(str(tmp_path), "train") == jc.get_training_filepath(str(tmp_path), "train")
    assert tc.get_training_filepath(str(tmp_path), "none") is None


def test_count_parameters_and_estimate_flops():
    _, tm = _pair("dense")
    jm = _pair("dense")[0]
    assert tc.count_parameters(tm.module) == jc.count_parameters(jm.params)
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    assert tc.estimate_flops(torch.matmul, a, b)["flops"] == 2 * 8 * 16 * 4


def test_wandb_logger_falls_back_to_jsonl(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_wandb(name, *args, **kw):
        if name == "wandb":
            raise ImportError("no wandb")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_wandb)
    logger = WandbLogger("proj", "run", log_dir=str(tmp_path))
    assert logger.backend is None
    logger.log_training(0, 0, 3, 1e-3, 0.5, "loss")
    logger.log_eval(0, 3, "recall@10", 0.25)
    logger.finish()
    lines = (tmp_path / "run.jsonl").read_text().splitlines()
    assert len(lines) == 2 and '"loss": 0.5' in lines[0] and '"recall@10"' in lines[1]
