"""The port's mMARCO and Mr. TyDi loaders (``fusion_tpu_torch/data/mmarco.py``,
``data/mrtydi.py``) against the JAX package's on the same records and seeds:
the constants and cache names, ``MmarcoReader``'s three formats, CE-margin
filter and multi-pass sampling (Python ``random``, so the draws must be
equal, not close), the JSONL caches byte for byte, the reference's dump
files (``.gz``), ``MmarcoLoader`` / ``MrTyDiLoader`` on the raw fixture
schema, and the CLI's ``--dataset mmarco-fr`` / ``mrtydi-ja`` run by both
packages on ``tests/test_cli.py``'s ``MMARCO_FIXTURE``.

Everything compares exactly, the CLI's metrics files too (timing fields
aside): the BM25 runs score the same f32 postings, the DPR test runs one
JAX-saved checkpoint whose f32 scores rank the fixture's 12 docs alike."""

import csv
import gzip
import json
import pickle

import pytest
from test_cli import MMARCO_FIXTURE
from test_data import MM_CORPUS, MM_QUERIES, make_ce_scores, make_hard_records
from torch_parity import DEVICE

from fusion_tpu.cli.main import _load_lleqa as jax_load
from fusion_tpu.cli.main import main as jax_main
from fusion_tpu.data import mmarco as jax_mm
from fusion_tpu.data import mrtydi as jax_ty
from fusion_tpu.models.biencoder import BiEncoder as JaxBiEncoder
from fusion_tpu.models.encoder import EncoderConfig as JaxConfig
from fusion_tpu_torch.cli.main import _load_lleqa
from fusion_tpu_torch.cli.main import main
from fusion_tpu_torch.data import mmarco, mrtydi

MM_RAW = {
    "corpus": {i: f"passage {i}" for i in range(40)},
    "train_queries": {q: f"question {q}" for q in range(8)},
    "train_qrels": {q: [q * 4, q * 4 + 1] for q in range(8)},
    "dev_queries": {100: "dev one", 101: "dev two"},
    "dev_qrels": {100: [3], 101: [7, 9]},
    "negatives": {q: [(q * 4 + j) % 40 for j in range(2, 7)] for q in range(8)},
}


def rich_records(n=30):
    """Records whose draws depend on the rng: 1-3 positives, pools of 4-9
    negatives over two systems with repeats, a qid without CE scores and one
    without queries."""
    out = []
    for q in range(n):
        pos = [(q * 7 + j) % 100 for j in range(1 + q % 3)]
        out.append({"qid": q, "pos": pos, "neg": {
            "bm25": [(q * 11 + j) % 100 for j in range(2 + q % 5)],
            "msmarco-MiniLM-L-6-v3": [(q * 13 + j) % 100 for j in range(2 + q % 4)] + [(q * 11) % 100],
        }})
    out.append({"qid": 999, "pos": [1], "neg": {"bm25": [2]}})  # no such query
    return out


def rich_scores(n=30):
    scores = {q: {p: 1.0 + (p * 31 + q) % 9 for p in range(100)} for q in range(n) if q != 5}
    for q in scores:
        for j in range(1 + q % 3):
            scores[q][(q * 7 + j) % 100] = 14.0 + j  # positives well above the margin
    return scores


QUERIES = {q: f"question {q}" for q in range(40)}


def _both_readers(**kw):
    return (jax_mm.MmarcoReader("fr", MM_CORPUS, QUERIES, **kw),
            mmarco.MmarcoReader("fr", MM_CORPUS, QUERIES, **kw))


def test_constants_and_cache_names_equal_jax():
    assert mmarco.MMARCO_LANGUAGES == jax_mm.MMARCO_LANGUAGES
    assert mmarco.NEGATIVE_MINING_SYSTEMS == jax_mm.NEGATIVE_MINING_SYSTEMS
    assert mmarco.SAMPLE_FORMATS == jax_mm.SAMPLE_FORMATS
    assert mrtydi.MRTYDI_LANGUAGES == jax_ty.MRTYDI_LANGUAGES
    for args in (("fr", "tuple_with_scores", "hard", 8, "all", 1000), ("de", "triplet", "original", 1, ["bm25"], 0),
                 ("ja", "tuple", "hard", 3, list(jax_mm.NEGATIVE_MINING_SYSTEMS), 5)):
        assert mmarco.training_cache_filename(*args) == jax_mm.training_cache_filename(*args)


@pytest.mark.parametrize("fmt", ["triplet", "tuple", "tuple_with_scores"])
@pytest.mark.parametrize("negs, systems", [(1, "all"), (3, "bm25,msmarco-MiniLM-L-6-v3"), (2, ["bm25"])],
                         ids=["1neg-all", "3neg-two_systems", "2neg-bm25"])
def test_hard_negative_sampling_equals_jax(tmp_path, fmt, negs, systems):
    """Three passes over the dump (70 samples from 28 usable records), the
    per-pass re-seed, the cache file and its round trip."""
    kw = dict(max_train_examples=70, training_sample_format=fmt, negs_type="hard", negs_per_query=negs,
              negs_mining_systems=systems, ce_score_margin=3.0)
    jr = jax_mm.MmarcoReader("fr", MM_CORPUS, QUERIES, cache_dir=str(tmp_path / "jax"), **kw)
    pr = mmarco.MmarcoReader("fr", MM_CORPUS, QUERIES, cache_dir=str(tmp_path / "port"), **kw)
    want = jr.load(hard_negative_records=rich_records(), ce_scores=rich_scores())
    got = pr.load(hard_negative_records=iter(rich_records()), ce_scores=rich_scores())
    assert got.train_samples == want.train_samples and len(got.train_samples) > 0
    with open(jr.cache_path(), "rb") as f_j, open(pr.cache_path(), "rb") as f_p:
        assert f_p.read() == f_j.read()
    assert pr.cache_path().rsplit("/", 1)[1] == jr.cache_path().rsplit("/", 1)[1]
    assert pr.load().train_samples == jr.load().train_samples == want.train_samples  # from the caches


def test_margin_filter_stop_and_insufficient_negs_equal_jax():
    for records, scores, negs in (
        ([{"qid": 0, "pos": [0], "neg": {"bm25": [1, 2]}}], {0: {0: 10.0, 1: 9.0, 2: 2.0}}, 1),  # margin
        ([{"qid": 0, "pos": [0], "neg": {"bm25": [1, 2]}}], {0: {0: 10.0, 1: 9.5, 2: 9.0}}, 1),  # none qualify
        ([{"qid": 0, "pos": [0], "neg": {"bm25": [1]}}], {0: {0: 10.0, 1: 9.5}}, 2),  # too few negatives
    ):
        jr, pr = _both_readers(max_train_examples=5, negs_type="hard", negs_per_query=negs)
        assert pr.sample_from_hard_negatives(iter(records), scores) == jr.sample_from_hard_negatives(records, scores)
    jr, pr = _both_readers(max_train_examples=5, negs_type="hard", negs_per_query=1)
    records, scores = [{"qid": 0, "pos": [0], "neg": {"bm25": [1, 2]}}], {0: {0: 10.0, 1: 9.0, 2: 2.0}}
    assert [s[2] for s in pr.sample_from_hard_negatives(records, scores)] == [MM_CORPUS[2]] * 5


def test_triples_equal_jax():
    triples = [(0, 1, 2), (1, 11, 12), (99, 1, 2), (2, 21, 22), (3, 31, 500), (4, 41, 42), (5, 51, 52)]
    jr, pr = _both_readers(max_train_examples=4, negs_type="original")
    assert pr.load(triples=triples).train_samples == jr.load(triples=triples).train_samples
    assert len(pr.sample_from_triples(triples)) == 4


def test_reference_dump_files_equal_jax(tmp_path):
    hn_path = str(tmp_path / "msmarco-hard-negatives.jsonl.gz")
    with gzip.open(hn_path, "wt") as f:
        for rec in make_hard_records():
            f.write(json.dumps(rec) + "\n")
    plain_hn = str(tmp_path / "msmarco-hard-negatives.jsonl")
    with open(plain_hn, "w") as f:
        for rec in make_hard_records():
            f.write(json.dumps(rec) + "\n\n")
    ce_path = str(tmp_path / "cross-encoder-scores.pkl.gz")
    with gzip.open(ce_path, "wb") as f:
        pickle.dump({str(q): {str(p): s for p, s in d.items()} for q, d in make_ce_scores().items()}, f)
    tri_path = str(tmp_path / "qidpidtriples.train.full.2.tsv.gz")
    with gzip.open(tri_path, "wt") as f:
        for row in [(0, 1, 2), (1, 11, 12), (2, 21, 22), (3,)]:
            f.write("\t".join(map(str, row)) + "\n")
    for path in (hn_path, plain_hn):
        assert list(mmarco.read_hard_negative_records(path)) == list(jax_mm.read_hard_negative_records(path))
    assert mmarco.read_ce_scores(ce_path) == jax_mm.read_ce_scores(ce_path)
    assert list(mmarco.read_triples(tri_path)) == list(jax_mm.read_triples(tri_path)) == [(0, 1, 2), (1, 11, 12),
                                                                                           (2, 21, 22)]
    kw = dict(max_train_examples=8, training_sample_format="tuple_with_scores", negs_type="hard", negs_per_query=2)
    want = jax_mm.MmarcoReader("fr", MM_CORPUS, MM_QUERIES, **kw).load(
        hard_negatives_path=hn_path, ce_scores_path=ce_path)
    got = mmarco.MmarcoReader("fr", MM_CORPUS, MM_QUERIES, **kw).load(
        hard_negatives_path=hn_path, ce_scores_path=ce_path)
    assert got.train_samples == want.train_samples and len(got.train_samples) == 8
    via_tri = mmarco.MmarcoReader("fr", MM_CORPUS, MM_QUERIES, max_train_examples=3, negs_type="original")
    assert via_tri.load(triples_path=tri_path).train_samples == jax_mm.MmarcoReader(
        "fr", MM_CORPUS, MM_QUERIES, max_train_examples=3, negs_type="original").load(triples_path=tri_path).train_samples


def test_reader_argument_checks_as_jax():
    for kw in (dict(training_sample_format="pairs"), dict(negs_type="mined"),
               dict(negs_mining_systems="bm25,nope"), dict(training_sample_format="tuple_with_scores")):
        with pytest.raises(AssertionError):
            jax_mm.MmarcoReader("fr", MM_CORPUS, MM_QUERIES, **kw)
        with pytest.raises(AssertionError):
            mmarco.MmarcoReader("fr", MM_CORPUS, MM_QUERIES, **kw)
    with pytest.raises(AssertionError):
        mmarco.MmarcoReader("xx", MM_CORPUS, MM_QUERIES)


def _data_fields(data):
    return data.corpus, data.queries, data.qrels, data.train_samples


@pytest.mark.parametrize("kind", ["mmarco", "mrtydi"])
def test_loaders_equal_jax(kind):
    """load(), the triplet sampler's samples, the cross-encoder pairs and
    the hard negatives, from JSON-style string keys as from int keys."""
    raw = json.loads(json.dumps(MM_RAW)) if kind == "mmarco" else MM_RAW
    if kind == "mmarco":
        jl, pl = jax_mm.MmarcoLoader("de", raw), mmarco.MmarcoLoader("de", raw)
    else:
        jl, pl = jax_ty.MrTyDiLoader("ja", raw), mrtydi.MrTyDiLoader("ja", raw)
    assert _data_fields(pl.load()) == _data_fields(jl.load())
    assert pl.hard_negatives() == jl.hard_negatives() and pl.corpus() == jl.corpus()
    for negs, seed in ((1, 0), (2, 7)):
        assert list(pl.biencoder_sampler(negs, seed).samples()) == list(jl.biencoder_sampler(negs, seed).samples())
    assert pl.crossencoder_pairs(2, 3) == jl.crossencoder_pairs(2, 3)


def test_network_sources_raise():
    with pytest.raises(NotImplementedError, match="ir_datasets"):
        mmarco.MmarcoLoader("fr")
    with pytest.raises(NotImplementedError, match="hub"):
        mrtydi.MrTyDiLoader("ja")
    with pytest.raises(AssertionError):
        mrtydi.MrTyDiLoader(lang="xx", raw=MM_RAW)
    assert not hasattr(mmarco, "load_mmarco_ir_datasets") and not hasattr(mrtydi, "load_mrtydi_raw")


@pytest.mark.parametrize("dataset, lang", [("mrtydi-ja", "ja"), ("mmarco-es", "es"), ("mmarco", "fr"),
                                           ("mrtydi", "en")])
def test_cli_dispatch_equals_jax(tmp_path, dataset, lang):
    import argparse

    fixture = tmp_path / "raw.json"
    fixture.write_text(json.dumps(MM_RAW))
    args = argparse.Namespace(dataset=dataset, fixture=str(fixture))
    got, want = _load_lleqa(args), jax_load(args)
    assert type(got).__name__ == type(want).__name__ and got.lang == want.lang == lang
    assert _data_fields(got.load()) == _data_fields(want.load())


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_datasets")
    fx = root / "mmarco.json"
    fx.write_text(json.dumps(MMARCO_FIXTURE))
    ckpt = str(root / "dpr")
    JaxBiEncoder(JaxConfig.tiny(vocab_size=2048), head="dense", max_query_length=12, max_doc_length=24).save(ckpt)
    return root, str(fx), ckpt


def _metrics(path):
    """A metrics file's rows without their timing fields (latency, ms/query)."""
    if path.endswith(".json"):
        with open(path) as f:
            rows = [json.load(f)]
    else:
        with open(path) as f:
            rows = list(csv.DictReader(f))
    return [{k: v for k, v in r.items() if "latency" not in k and "ms/" not in k} for r in rows]


# (bm25 on mmarco-fr and the DPR test on mrtydi-en run in
# test_torch_cli.py::test_unported_options_raise)
@pytest.mark.parametrize("argv, files", [
    (["bm25", "--task", "evaluate", "--dataset", "mrtydi-ja"], ["performance_bm25_mrtydi-ja_dev.json"]),
    (["dpr", "--task", "test", "--dataset", "mmarco-fr", "--split", "dev"], ["ir_eval_results.csv"]),
], ids=["bm25-mrtydi", "dpr_test-mmarco"])
def test_cli_datasets_equal_jax_metrics(cli_setup, argv, files):
    root, fx, ckpt = cli_setup
    label = "_".join(argv[:1] + argv[-3:])
    extra = ["--model_path", ckpt] if argv[0] == "dpr" else []
    base = ["--fixture", fx, "--tiny"] + extra
    jax_main(argv + base + ["--output_dir", str(root / "jax" / label)])
    main(argv + base + ["--output_dir", str(root / "port" / label), "--device", DEVICE])
    for name in files:
        want, got = _metrics(str(root / "jax" / label / name)), _metrics(str(root / "port" / label / name))
        assert got == want and got, name
    if argv[0] == "bm25":
        assert _metrics(str(root / "port" / label / files[0]))[0]["recall@5"] == 1.0


def test_cli_trains_on_mrtydi(cli_setup, tmp_path):
    """dpr --task train on mrtydi-ja's fixture (its train split) saves a
    model that the test task then evaluates."""
    _, fx, _ = cli_setup
    base = ["--dataset", "mrtydi-ja", "--fixture", fx, "--tiny", "--device", DEVICE, "--output_dir", str(tmp_path)]
    main(["dpr", "--task", "train", "--steps", "2", "--train_batch_size", "2"] + base)
    main(["dpr", "--task", "test", "--model_path", str(tmp_path / "final"), "--split", "dev"] + base)
    assert (tmp_path / "final").is_dir() and _metrics(str(tmp_path / "ir_eval_results.csv"))
