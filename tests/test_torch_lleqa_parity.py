"""The port's LLeQA harness (``fusion_tpu_torch.tools.run_lleqa_parity``)
against the JAX package's ``scripts/run_lleqa_parity.py`` on the fixture
and the JAX-saved tiny checkpoints of ``tests/test_lleqa_parity_harness.py``,
on the CPU: the same report (every system's every metric within 1e-6), the
same gate (targets equal to the measured values pass, far ones exit 1), and
no records without ``--fixture``.

Tolerance: 1e-6 on each metric.  The JAX script scores ColBERT on the CPU
through the doc-major reference, the port through the token-major plain
version of K1 (f32 sums in another order), so a metric could move only
where two docs' scores tie to rounding; on this fixture none do."""

import json
import os
import runpy
import sys

import pytest

from fusion_tpu_torch.tools import run_lleqa_parity as tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "run_lleqa_parity.py")
SYSTEMS = ("bm25", "dpr", "splade", "colbert", "fused", "reranked")

CORPUS = [
    {"id": i + 1, "article": f"article de loi numéro {i} portant sur le sujet {i % 5}"}
    for i in range(24)
]
QUESTIONS = {
    "train": [{"id": 1, "question": "sujet 0 article", "article_ids": [1, 6]}],
    "dev": [
        {"id": 2, "question": "article de loi numéro 3", "article_ids": [4]},
        {"id": 3, "question": "le sujet 2 de loi", "article_ids": [3, 8]},
    ],
    "test": [],
}


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The harness test's fixture JSON and tiny checkpoints, saved by the
    JAX package."""
    from fusion_tpu.models.biencoder import BiEncoder
    from fusion_tpu.models.colbert import ColBERT
    from fusion_tpu.models.crossencoder import CrossEncoder
    from fusion_tpu.models.encoder import EncoderConfig

    root = tmp_path_factory.mktemp("parity")
    fixture = root / "lleqa.json"
    fixture.write_text(json.dumps({"corpus": CORPUS, "questions": QUESTIONS, "negatives": None}))
    cfg = EncoderConfig.tiny(vocab_size=512)
    paths = {}
    for name, model in [
        ("dpr", BiEncoder(cfg, head="dense", max_query_length=16, max_doc_length=32)),
        ("splade", BiEncoder(cfg, head="splade", max_query_length=16, max_doc_length=32)),
        ("colbert", ColBERT(cfg, dim=16, max_query_length=16, max_doc_length=32)),
        ("monobert", CrossEncoder(cfg, max_length=32)),
    ]:
        paths[name] = str(root / name)
        model.save(paths[name])
    return {"fixture": str(fixture), "root": root, **paths}


def _argv(artifacts, out_dir, targets, fusion="rrf", normalization=""):
    return [
        "--fixture", artifacts["fixture"],
        "--dpr_path", artifacts["dpr"], "--splade_path", artifacts["splade"],
        "--colbert_path", artifacts["colbert"], "--monobert_path", artifacts["monobert"],
        "--fusion", fusion, "--normalization", normalization,
        "--out_dir", str(out_dir), "--targets", str(targets), "--batch_size", "8",
    ]


def _jax_report(argv, out_dir):
    old = sys.argv
    sys.argv = ["run_lleqa_parity.py", *argv]
    try:
        runpy.run_path(SCRIPT, run_name="__main__")
    finally:
        sys.argv = old
    with open(os.path.join(out_dir, "performance_hybrid_lleqa_dev.json")) as f:
        return json.load(f)


def _port_report(argv, out_dir):
    tool.main([*argv, "--device", "cpu"])
    with open(os.path.join(out_dir, "performance_hybrid_lleqa_dev.json")) as f:
        return json.load(f)


def _assert_reports_equal(got, want):
    assert {k: got[k] for k in ("split", "corpus_size", "num_queries")} == {
        k: want[k] for k in ("split", "corpus_size", "num_queries")}
    assert set(got["systems"]) == set(want["systems"]) == set(SYSTEMS)
    for system in SYSTEMS:
        g, w = got["systems"][system], want["systems"][system]
        assert set(g) == set(w), system
        for metric, value in w.items():
            if isinstance(value, str):
                assert g[metric] == value, (system, metric)
            else:
                assert g[metric] == pytest.approx(value, abs=1e-6, rel=0), (system, metric, g[metric], value)


@pytest.mark.parametrize("fusion,normalization", [("rrf", ""), ("nsf", "percentile-rank")])
def test_report_matches_the_jax_script(artifacts, tmp_path, fusion, normalization):
    want = _jax_report(_argv(artifacts, tmp_path / "jax", tmp_path / "none.json", fusion, normalization),
                       tmp_path / "jax")
    got = _port_report(_argv(artifacts, tmp_path / "port", tmp_path / "none.json", fusion, normalization),
                       tmp_path / "port")
    _assert_reports_equal(got, want)
    assert set(got["seconds"]) == set(SYSTEMS)


def test_gate_passes_matching_targets_and_exits_1_on_far_ones(artifacts, tmp_path):
    out = tmp_path / "out"
    report = _port_report(_argv(artifacts, out, tmp_path / "none.json"), out)
    ok = {
        "bm25": {"recall@100": report["systems"]["bm25"]["recall@100"] * 100},
        "fused": {"ndcg@10": report["systems"]["fused"]["ndcg@10"] * 100},
    }
    ok_path = tmp_path / "targets_ok.json"
    ok_path.write_text(json.dumps(ok))
    tool.main([*_argv(artifacts, out, ok_path), "--device", "cpu"])
    assert tool.gate_failures(report, ok, 1.5) == []

    bad = {"bm25": {"recall@100": 99.9}, "fused": {"ndcg@10": 0.01}}
    bad_path = tmp_path / "targets_bad.json"
    bad_path.write_text(json.dumps(bad))
    with pytest.raises(SystemExit) as e:
        tool.main([*_argv(artifacts, out, bad_path), "--device", "cpu"])
    assert e.value.code == 1
    failures = tool.gate_failures(report, bad, 1.5)
    assert [f.split(":")[0] for f in failures] == ["fused.ndcg@10"]  # bm25 recall@100 is 100 here
    assert tool.gate_failures(report, {"reranked": {"no_such_metric": 1.0}}, 1.5) == [
        "reranked.no_such_metric: missing"]


def test_missing_fixture_raises_the_loaders_error(artifacts, tmp_path):
    argv = [a for a in _argv(artifacts, tmp_path, tmp_path / "none.json")]
    i = argv.index("--fixture")
    del argv[i : i + 2]
    with pytest.raises(NotImplementedError, match="not ported"):
        tool.main([*argv, "--device", "cpu"])


def test_no_checkpoint_and_no_local_encoder_raises(artifacts, tmp_path):
    argv = [a for a in _argv(artifacts, tmp_path, tmp_path / "none.json")]
    i = argv.index("--dpr_path")
    del argv[i : i + 2]
    with pytest.raises(FileNotFoundError, match="not a local directory"):
        tool.main([*argv, "--device", "cpu", "--encoder", str(tmp_path / "no_such_dir")])


def test_the_card_is_the_default(artifacts, tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(_argv(artifacts, tmp_path, tmp_path / "none.json"))
