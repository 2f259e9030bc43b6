"""The port's CLI (``fusion_tpu_torch.cli.main``) against the JAX package's
CLI on one fixture and the same JAX-saved tiny checkpoints, on the CPU:
``bm25`` (evaluate, tune, negatives), ``hybrid`` (RRF over the four
retrievers, percentile-rank NSF, the rerank, NSF weight tuning, the score
distribution analysis) and ``serve`` (build then search, default and
``--scale_mode --int8_corpus``, each package also serving the other's index
directory).  Each JAX run happens once per module.

Tolerances: BM25 metrics, negatives and tuning rows exactly (the same f32
scores up to ~1e-7, the same ranks); the neural runs' metrics exactly where
both rank the same ids; ranking TSVs with each query's first 10 rows equal
(scores within 1e-5) and its full list's ids overlapping >= 0.9 (an ulp of
difference between the two encoders may round a bf16 query element the
other way and move a doc one rank in a leg, which shifts RRF ranks below
the head); score-distribution tables within 1e-5."""

import csv
import glob
import json
import os

import numpy as np
import pytest
import torch
from torch_parity import DEVICE, assert_ranked_match

from fusion_tpu.cli.main import main as jax_main
from fusion_tpu.models.biencoder import BiEncoder as JaxBiEncoder
from fusion_tpu.models.colbert import ColBERT as JaxColBERT
from fusion_tpu.models.crossencoder import CrossEncoder as JaxCrossEncoder
from fusion_tpu.models.encoder import EncoderConfig as JaxConfig
from fusion_tpu.models.t5 import T5CrossEncoder as JaxT5CrossEncoder
from fusion_tpu_torch.cli.main import main
from fusion_tpu_torch.models.t5 import T5CrossEncoder

WORDS = (
    "chat chien tribunal jugement contrat travail loi consommateur voiture route oiseau forêt tapis "
    "salon jardin souris fromage pain livre page locataire bail loyer employeur congé juge avocat "
    "preuve dommage assurance"
).split()


def _fixture(seed=11, n_docs=40, n_dev=8):
    rng = np.random.default_rng(seed)
    docs = [" ".join(rng.choice(WORDS, size=rng.integers(5, 14))) for _ in range(n_docs)]
    ids = [1000 + 7 * i for i in range(n_docs)]

    def question(qid):
        gold = [int(g) for g in rng.choice(n_docs, size=rng.integers(1, 3), replace=False)]
        words = [w for g in gold for w in docs[g].split()[:3]]
        return {"id": qid, "question": " ".join(words), "article_ids": [ids[g] for g in gold]}

    return {
        "corpus": [{"id": i, "article": d, "description": ""} for i, d in zip(ids, docs)],
        "questions": {"train": [question(q) for q in range(1, 6)], "dev": [question(q) for q in range(10, 10 + n_dev)],
                      "test": []},
        "negatives": {str(q): {"bm25": [ids[q], ids[q + 1]]} for q in range(1, 6)},
    }


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    fx = root / "fixture.json"
    fx.write_text(json.dumps(_fixture()))
    cfg = JaxConfig.tiny(vocab_size=2048)
    paths = {}
    for name, model in (("dpr", JaxBiEncoder(cfg, head="dense", max_query_length=12, max_doc_length=24)),
                        ("splade", JaxBiEncoder(cfg, head="splade", max_query_length=12, max_doc_length=24)),
                        ("colbert", JaxColBERT(cfg, dim=16, max_query_length=12, max_doc_length=24)),
                        ("monobert", JaxCrossEncoder(cfg, max_length=40))):
        paths[name] = str(root / "ckpt" / name)
        model.save(paths[name])
    return root, str(fx), paths


def _run(setup, package: str, label: str, argv: list[str]) -> str:
    """Run one command of ``package`` ('jax' or 'port') into its own output
    directory; returns the directory."""
    root, fx, _ = setup
    out = root / package / label
    base = ["--fixture", fx, "--output_dir", str(out), "--tiny"]
    if package == "jax":
        jax_main(argv + base)
    else:
        main(argv + base + ["--device", DEVICE])
    return str(out)


def _both(setup, label, argv):
    return _run(setup, "jax", label, argv), _run(setup, "port", label, argv)


def _model_flags(setup, names=("dpr", "splade", "colbert", "monobert")):
    flags = []
    for name in names:
        flags += [f"--{name}_path", setup[2][name]]
    return flags


def _json(path):
    with open(path) as f:
        return json.load(f)


def _csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _tsv(path):
    with open(path) as f:
        rows = [line.rstrip("\n").split("\t") for line in f]
    return [tuple(int(x) for x in r[:3]) for r in rows], np.array([float(r[3]) for r in rows])


# ----------------------------------------------------------------------
# bm25
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def bm25_runs(setup):
    return {task: _both(setup, f"bm25_{task}", ["bm25", "--task", task] + extra)
            for task, extra in (("evaluate", ["--do_preprocessing"]), ("tune", []),
                                ("negatives", ["--num_negatives", "3"]))}


def test_bm25_evaluate_matches_jax(bm25_runs):
    j, p = bm25_runs["evaluate"]
    want, got = _json(f"{j}/performance_bm25_lleqa_dev.json"), _json(f"{p}/performance_bm25_lleqa_dev.json")
    assert got.keys() == want.keys()
    assert {k: v for k, v in got.items() if "latency" not in k} == {k: v for k, v in want.items() if "latency" not in k}
    assert got["recall@1000"] == 1.0


def test_bm25_tune_matches_jax(bm25_runs):
    j, p = bm25_runs["tune"]
    want, got = _csv(f"{j}/bm25_tuning_results.csv"), _csv(f"{p}/bm25_tuning_results.csv")
    assert len(got) == len(want) == 17 * 11 and got == want
    assert os.path.exists(f"{p}/bm25_tuning_heatmap.pdf")


def test_bm25_negatives_match_jax(bm25_runs):
    j, p = bm25_runs["negatives"]
    want, got = _json(f"{j}/negatives_bm25.json"), _json(f"{p}/negatives_bm25.json")
    assert got == want and len(got) >= 4


# ----------------------------------------------------------------------
# hybrid
# ----------------------------------------------------------------------
HYBRID = {
    "rrf_four": ["--run_bm25", "--run_dpr", "--run_splade", "--run_colbert", "--fusion", "rrf"],
    "nsf_percentile": ["--run_bm25", "--run_dpr", "--run_splade", "--fusion", "nsf", "--normalization",
                       "percentile-rank"],
    "rerank": ["--run_bm25", "--run_dpr", "--run_monobert", "--rerank_depth", "10"],
}


@pytest.fixture(scope="module")
def hybrid_runs(setup):
    return {label: _both(setup, f"hybrid_{label}", ["hybrid"] + argv + _model_flags(setup))
            for label, argv in HYBRID.items()}


@pytest.mark.parametrize("label", sorted(HYBRID))
def test_hybrid_matches_jax(hybrid_runs, label):
    j, p = hybrid_runs[label]
    want, got = _json(f"{j}/performance_hybrid.json"), _json(f"{p}/performance_hybrid.json")
    assert got.keys() == want.keys() and "ndcg@100" in got
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=1e-9), key


def test_hybrid_nsf_tuning_matches_jax(setup):
    argv = ["hybrid", "--run_bm25", "--run_dpr", "--fusion", "nsf", "--normalization", "min-max",
            "--tune_linear_fusion_weight", "--weight_step", "0.25"] + _model_flags(setup, ("dpr",))
    j, p = _both(setup, "hybrid_tune", argv)
    want, got = _csv(f"{j}/nsf_min-max_tuning.csv"), _csv(f"{p}/nsf_min-max_tuning.csv")
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            assert float(g[key]) == pytest.approx(float(w[key]), abs=1e-9), key


def test_hybrid_analyze_distributions_matches_jax(setup):
    argv = ["hybrid", "--run_bm25", "--run_dpr", "--analyze_score_distributions", "--normalization",
            "min-max"] + _model_flags(setup, ("dpr",))
    j, p = _both(setup, "hybrid_analyze", argv)
    names = sorted(os.path.basename(f) for f in glob.glob(f"{j}/*.csv"))
    assert names and sorted(os.path.basename(f) for f in glob.glob(f"{p}/*.csv")) == names
    for name in names:
        want, got = _csv(f"{j}/{name}"), _csv(f"{p}/{name}")
        assert len(got) == len(want) and got[0].keys() == want[0].keys(), name
        for g, w in zip(got, want):
            for key in w:
                if key == "label":
                    assert g[key] == w[key]
                else:
                    assert float(g[key]) == pytest.approx(float(w[key]), abs=1e-5), (name, key)


# ----------------------------------------------------------------------
# serve
# ----------------------------------------------------------------------
# the int8 views' bound (test_torch_int8_views.py): an activation one f32
# bit off JAX's may move its int8 code by one step
INT8_TOL = 1e-3
SERVE = {
    "default": ["--run_bm25", "--run_dpr", "--run_splade", "--run_colbert", "--run_monobert",
                "--rerank_depth", "10", "--ce_attention", "einsum"],
    "scale": ["--run_bm25", "--run_dpr", "--run_splade", "--run_colbert", "--scale_mode", "--int8_corpus",
              "--impact_cap", "64"],
}


@pytest.fixture(scope="module", params=sorted(SERVE))
def serve_runs(request, setup):
    """Each package builds its index directory and searches it, then
    searches the other's."""
    root = setup[0]
    flags = SERVE[request.param] + _model_flags(setup)
    dirs = {pkg: str(root / f"index_{request.param}_{pkg}") for pkg in ("jax", "port")}
    for pkg in ("jax", "port"):
        _run(setup, pkg, f"build_{request.param}", ["serve", "--task", "build", "--index_dir", dirs[pkg]] + flags)
    out = {}
    for pkg in ("jax", "port"):
        for idx in ("jax", "port"):
            out[pkg, idx] = _run(setup, pkg, f"search_{request.param}_{idx}",
                                 ["serve", "--task", "search", "--index_dir", dirs[idx], "--batch_size", "4"] + flags)
    return request.param, dirs, out


def _assert_tsv_equal(got_dir, want_dir, head=10):
    """The first ``head`` rows of every query (the reranked head in the
    default form) equal with scores within 1e-5; below them a leg's
    bf16-query near-tie may shift RRF ranks by a place, so the full lists
    are held to a top-set overlap >= 0.9."""
    got_rows, got_scores = _tsv(f"{got_dir}/serve_ranking.tsv")
    want_rows, want_scores = _tsv(f"{want_dir}/serve_ranking.tsv")
    assert len(got_rows) == len(want_rows) > 0
    by_query = {}
    for (qid, pid, rank), score, label in [(r, sc, "got") for r, sc in zip(got_rows, got_scores)] + [
            (r, sc, "want") for r, sc in zip(want_rows, want_scores)]:
        by_query.setdefault(qid, {"got": [], "want": []})[label].append((rank, pid, score))
    for qid, lists in by_query.items():
        got, want = sorted(lists["got"]), sorted(lists["want"])
        assert [r[:2] for r in got[:head]] == [r[:2] for r in want[:head]], qid
        np.testing.assert_allclose([r[2] for r in got[:head]], [r[2] for r in want[:head]], atol=1e-5, rtol=0)
        overlap = len({r[1] for r in got} & {r[1] for r in want}) / len(want)
        assert overlap >= 0.9, (qid, overlap)


def _assert_tsv_close(got_dir, want_dir, atol, head=10):
    """The reranked head of every query with scores within ``atol`` and
    ids equal up to the order of near-ties (``assert_ranked_match``)."""
    lists = {}
    for label, d in (("got", got_dir), ("want", want_dir)):
        rows, scores = _tsv(f"{d}/serve_ranking.tsv")
        for (qid, pid, rank), score in zip(rows, scores):
            lists.setdefault(qid, {"got": [], "want": []})[label].append((rank, pid, score))
    for qid, both in lists.items():
        got, want = sorted(both["got"])[:head], sorted(both["want"])[:head]
        assert len(got) == len(want) > 0, qid
        assert_ranked_match([[r[1] for r in got]], [[r[2] for r in got]], [[r[1] for r in want]],
                            [[r[2] for r in want]], atol=atol)


def test_serve_search_matches_jax(serve_runs):
    """The port serving its own directory ranks as JAX serving its own."""
    _, _, out = serve_runs
    _assert_tsv_equal(out["port", "port"], out["jax", "jax"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_serve_directories_are_interchangeable(serve_runs, writer):
    """One directory, searched by both packages' CLIs: the same TSV."""
    _, _, out = serve_runs
    _assert_tsv_equal(out["port", writer], out["jax", writer])


def test_serve_build_writes_the_jax_layout(serve_runs):
    form, dirs, _ = serve_runs

    def files(d):
        return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)

    assert files(dirs["port"]) == files(dirs["jax"])
    if form == "scale":
        assert os.path.exists(os.path.join(dirs["port"], "bm25_impact", "impact_index.npz"))


# ----------------------------------------------------------------------
# the options each slice brought, what still raises, and the device
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def options_index(setup):
    """A JAX-built index directory with every system and the rerank, which
    both packages' ``serve --task search`` read with an option each."""
    index = str(setup[0] / "index_options")
    _run(setup, "jax", "build_options", ["serve", "--task", "build", "--index_dir", index] + SERVE["default"]
         + _model_flags(setup))
    return index


# The ids name each case's option (every one raised until its port landed).
@pytest.mark.parametrize("argv, match", [
    (["monobert", "--task", "train", "--backbone", "t5"], None),
    (["dpr", "--task", "test", "--dataset", "mrtydi-en"], None),
    (["bm25", "--dataset", "mmarco-fr"], None),
    (["hybrid", "--run_dpr", "--attention_impl", "flash"], None),
    (["serve", "--task", "search", "--ce_int8"], None),
    (["serve", "--task", "search", "--encoders_int8"], None),
    (["serve", "--task", "search", "--rerank_buckets", "64", "128"], None),
    (["serve", "--task", "search", "--rerank_cascade", "10", "64"], None),
    (["serve", "--task", "search", "--ce_attention", "einsum_bf16"], None),
], ids=["argv0-backbone_t5", "argv1-dataset_mrtydi", "argv2-dataset_mmarco", "argv3-attention_impl_flash",
        "argv4-ce_int8", "argv5-encoders_int8", "argv6-rerank_buckets", "argv7-rerank_cascade",
        "argv8-ce_attention"])
def test_unported_options_raise(setup, options_index, request, argv, match):
    """Every option runs in both packages and ranks alike: the datasets
    (from ``tests/test_cli.py``'s mMARCO-schema fixture, the DPR test on the
    JAX-saved checkpoint) give JAX's metrics; the T5 backbone trains and the
    JAX package scores its final/ as the port does; ``hybrid
    --attention_impl`` (which ``--tiny`` leaves at the tiny config's form, in
    both) gives JAX's metrics; each ``serve`` option searching one JAX-built
    directory gives JAX's TSV."""
    label = "option_" + request.node.callspec.id.split("-")[0]
    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            _run(setup, "port", label, argv)
        return
    if "--dataset" in argv:
        from test_cli import MMARCO_FIXTURE

        fx = setup[0] / "mmarco_fixture.json"
        fx.write_text(json.dumps(MMARCO_FIXTURE))
        flags = ["--fixture", str(fx), "--tiny"] + (["--model_path", setup[2]["dpr"], "--split", "dev"]
                                                    if argv[0] == "dpr" else [])
        out = {pkg: setup[0] / pkg / label for pkg in ("jax", "port")}
        jax_main(argv + flags + ["--output_dir", str(out["jax"])])
        main(argv + flags + ["--output_dir", str(out["port"]), "--device", DEVICE])
        name = "ir_eval_results.csv" if argv[0] == "dpr" else "performance_bm25_mmarco-fr_dev.json"
        want, got = (_csv(str(out[p] / name)) if argv[0] == "dpr" else [_json(str(out[p] / name))] for p in out)
        strip = lambda rows: [{k: v for k, v in r.items() if "latency" not in k and "ms/" not in k} for r in rows]  # noqa: E731
        assert strip(got) == strip(want) and got
        return
    if argv[0] == "monobert":
        out = _run(setup, "port", label, argv + ["--steps", "2", "--train_batch_size", "2"])
        final = os.path.join(out, "final")
        pairs = [("chat tribunal", "le chat noir"), ("loi", "un contrat de travail")]
        np.testing.assert_allclose(T5CrossEncoder.load(final, device=DEVICE).predict(pairs),
                                   JaxT5CrossEncoder.load(final).predict(pairs), atol=1e-5)
        return
    if argv[0] == "hybrid":
        j, p = _both(setup, label, argv + _model_flags(setup, ("dpr",)))
        want, got = _json(f"{j}/performance_hybrid.json"), _json(f"{p}/performance_hybrid.json")
        assert {k: v for k, v in got.items() if "latency" not in k} == pytest.approx(
            {k: v for k, v in want.items() if "latency" not in k}, abs=1e-9)
        return
    flags = argv + ["--index_dir", options_index, "--batch_size", "4"] + SERVE["default"][:-2] + _model_flags(setup)
    if "--ce_attention" not in argv:
        flags += ["--ce_attention", "einsum"]
    j, p = _both(setup, label, flags)
    if "--ce_attention" in argv:
        _assert_tsv_close(p, j, atol=1e-2)  # test_torch_attention_forms.py's einsum_bf16 bound
    elif "--ce_int8" in argv or "--encoders_int8" in argv:
        _assert_tsv_close(p, j, atol=INT8_TOL)
    else:
        _assert_tsv_equal(p, j)


def test_default_device_needs_the_card(setup):
    if torch.cuda.is_available():
        return
    root, fx, _ = setup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["bm25", "--fixture", fx, "--output_dir", str(root / "nocard"), "--tiny"])


def test_surface_imports_leave_jax_out():
    """The CLI, the pipeline, the server and the checkpoint reader import
    neither JAX, flax, msgpack nor the JAX package."""
    import subprocess
    import sys

    code = (
        "import sys; import fusion_tpu_torch.cli.main, fusion_tpu_torch.hybrid, fusion_tpu_torch.server, "
        "fusion_tpu_torch.models.checkpoint, fusion_tpu_torch.eval.metrics, fusion_tpu_torch.data.lleqa; "
        "print(sorted(m for m in ('jax', 'flax', 'msgpack', 'fusion_tpu') if m in sys.modules))"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=repo)
    assert out.stdout.strip() == "[]"
