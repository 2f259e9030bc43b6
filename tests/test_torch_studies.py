"""The port's three CPU studies (``fusion_tpu_torch.tools.preprocessor_study``,
``cascade_study`` and ``int8_encoder_study``) against the JAX package's
scripts of the same names, on the CPU.

  * preprocessor: the inventory and the world (the raw docs and queries the
    first pipeline receives) are the script's, and the report is equal;
  * cascade and int8: ``build_world`` is bit-equal; the script runs at small
    sizes with its own training (``train_ce`` / ``fit``), and the port's
    measurement runs on those weights converted (``models/convert.py``),
    with the script's generator state after training: the reports are
    equal.

Tolerances: every rank-derived metric (MRR, recall, agreement, overlap,
rank changes) exactly, but for the int8 cross-encoder view: an activation
an f32 ulp apart from JAX's may round to the next int8 code, so its logits
are held within 5e-3 of JAX's (95 % of them within 1e-5) and the gold's
rank is equal wherever no other candidate's logit lies within 1e-2 of it;
the score correlations of the int8 views within 1e-3."""

import contextlib
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from fusion_tpu_torch.models import convert
from fusion_tpu_torch.models.biencoder import BiEncoder
from fusion_tpu_torch.tools import cascade_study, int8_encoder_study, preprocessor_study

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")


def _load(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _main_json(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [f"{mod.__name__}.py", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main()
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_preprocessor_study_matches_the_script(monkeypatch, tmp_path):
    import fusion_tpu.data.preprocessor as jpre

    mod = _load("preprocessor_study")
    assert preprocessor_study.build_inventory() == mod.build_inventory()

    seen = []

    class Recording(jpre.TextPreprocessor):
        def preprocess(self, texts, *a, **kw):
            if len(texts) > 1:
                seen.append(list(texts))
            return super().preprocess(texts, *a, **kw)

    monkeypatch.setattr(jpre, "TextPreprocessor", Recording)
    # the script writes its JSON beside its parent directory: point it here
    monkeypatch.setattr(mod, "__file__", str(tmp_path / "scripts" / "preprocessor_study.py"))
    want = _main_json(mod, [], monkeypatch)
    assert json.loads((tmp_path / "PREPROC_STUDY_r03.json").read_text()) == want

    world = preprocessor_study.build_world(np.random.default_rng(42))
    assert world["docs"] == seen[0] and world["queries"] == seen[1]
    got = preprocessor_study.measure(world, "cpu")
    assert got.pop("fallback_stemmer") == "snowball_conflation"
    assert got == want


def test_preprocessor_study_without_nltk(monkeypatch):
    """Where nltk is missing (the card's machine), the fallback is the light
    lemmatizer, the raw Snowball pipeline is left out, and the record says
    so."""
    monkeypatch.setitem(sys.modules, "nltk", None)
    monkeypatch.setitem(sys.modules, "nltk.stem.snowball", None)
    got = preprocessor_study.measure(preprocessor_study.build_world(np.random.default_rng(1), 300, 20), "cpu")
    assert got["fallback_stemmer"] == "light"
    assert set(got["pipelines"]) == {"none", "fallback_light", "fallback", "oracle"}
    assert got["pipelines"]["fallback"] == got["pipelines"]["fallback_light"]
    assert set(got["form_conflation_accuracy"]) == {"fallback", "fallback_light"}


def test_preprocessor_study_writes_only_when_asked(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    world = preprocessor_study.build_world
    monkeypatch.setattr(preprocessor_study, "build_world", lambda rng: world(rng, n_docs=300, n_queries=20))
    out = tmp_path / "study.json"
    got = preprocessor_study.main(["--device", "cpu", "--out", str(out)])
    assert got["corpus_docs"] == 300 and got["queries"] == 20
    assert json.loads(out.read_text()) == got
    assert sorted(os.listdir(tmp_path)) == ["study.json"]


@pytest.mark.parametrize("args", [(64, 6, 44), (5, 3, 30)])
def test_planted_worlds_are_bit_equal(args):
    mod = _load("cascade_study")
    positions = {"early": 1, "middle": 18, "late": 20}
    want = mod.build_world(np.random.default_rng(42), *args, sig_words=3, positions=positions)
    got = cascade_study.build_world(np.random.default_rng(42), *args, sig_words=3, positions=positions)
    assert got[0] == want[0] and got[3] == want[3]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


CASCADE_ARGS = ["--n_topics", "16", "--docs_per_topic", "6", "--candidates", "16", "--steps", "12",
                "--batch", "16", "--int8"]


def test_cascade_study_measures_as_the_script_on_its_weights(monkeypatch):
    import fusion_tpu.models.crossencoder as jce

    from fusion_tpu_torch.models.crossencoder import PairRerankMixin

    mod = _load("cascade_study")
    trained, logits = {}, {"jax": [], "port": []}
    jax_train = mod.train_ce

    def train_and_keep(ce, corpus, doc_topic, queries, steps, batch, rng, **kw):
        loss = jax_train(ce, corpus, doc_topic, queries, steps, batch, rng, **kw)
        trained.update(ce=ce, corpus=list(corpus), rng_state=rng.bit_generator.state, loss=loss)
        return loss

    def recording(cls, side):
        flat = cls.rerank_tokens

        def rerank_tokens(self, *a, **kw):
            out = flat(self, *a, **kw)
            logits[side].append(np.asarray(out))
            return out

        monkeypatch.setattr(cls, "rerank_tokens", rerank_tokens)

    recording(jce.CrossEncoder, "jax")
    recording(PairRerankMixin, "port")
    monkeypatch.setattr(mod, "train_ce", train_and_keep)
    want = _main_json(mod, CASCADE_ARGS, monkeypatch)

    def converted(ce, corpus, doc_topic, queries, steps, batch, rng):
        assert list(corpus) == trained["corpus"]
        ce.module.load_state_dict(convert.crossencoder_state_dict(trained["ce"].params))
        rng.bit_generator.state = trained["rng_state"]
        return trained["loss"]

    got = cascade_study.run(cascade_study.parse_args([*CASCADE_ARGS, "--device", "cpu"]), train=converted)
    assert got["setup"].pop("device") == "cpu"
    g8, w8 = got.pop("int8_flat"), want.pop("int8_flat")
    assert got == want  # the f32 flat rerank and every cascade cell
    assert len(got["cascade_grid"]) == 12

    # the int8 view (the second flat call of each side): an f32 activation
    # an ulp apart from JAX's can round to the next int8 code (1/127 of its
    # row's max), so a few logits move by up to 5e-3 and the rest agree to
    # f32 sums; the gold's rank is equal wherever no candidate's logit lies
    # within 1e-2 of the gold's (on this barely trained model many do)
    diff = np.abs(logits["port"][1] - logits["jax"][1])
    assert diff.max() <= 5e-3 and np.mean(diff <= 1e-5) >= 0.95, (diff.max(), np.mean(diff <= 1e-5))
    assert g8.pop("score_corr_vs_f32") == pytest.approx(w8.pop("score_corr_vs_f32"), abs=1e-3)
    rng = np.random.default_rng()
    rng.bit_generator.state = trained["rng_state"]
    _, doc_topic, doc_pos, _ = cascade_study.build_world(np.random.default_rng(42), 16, 6, 44, sig_words=3,
                                                         positions=cascade_study.POSITIONS)
    _, gold_slot, gold_pos = cascade_study.candidates(rng, doc_topic, doc_pos, 16, 16)
    assert cascade_study.gold_metrics(logits["jax"][1], gold_slot, gold_pos) == w8
    assert set(g8) == set(w8)
    for q in range(16):
        jl, pl = logits["jax"][1][q], logits["port"][1][q]
        gap = np.abs(np.delete(jl, gold_slot[q]) - jl[gold_slot[q]]).min()
        if gap > 1e-2:
            assert np.sum(pl > pl[gold_slot[q]]) == np.sum(jl > jl[gold_slot[q]]), q


def test_cascade_training_lowers_the_loss():
    args = cascade_study.parse_args(["--n_topics", "8", "--docs_per_topic", "4", "--candidates", "8",
                                     "--steps", "6", "--batch", "8", "--device", "cpu"])
    got = cascade_study.run(args)
    assert np.isfinite(got["setup"]["final_bce"])
    assert got["flat"]["all"]["n"] == 8 and got["int8_flat"] is None


INT8_ARGS = ["--n_topics", "16", "--docs_per_topic", "6", "--steps", "12", "--batch", "8"]


def test_int8_encoder_study_measures_as_the_script_on_its_weights(monkeypatch):
    import fusion_tpu
    import fusion_tpu.train.trainer as jtrainer

    mod = _load("int8_encoder_study")
    monkeypatch.syspath_prepend(SCRIPTS)  # the script imports cascade_study's world
    kept = {"models": []}
    jax_fit = jtrainer.fit

    class Keeping(fusion_tpu.BiEncoder):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            kept["models"].append(self)

    def fit_and_keep(model, *a, **kw):
        out = jax_fit(model, *a, **kw)
        kept["dense"] = model
        return out

    monkeypatch.setattr(fusion_tpu, "BiEncoder", Keeping)
    monkeypatch.setattr(jtrainer, "fit", fit_and_keep)
    want = _main_json(mod, INT8_ARGS, monkeypatch)
    jax_splade = [m for m in kept["models"] if m.head == "splade"][0]

    def converted(dense, *a):
        dense.module.load_state_dict(convert.encoder_state_dict(kept["dense"].params))

    args = int8_encoder_study.parse_args([*INT8_ARGS, "--device", "cpu"])
    splade = BiEncoder(int8_encoder_study.model_config("tiny"), params=convert.encoder_with_mlm_state_dict(
        jax_splade.params), head="splade", max_query_length=8, max_doc_length=32, device="cpu")
    got = int8_encoder_study.run(args, train=converted, splade=splade)
    assert got["setup"].pop("platform") == "cpu" and want["setup"].pop("platform") == "cpu"
    assert got.pop("splade_activation_corr") == pytest.approx(want.pop("splade_activation_corr"), abs=1e-3)
    assert got == want


def test_int8_world_is_the_cascade_world():
    corpus, doc_topic, queries, qrels = int8_encoder_study.build_world(8, 4)
    want = cascade_study.build_world(np.random.default_rng(42), 8, 4, doc_words=24, sig_words=3,
                                     positions={"mid": 10})
    assert corpus == want[0] and queries == want[3]
    assert qrels == {t: np.flatnonzero(doc_topic == t).tolist() for t in range(8)}


@pytest.mark.parametrize("tool", [preprocessor_study, cascade_study, int8_encoder_study])
def test_the_card_is_the_default(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])
