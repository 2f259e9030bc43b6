"""The port's quickstart (``fusion_tpu_torch/examples/quickstart.py``)
against the JAX package's (``examples/quickstart.py``), on the CPU.

The JAX example runs once, unedited, with its models and results captured
(``init_train_state``, ``HybridSearcher.build`` / ``search`` and
``HybridPipeline``'s stages wrapped to record); the port's runs on the JAX
models' weights converted (``models/convert.py``), the dense one as JAX's
was before training, and trains it with the same recipe.

Tolerances: the trained dense parameters at ``rtol=2e-4, atol=1e-5`` (30
f32 AdamW steps; of the qkv biases the key third is left out: its gradient
is f32 noise, a key bias the softmax cancels, which Adam turns into steps
of the lr of either sign in either package); the fused lists' RRF scores at
1e-6 and the reranked logits at 1e-5, ids equal except within ties at that
tolerance; the metrics and the printed lines (but for the latency) equal."""

import contextlib
import io
import os
import runpy

import numpy as np
import pytest
import torch
from torch_parity import DEVICE, assert_ranked_match
from torch_train_parity import flat

from fusion_tpu_torch.examples import quickstart
from fusion_tpu_torch.models import convert
from fusion_tpu_torch.models.biencoder import BiEncoder
from fusion_tpu_torch.models.colbert import ColBERT
from fusion_tpu_torch.models.crossencoder import CrossEncoder
from fusion_tpu_torch.models.encoder import EncoderConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _record(mp, owner, name, kept, key, bind=None):
    """Wrap ``owner.name`` so each call's result (and the wrapped object's
    arguments, through ``bind``) lands in ``kept``."""
    real = getattr(owner, name)

    def wrapper(*a, **kw):
        out = real(*a, **kw)
        kept[key] = out
        if bind is not None:
            bind(kept, a, kw)
        return out

    mp.setattr(owner, name, wrapper)


@pytest.fixture(scope="module")
def runs():
    import jax

    import fusion_tpu.hybrid as jhybrid
    import fusion_tpu.serving as jserving
    import fusion_tpu.train.trainer as jtrainer

    kept = {}
    mp = pytest.MonkeyPatch()
    real_init = jtrainer.init_train_state

    def init_train_state(model, cfg):
        # the train step donates the parameters' buffers: keep a host copy
        kept["dense"], kept["dense_init"] = model, jax.tree_util.tree_map(np.array, model.params)
        return real_init(model, cfg)

    real_build = jserving.HybridSearcher.build.__func__

    def build(cls, *a, **kw):
        kept["searcher"] = real_build(cls, *a, **kw)
        return kept["searcher"]

    mp.setattr(jtrainer, "init_train_state", init_train_state)
    mp.setattr(jserving.HybridSearcher, "build", classmethod(build))
    _record(mp, jserving.HybridSearcher, "search", kept, "fused")
    _record(mp, jhybrid.HybridPipeline, "bm25_search", kept, "candidates")
    _record(mp, jhybrid.HybridPipeline, "cross_encoder_search", kept, "reranked",
            bind=lambda k, a, kw: k.update(ce=a[3]))
    _record(mp, jhybrid.HybridPipeline, "evaluate", kept, "metrics")
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(os.path.join(REPO, "examples", "quickstart.py"), run_name="__main__")
    finally:
        mp.undo()
    kept["stdout"] = out.getvalue().splitlines()

    cfg = EncoderConfig.tiny(vocab_size=1024)
    kw = dict(max_query_length=8, max_doc_length=16, device=DEVICE)
    searcher = kept["searcher"]
    models = {
        "dense": BiEncoder(cfg, params=convert.encoder_state_dict(kept["dense_init"]), head="dense", **kw),
        "splade": BiEncoder(cfg, params=convert.encoder_with_mlm_state_dict(searcher.splade_model.params),
                            head="splade", **kw),
        "colbert": ColBERT(cfg, params=convert.colbert_state_dict(searcher.colbert_model.params), dim=16, **kw),
        "ce": CrossEncoder(cfg, params=convert.crossencoder_state_dict(kept["ce"].params), max_length=24,
                           device=DEVICE),
    }
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = quickstart.main(DEVICE, models=models)
    got["stdout"] = out.getvalue().splitlines()
    return kept, got, models


def test_trained_dense_parameters_match_jax(runs):
    kept, _, models = runs
    want = flat(kept["dense"].params)
    dense = models["dense"]
    got = flat(dense.flax_tree(dense.module.state_dict()))
    assert set(got) == set(want)
    for k, w in want.items():
        g = np.asarray(got[k])
        if k[-3:] == ("attention", "qkv", "bias"):
            g, w = g[[0, 2]], w[[0, 2]]
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=1e-5, err_msg=str(k))
    init = flat(kept["dense_init"])
    assert sum(not np.array_equal(want[k], init[k]) for k in want) > len(want) // 2


def test_fused_lists_match_jax(runs):
    kept, got, _ = runs
    want, _ = kept["fused"]
    fused = got["fused"]
    assert fused.ids.device.type == DEVICE
    assert_ranked_match(fused.ids, fused.scores, np.asarray(want.ids), np.asarray(want.scores), atol=1e-6)
    assert fused.id_lists() == want.id_lists()


def test_reranked_lists_and_metrics_match_jax(runs):
    kept, got, _ = runs
    cand, reranked = kept["candidates"].ranked, kept["reranked"].ranked
    np.testing.assert_array_equal(got["candidates"].ids.numpy(), np.asarray(cand.ids))
    assert_ranked_match(got["reranked"].ids, got["reranked"].scores, np.asarray(reranked.ids),
                        np.asarray(reranked.scores), atol=1e-5)
    assert got["metrics"].keys() == kept["metrics"].keys()
    for name, value in kept["metrics"].items():
        assert got["metrics"][name] == pytest.approx(value, abs=1e-9), name


def test_prints_the_lines_of_the_jax_example(runs):
    kept, got, _ = runs
    want, lines = kept["stdout"], got["stdout"]
    assert len(lines) == len(want) == 4
    for g, w in zip(lines, want):
        if w.startswith("hybrid search: "):
            assert g.startswith("hybrid search: ") and g.endswith(" ms/query")
        else:
            assert g == w
    assert got["fused_recall@5"] == pytest.approx(float(want[3].split()[-1]), abs=5e-4)


def test_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main()
    assert quickstart.parse_args([]).device == "cuda"
    assert quickstart.parse_args(["--device", "cpu"]).device == "cpu"
