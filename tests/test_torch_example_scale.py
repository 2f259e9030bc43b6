"""The port's corpus-scale walkthrough
(``fusion_tpu_torch/examples/scale_serving.py``) against the JAX package's
(``examples/scale_serving.py``, which runs at import), on the CPU.

The JAX example runs once, unedited, with its searcher, its lists and the
index directory it saves captured; the port's runs on the JAX models'
weights converted (``models/convert.py``).  Its BM25 and SPLADE indexes are
its own builds; its PLAID index and IVF are JAX's, loaded from JAX's saved
directory (the two packages' k-means draw different numbers, a stated
difference), in place of its own.

Tolerances: as ``test_torch_serving_scale.py`` / ``_plaid.py``: BM25 and
SPLADE at 1e-5 (f32 sums in another order), ColBERT at 2^-8 (an ulp of the
f32 query tokens flips some bf16 roundings), ids equal except within ties
at that tolerance; the fused RRF lists at 1e-6 against JAX's fusion of the
port's legs (a ColBERT near-tie that flips moves the fused scores), their
head equal to JAX's; the printed lines equal but for the latency."""

import contextlib
import io
import os
import runpy
import shutil

import numpy as np
import pytest
import torch
from torch_parity import DEVICE, assert_ranked_match

from fusion_tpu_torch.examples import scale_serving
from fusion_tpu_torch.models import convert
from fusion_tpu_torch.models.biencoder import BiEncoder
from fusion_tpu_torch.models.colbert import ColBERT
from fusion_tpu_torch.models.encoder import EncoderConfig
from fusion_tpu_torch.serving import HybridSearcher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = {"bm25": 1e-5, "splade": 1e-5, "colbert": 2.0**-8}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import fusion_tpu.serving as jserving

    saved = str(tmp_path_factory.mktemp("jax_indexes") / "idx")
    kept = {"searches": []}
    mp = pytest.MonkeyPatch()
    real_build = jserving.HybridSearcher.build.__func__
    real_save, real_search = jserving.HybridSearcher.save_indexes, jserving.HybridSearcher.search

    def build(cls, *a, **kw):
        kept["searcher"] = real_build(cls, *a, **kw)
        return kept["searcher"]

    def save_indexes(self, path, *a, **kw):
        real_save(self, path, *a, **kw)
        shutil.copytree(path, saved)

    def search(self, *a, **kw):
        out = real_search(self, *a, **kw)
        kept["searches"].append(out[0])
        return out

    mp.setattr(jserving.HybridSearcher, "build", classmethod(build))
    mp.setattr(jserving.HybridSearcher, "save_indexes", save_indexes)
    mp.setattr(jserving.HybridSearcher, "search", search)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(os.path.join(REPO, "examples", "scale_serving.py"), run_name="__main__")
    finally:
        mp.undo()
    kept["stdout"] = out.getvalue().splitlines()

    jax_searcher = kept["searcher"]
    cfg = EncoderConfig.tiny(vocab_size=2048)
    kw = dict(max_query_length=16, max_doc_length=32, device=DEVICE)
    models = {
        "splade": BiEncoder(cfg, params=convert.encoder_with_mlm_state_dict(jax_searcher.splade_model.params),
                            head="splade", **kw),
        "colbert": ColBERT(cfg, params=convert.colbert_state_dict(jax_searcher.colbert_model.params), dim=16,
                           **kw),
    }
    jax_plaid = HybridSearcher(corpus_ids=np.array([]), colbert_model=models["colbert"],
                               device=DEVICE).load_indexes(saved)
    port_build = HybridSearcher.build.__func__

    def build_on_jax_plaid(cls, *a, **kw):
        searcher = port_build(cls, *a, **kw)
        kept["own_ivf_shape"] = tuple(searcher.colbert_ivf.ivf_doc.shape)
        searcher.colbert_index, searcher.colbert_ivf = jax_plaid.colbert_index, jax_plaid.colbert_ivf
        return searcher

    mp.setattr(HybridSearcher, "build", classmethod(build_on_jax_plaid))
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            got = scale_serving.main(DEVICE, models=models)
    finally:
        mp.undo()
    got["stdout"] = out.getvalue().splitlines()
    return kept, got


@pytest.mark.parametrize("system", sorted(ATOL))
def test_each_leg_matches_jax(runs, system):
    kept, got = runs
    want = kept["searcher"].search_systems(scale_serving.QUERIES, batch_size=16, use_pallas=False)[system]
    leg = got["searcher"].search_systems(scale_serving.QUERIES, batch_size=16)[system]
    assert_ranked_match(leg.ids, leg.scores, np.asarray(want.ids), np.asarray(want.scores), atol=ATOL[system],
                        cut_ties=system == "colbert")


def test_bm25_index_equals_jax(runs):
    kept, got = runs
    want, index = kept["searcher"].bm25_impact_index, got["searcher"].bm25_impact_index
    np.testing.assert_array_equal(index.post_doc.numpy(), np.asarray(want.post_doc))
    np.testing.assert_array_equal(index.post_impact.numpy(), np.asarray(want.post_impact))


def test_fused_lists_are_jax_fusion_of_the_legs(runs):
    """The fused lists are JAX's RRF of the port's legs (each held to JAX's
    above; a ColBERT near-tie that flips moves the fused scores, so the
    fused lists are held to JAX's at the head the example prints)."""
    import jax.numpy as jnp

    from fusion_tpu.core.ranked import RankedLists as JaxRanked
    from fusion_tpu.fusion.aggregator import Aggregator

    kept, got = runs
    legs = got["searcher"].search_systems(scale_serving.QUERIES, batch_size=16)
    want = Aggregator.fuse({s: JaxRanked(jnp.asarray(r.ids.numpy()), jnp.asarray(r.scores.numpy()))
                            for s, r in legs.items()}, "rrf", return_topk=32)
    for ranked in (got["ranked"], got["reloaded"]):
        assert ranked.ids.device.type == DEVICE
        assert_ranked_match(ranked.ids, ranked.scores, np.asarray(want.ids), np.asarray(want.scores), atol=1e-6)
    np.testing.assert_array_equal(got["reloaded"].ids.numpy(), got["ranked"].ids.numpy())
    jax_fused, jax_reloaded = kept["searches"]
    np.testing.assert_array_equal(np.asarray(jax_reloaded.ids), np.asarray(jax_fused.ids))
    np.testing.assert_array_equal(got["ranked"].ids.numpy()[:, :5], np.asarray(jax_fused.ids)[:, :5])


def test_prints_the_lines_of_the_jax_example(runs):
    kept, got = runs
    want, lines = kept["stdout"], got["stdout"]
    assert len(lines) == len(want) == 8
    for g, w in zip(lines, want):
        if w.startswith("latency: "):
            assert g.startswith("latency: ") and g.endswith(" ms/query (cpu)")
        else:
            assert g == w
    assert got["ivf_shape"] == kept["own_ivf_shape"] == tuple(kept["searcher"].colbert_ivf.ivf_doc.shape)


def test_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scale_serving.main()
    assert scale_serving.parse_args(["--device", "cpu"]).device == "cpu"
