"""``ShardedHybridSearcher`` (``fusion_tpu_torch/serving_sharded.py``) against
the JAX package's on the CPU.

The collective path runs in real processes: a pod of two port processes
joined over gloo (``tests/torch_pod.py``; one process cannot be two ranks of
a group) builds every configuration of ``tests/test_serving_sharded.py`` from
weights converted from the JAX package's models (and JAX's compressed ColBERT
index: the packages' k-means differ), shards it over a mesh of two index
ranks and searches five queries in two batches of 4.  The parent (which has
JAX) runs JAX's ``ShardedHybridSearcher`` on an index = 2 mesh of the
conftest's virtual devices over the same configuration, while the pod runs,
and compares: each leg's merged list (``search_systems``) within the leg's
bound (BM25, SPLADE impact / scatter / rescore 1e-5: f32 sums in another
order; int8 DPR and SPLADE, ColBERT 2^-8: an ulp of difference in an f32
query flips some bf16 roundings), the fused lists without the rerank at 1e-6
(RRF; a single leg at its own bound), and the reranked lists (logits through
the sigmoid within rtol 1e-4 / atol 1e-5, the rerank tests' bound, beside the
fused bound of the scores they are shifted above), ids equal but inside runs
of scores that tie within the bound; the two ranks' lists bit-equal; the reranked head a
permutation of the fused head.  Configurations: the four legs with the flat
rerank, BM25 only, dense ``fused``, the dense / SPLADE matrix form, scatter
SPLADE, the packed rerank, the cascade rerank (and its degenerate settings
equal to the flat one), the two-stage SPLADE rescore over the impact and the
scatter index; ``search_systems`` of each.

In process, without a process group: the sharded searcher on a mesh of one
rank equals the single-device ``HybridSearcher`` bit for bit, and the HTTP
server serves it; a mesh with ``data`` or ``model`` ranks is refused by the
server (a mesh of index ranks is served: ``tests/test_torch_server_sharded.py``).  JAX's ``test_sharded_programs_are_cached`` has no
counterpart: there is no compiled mesh program.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
from test_serving_sharded import CORPUS, QUERIES
from torch_parity import DEVICE, assert_ranked_match
from torch_pod import CONFIGS, MODEL_ARGS, _build, _models, start_pod

from fusion_tpu.data.preprocessor import TextPreprocessor as JaxPrep
from fusion_tpu.models.biencoder import BiEncoder as JaxBiEncoder
from fusion_tpu.models.colbert import ColBERT as JaxColBERT
from fusion_tpu.models.crossencoder import CrossEncoder as JaxCrossEncoder
from fusion_tpu.models.encoder import EncoderConfig as JaxConfig
from fusion_tpu.parallel.sharding import make_mesh as jax_make_mesh
from fusion_tpu.serving import HybridSearcher as JaxSearcher
from fusion_tpu.serving_sharded import ShardedHybridSearcher as JaxSharded
from fusion_tpu_torch.data.preprocessor import TextPreprocessor
from fusion_tpu_torch.models import convert
from fusion_tpu_torch.parallel.sharding import make_mesh
from fusion_tpu_torch.serving_sharded import ShardedHybridSearcher

SEARCH_QUERIES = QUERIES + ["loi consommateur voiture", "fromage pain livre"]
BF16_QUERY = 2.0**-8
RERANKED = ("full", "packed", "flat", "cascade", "cascade_degenerate")


def _leg_atol(config: str, system: str) -> float:
    if system in ("dpr", "colbert") or (system == "splade" and config == "matrix"):
        return BF16_QUERY
    return 1e-5


@pytest.fixture(scope="module")
def jax_models():
    cfg = JaxConfig.tiny(vocab_size=512)
    kw = dict(max_query_length=8, max_doc_length=16)
    return {
        "dense": JaxBiEncoder(cfg, head="dense", **kw),
        "splade": JaxBiEncoder(cfg, head="splade", **kw),
        "colbert": JaxColBERT(cfg, dim=16, **kw),
        "ce": JaxCrossEncoder(JaxConfig.tiny(vocab_size=512), max_length=32),
    }


def _jax_build(name, models):
    systems, opts, fields = CONFIGS[name]
    prep = JaxPrep(spacy_model=None)
    kw = {MODEL_ARGS[s]: models[s] for s in systems if s != "bm25"}
    if "bm25" in systems:
        kw.update(bm25_docs=prep.preprocess(list(CORPUS.values())),
                  bm25_preprocess=lambda t: prep.preprocess(list(t)))
    if "colbert" in systems:
        kw["plaid_topk_impl"] = "exact"  # the port's selects are exact
    return JaxSearcher.build(CORPUS, **kw, **opts)


@pytest.fixture(scope="module")
def payload(jax_models):
    """The converted weights, the corpus, the queries and the JAX full
    searcher's compressed ColBERT index, for the pod and the in-process
    tests."""
    full = _jax_build("full", jax_models)
    ci, ivf = full.colbert_index, full.colbert_ivf
    m = jax_models
    return full, {
        "models": {
            "dense": convert.encoder_state_dict(m["dense"].params),
            "splade": convert.encoder_with_mlm_state_dict(m["splade"].params),
            "colbert": convert.colbert_state_dict(m["colbert"].params),
            "ce": convert.crossencoder_state_dict(m["ce"].params),
        },
        "corpus": CORPUS,
        "queries": SEARCH_QUERIES,
        "colbert": {k: np.asarray(v) for k, v in dict(
            centroids=ci.centroids, centroid_ids=ci.centroid_ids, codes=ci.codes, mask=ci.mask,
            bucket_weights=ci.bucket_weights, ivf_doc=ivf.ivf_doc).items()}
        | {"nbits": ci.nbits, "n_docs": ivf.n_docs, "cap": ivf.cap},
    }


@pytest.fixture(scope="module")
def pod(tmp_path_factory, payload):
    d = tmp_path_factory.mktemp("serving_pod")
    torch.save(payload[1], d / "payload.pt")
    return start_pod(d, "serving", timeout=300)


@pytest.fixture(scope="module")
def jax_results(jax_models, payload, pod):
    """JAX's index = 2 mesh searcher over every configuration (computed while
    the pod runs)."""
    mesh = jax_make_mesh(data=1, model=1, index=2, devices=jax.devices()[:2])
    out = {}
    for name, (_, _, fields) in CONFIGS.items():
        single = payload[0] if name == "full" else _jax_build(name, jax_models)
        sharded = JaxSharded.from_searcher(single, mesh)
        for field, value in fields.items():
            setattr(sharded, field, value)
        ranked, _ = sharded.search(SEARCH_QUERIES, batch_size=4, use_pallas=False)
        depth, sharded.rerank_depth = sharded.rerank_depth, 0
        fused, _ = sharded.search(SEARCH_QUERIES, batch_size=4, use_pallas=False)
        sharded.rerank_depth = depth
        out[name] = {
            "systems": sharded.active_systems,
            "search": {"ids": np.asarray(ranked.ids), "scores": np.asarray(ranked.scores)},
            "fused": {"ids": np.asarray(fused.ids), "scores": np.asarray(fused.scores)},
            "legs": {s: {"ids": np.asarray(r.ids), "scores": np.asarray(r.scores)}
                     for s, r in sharded.search_systems(SEARCH_QUERIES, batch_size=4, use_pallas=False).items()},
        }
    return out


@pytest.fixture(scope="module")
def port_results(pod, jax_results):
    return pod.results()


def _match(got, want, atol):
    assert_ranked_match(got["ids"], got["scores"], want["ids"], want["scores"], atol=atol, cut_ties=True)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_legs_match_jax(port_results, jax_results, config):
    """Each leg's merged list (``search_systems``) against JAX's mesh
    program; the active systems as JAX's."""
    want = jax_results[config]
    got = port_results[0][config]
    assert got["systems"] == want["systems"]
    assert set(got["legs"]) == set(want["legs"])
    for system in want["legs"]:
        _match(got["legs"][system], want["legs"][system], _leg_atol(config, system))


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_fused_and_reranked_lists_match_jax(port_results, jax_results, config):
    """Fused (RRF over several legs: 1e-6; one leg: its own bound), then the
    reranked list: the tail keeps the fused bound and the head's scores are
    sigmoid(logit) shifted above the tail, so its bound adds the rerank
    tests' (rtol 1e-4, atol 1e-5) to the fused one."""
    want, got = jax_results[config], port_results[0][config]
    legs = list(want["legs"])
    fused_atol = _leg_atol(config, legs[0]) if len(legs) == 1 else 1e-6
    _match(got["fused"], want["fused"], fused_atol)
    if config in RERANKED:
        w_sc = want["search"]["scores"]
        _match(got["search"], want["search"], fused_atol + 1e-5 + 1e-4 * float(np.abs(w_sc[np.isfinite(w_sc)]).max()))
        for qi in range(len(SEARCH_QUERIES)):  # the reranked head is a permutation of the fused head
            assert set(got["search"]["ids"][qi, :4]) == set(got["fused"]["ids"][qi, :4])
    else:
        np.testing.assert_array_equal(got["search"]["ids"], got["fused"]["ids"])


def test_ranks_agree(port_results):
    """Every list is replicated: the two ranks' are bit-equal."""
    a, b = port_results
    assert a["mesh"]["coords"]["index"] == 0 and b["mesh"]["coords"]["index"] == 1
    for config in CONFIGS:
        for key in ("search", "fused"):
            for field in ("ids", "scores"):
                np.testing.assert_array_equal(a[config][key][field], b[config][key][field])


def test_cascade_degenerate_equals_flat(port_results):
    """keep = depth and a stage 1 past the doc width: the cascade is the flat
    rerank (JAX's own check, on the pod)."""
    got = port_results[0]
    np.testing.assert_array_equal(got["cascade_degenerate"]["search"]["ids"], got["flat"]["search"]["ids"])


# ----------------------------------------------------------------------
# in process: a mesh of one rank, without a process group
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def port_single(payload):
    models, prep = _models(payload[1]), TextPreprocessor(spacy_model=None)
    return {name: _build(name, CORPUS, models, prep, payload[1]["colbert"])
            for name in ("full", "packed", "cascade", "rescore_scatter", "dense_fused")}


@pytest.mark.parametrize("config", ["full", "packed", "cascade", "rescore_scatter", "dense_fused"])
def test_one_rank_mesh_equals_the_single_device_searcher(port_single, config):
    single = port_single[config]
    mesh = make_mesh(index=1, devices=[DEVICE])
    sharded = ShardedHybridSearcher.from_searcher(single, mesh)
    if config == "dense_fused":
        sharded.dense_impl = single.dense_impl = "fused"
    assert sharded.active_systems == single.active_systems
    want, got = single.search_systems(SEARCH_QUERIES, batch_size=4), sharded.search_systems(SEARCH_QUERIES, 4)
    for system in want:
        assert torch.equal(got[system].ids, want[system].ids), system
        assert torch.equal(got[system].scores, want[system].scores), system
    (want, _), (got, _) = single.search(SEARCH_QUERIES, batch_size=4), sharded.search(SEARCH_QUERIES, 4)
    assert torch.equal(got.ids, want.ids) and torch.equal(got.scores, want.scores)


def test_server_serves_a_one_rank_mesh_and_refuses_more(port_single):
    import json
    import urllib.request

    from fusion_tpu_torch.server import SearchServer

    sharded = ShardedHybridSearcher.from_searcher(port_single["packed"], make_mesh(index=1, devices=[DEVICE]))
    srv = SearchServer(sharded, host="127.0.0.1", port=0, max_batch=4, max_wait_ms=2.0)
    srv.start()
    try:
        host, port = srv.address
        req = urllib.request.Request(f"http://{host}:{port}/search", data=json.dumps(
            {"queries": [SEARCH_QUERIES[0]], "topk": 3}).encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            got = json.loads(r.read())["results"][0]["ids"]
    finally:
        srv.stop()
    want, _ = sharded.search(SEARCH_QUERIES[:1] * 4, batch_size=4)
    assert got == want.ids.numpy()[0, :3].tolist()
    # a mesh of more ranks is served along index alone (tests/test_torch_server_sharded.py's
    # pod); data or model ranks would repeat every search
    mesh = make_mesh(index=1, devices=[DEVICE])
    for shape in ({"data": 2, "model": 1, "index": 1}, {"data": 1, "model": 2, "index": 1}):
        with pytest.raises(ValueError, match="along index alone"):
            SearchServer(types.SimpleNamespace(mesh=dataclasses.replace(mesh, shape=shape)))


def test_from_searcher_refusals(port_single, payload):
    single = port_single["dense_fused"]
    with pytest.raises(ValueError, match="place"):
        ShardedHybridSearcher.from_searcher(single, make_mesh(index=1, devices=[DEVICE]), None, None, None, "yes")
    models = _models(payload[1])
    from fusion_tpu_torch.serving import HybridSearcher

    plain = HybridSearcher.build(CORPUS, colbert_model=models["colbert"], topk=8, batch_size=4, device=DEVICE)
    with pytest.raises(ValueError, match="compressed ColBERT"):
        ShardedHybridSearcher.from_searcher(plain, make_mesh(index=1, devices=[DEVICE]))
