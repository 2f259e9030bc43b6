"""``SearchServer`` (``fusion_tpu_torch/server.py``) over a mesh of two
ranks, against the JAX package's server over its sharded searcher.

A pod of two port processes joined over gloo (``tests/torch_pod.py``, mode
``server``) serves ``ShardedHybridSearcher.from_searcher`` of the ``full``
configuration (the four legs and the flat rerank) from weights converted
from the JAX package's models: each rank builds ``SearchServer`` and calls
``start()``, rank 0 listens on 127.0.0.1 and feeds both ranks every batch.
Rank 0's client threads send ``REQUESTS`` at once (one or two queries each,
duplicates, ``topk`` 3 / 5 / 8).  The parent serves the same requests with
JAX's ``SearchServer`` over JAX's ``ShardedHybridSearcher`` on an index = 2
mesh of the conftest's CPU devices, and holds each answer per query at
``tests/test_torch_serving_sharded.py``'s bound of the reranked lists (plus
the 1e-6 of the servers' rounding to 6 decimals), ids equal but inside runs
of tied scores; each answer also equals the pod's own ``search`` lists for
the query (ids exact, scores within 1e-5).  ``/healthz`` is JAX's (the
global ``corpus_docs``), ``/stats`` has JAX's keys and counts.  A batch that
raises on both ranks gets a 500, and the next request succeeds.

Then the pod serves a ``SegmentedHybridSearcher(mesh=...)`` and updates it
through ``SearchServer.update`` (add, three deletes, compact, and an add the
searcher refuses on both ranks, which leaves the server serving); after each
step the answers over HTTP are held to JAX's sharded segmented searcher
after the same calls, as ``tests/test_torch_segmented.py`` holds the
sharded segments (the same top 1 and reranked head, all but one of the top
8).

In a second pod (mode ``server_fail``, a group timeout of a few seconds),
rank 1 alone raises on a request: rank 0 waits in the searcher's collective
and rank 1 in the server's, both raise at the timeout, and each rank's
server ends with an error and its process exits non-zero, well inside the
test's timeout.  In process: a mesh with ``data`` or ``model`` ranks is
refused by the server.
"""

import dataclasses
import json
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
from test_segmented import _corpus
from test_serving_sharded import CORPUS
from test_torch_serving_sharded import SEARCH_QUERIES, jax_models, payload  # noqa: F401 (fixtures)
from torch_parity import DEVICE, assert_ranked_match
from torch_pod import start_pod

from fusion_tpu import segmented as jax_segmented
from fusion_tpu.data.preprocessor import TextPreprocessor as JaxPrep
from fusion_tpu.parallel.sharding import make_mesh as jax_make_mesh
from fusion_tpu.server import SearchServer as JaxServer
from fusion_tpu.serving_sharded import ShardedHybridSearcher as JaxSharded
from fusion_tpu_torch.parallel.sharding import make_mesh
from fusion_tpu_torch.server import SearchServer

# one or two queries a request, duplicates across and within requests, mixed topk
REQUESTS = [{"queries": [SEARCH_QUERIES[i % 5]] + ([SEARCH_QUERIES[(i + 2) % 5]] if i % 4 == 3 else []),
             "topk": (3, 5, 8)[i % 3]} for i in range(32)]
REQUESTS[7]["queries"].append(REQUESTS[7]["queries"][0])
ROUNDING = 1e-6  # both servers round scores to 6 decimals
SERVER_KW = dict(host="127.0.0.1", port=0, max_batch=4, max_wait_ms=20.0)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def _jax_serve(searcher, requests):
    """JAX's server over ``searcher``: the answers to ``requests``, then
    /healthz and /stats (an answer does not depend on the batch it rode
    in: ``test_answers_equal_the_two_rank_searchers_own_lists``)."""
    srv = JaxServer(searcher, **SERVER_KW)
    srv.start()
    host, port = srv.address
    url = f"http://{host}:{port}"
    try:  # a few clients at once: JAX's server keeps http.server's listen backlog of 5
        with ThreadPoolExecutor(4) as pool:
            answers = list(pool.map(lambda r: _post(f"{url}/search", r), requests))
        return answers, _get(f"{url}/healthz"), _get(f"{url}/stats")
    finally:
        srv.stop()


@pytest.fixture(scope="module")
def served(tmp_path_factory, payload, jax_models):  # noqa: F811 (fixtures)
    """The pod's reports and JAX's answers (computed while the pod runs)."""
    full, pod_payload = payload
    a, b = _corpus(14, seed=3, base_id=100), _corpus(10, seed=4, base_id=500)
    d = tmp_path_factory.mktemp("server_pod")
    torch.save({**pod_payload, "requests": REQUESTS, "seg_a": a, "seg_b": b}, d / "payload.pt")
    pod = start_pod(d, "server", timeout=420)

    mesh = jax_make_mesh(data=1, model=1, index=2, devices=jax.devices()[:2])
    want = {"full": _jax_serve(JaxSharded.from_searcher(full, mesh), REQUESTS)}
    prep = JaxPrep(spacy_model=None)
    m = jax_models
    seg = jax_segmented.SegmentedHybridSearcher(
        a, bm25_docs=prep.preprocess(list(a.values())), mesh=mesh, dense_model=m["dense"],
        splade_model=m["splade"], cross_encoder=m["ce"], rerank_depth=4, batch_size=4, topk=8,
        bm25_preprocess=lambda t: prep.preprocess(list(t)), int8_corpus=True, ce_max_doc_tokens=24,
    )

    def lists():
        r, _ = seg.search(SEARCH_QUERIES, batch_size=4, use_pallas=False)
        return {"ids": np.asarray(r.ids), "scores": np.asarray(r.scores), "n_docs": seg.n_docs}

    want["one_segment"] = lists()
    seg.add_documents(b, bm25_docs=prep.preprocess(list(b.values())))
    want["two_segments"] = lists()
    seg.delete_documents(sorted(b)[:3])
    want["tombstoned"] = lists()
    seg.compact()
    want["compacted"] = lists()
    return pod.results(), want


def _reranked_atol(answers) -> float:
    """``test_torch_serving_sharded.py``'s bound of the reranked ``full``
    lists over ``answers``' scores, and the servers' rounding."""
    top = max(abs(s) for _, body in answers for r in body["results"] for s in r["scores"])
    return 1e-6 + 1e-5 + 1e-4 * top + ROUNDING


def test_answers_match_jax_server(served):
    (rank0, _), want = served
    jax_answers = want["full"][0]
    assert len(rank0["answers"]) == len(jax_answers) == len(REQUESTS)
    atol = _reranked_atol(jax_answers)
    for req, (code, got), (w_code, w) in zip(REQUESTS, rank0["answers"], jax_answers):
        assert code == w_code == 200
        assert len(got["results"]) == len(req["queries"])
        for g, r in zip(got["results"], w["results"]):
            assert len(g["ids"]) == len(r["ids"]) == req["topk"]
            assert_ranked_match([g["ids"]], [g["scores"]], [r["ids"]], [r["scores"]], atol=atol, cut_ties=True)


def test_answers_equal_the_two_rank_searchers_own_lists(served):
    """Each answer is the pod's own ``search`` list for its query: the
    batch a query rode in changes nothing (ids exact, scores within the
    rounding), and the two ranks' direct lists are bit-equal."""
    (rank0, rank1), _ = served
    direct = rank0["direct"]
    np.testing.assert_array_equal(direct["ids"], rank1["direct"]["ids"])
    np.testing.assert_array_equal(direct["scores"], rank1["direct"]["scores"])
    for req, (_, got) in zip(REQUESTS, rank0["answers"]):
        for q, g in zip(req["queries"], got["results"]):
            qi = SEARCH_QUERIES.index(q)
            k = req["topk"]
            assert g["ids"] == direct["ids"][qi, :k].tolist()
            np.testing.assert_allclose(g["scores"], direct["scores"][qi, :k], atol=1e-5, rtol=0)


def test_healthz_and_stats_as_jax(served):
    (rank0, _), want = served
    _, healthz, stats = want["full"]
    assert rank0["healthz"] == healthz
    assert healthz["corpus_docs"] == len(CORPUS)
    # the port's /stats adds the queue wait of the dispatched requests
    assert set(rank0["stats"]) == set(stats) | {"queue_wait_ms_total", "dispatched"}
    assert rank0["stats"]["dispatched"] == rank0["stats"]["requests"]
    for key in ("requests", "queries", "errors"):
        assert rank0["stats"][key] == stats[key], key
    assert 1 <= rank0["stats"]["batches"] < rank0["stats"]["requests"]  # the requests were coalesced


def test_a_batch_raising_on_every_rank_is_a_500_and_the_server_serves_on(served):
    (rank0, _), _ = served
    code, body = rank0["bad_batch"]
    assert code == 500 and "a bad batch on rank 0" in body["error"]
    code, body = rank0["after_bad_batch"]
    assert code == 200
    assert body["results"][0]["ids"] == rank0["direct"]["ids"][0, :8].tolist()


@pytest.mark.parametrize("step", ["one_segment", "two_segments", "tombstoned", "compacted"])
def test_segmented_updates_through_the_server_match_jax(served, step):
    """After the same add / delete / compact, the answers over HTTP hold
    JAX's sharded segmented lists as the sharded segment tests do, and
    ``/healthz`` counts JAX's live docs."""
    (rank0, rank1), want = served
    got = rank0["segmented"][step]
    w = want[step]
    assert got["corpus_docs"] == w["n_docs"]
    for qi, (code, body) in enumerate(got["answers"]):
        assert code == 200
        ids = body["results"][0]["ids"]
        w_ids = w["ids"][qi][np.isfinite(w["scores"][qi])].tolist()
        assert ids[0] == w_ids[0], (qi, ids, w_ids)
        assert set(ids[:4]) == set(w_ids[:4])
        assert len(set(ids) & set(w_ids)) >= len(w_ids) - 1
    if step in ("two_segments", "compacted"):
        assert got["n"] == (2 if step == "two_segments" else 1)
    assert rank1["segments_after"] == rank0["segments_after"] == 1


def test_an_update_refused_on_every_rank_leaves_the_server_serving(served):
    (rank0, _), _ = served
    seg = rank0["segmented"]
    assert "bm25_docs" in seg["refused_update"]
    results = lambda step: [(code, body["results"]) for code, body in seg[step]["answers"]]  # noqa: E731
    assert results("after_refused_update") == results("compacted")


def test_a_rank_failing_alone_ends_every_rank_with_an_error(tmp_path, payload):  # noqa: F811 (fixture)
    """Rank 1 alone raises on a request: rank 0 waits in the searcher's
    collective, rank 1 in the server's; at the group's timeout both raise,
    the request gets a 500, each server ends with an error and each process
    exits non-zero, within the test's timeout."""
    torch.save(payload[1], tmp_path / "payload.pt")
    pod = start_pod(tmp_path, "server_fail", timeout=180)
    codes = pod.returncodes()
    assert all(c != 0 for c in codes), codes
    reports = pod._reports()
    code, body = reports[0]["first"]
    assert code == 200 and len(body["results"][0]["ids"]) == 3
    code, body = reports[0]["failing"]
    assert code == 500
    for report in reports:
        assert report["ended"].startswith("the server ended with an error"), report["ended"]


def test_a_mesh_with_data_or_model_ranks_is_refused():
    mesh = make_mesh(index=1, devices=[DEVICE])
    for shape in ({"data": 2, "model": 1, "index": 1}, {"data": 1, "model": 2, "index": 2}):
        searcher = type("S", (), {"mesh": dataclasses.replace(mesh, shape=shape)})()
        with pytest.raises(ValueError, match="along index alone"):
            SearchServer(searcher)
