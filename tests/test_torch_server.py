"""The port's HTTP front end (fusion_tpu_torch/server.py) over a tiny CPU
HybridSearcher: the six cases of tests/test_server.py (search over HTTP
equals the direct searcher call, concurrent requests coalesce into shared
batches, per-request topk, malformed input gets a 400, the counters,
duplicate queries share one row), plus 32 clients at once, the warm-up
that raises instead of starting a server that cannot search, and the queue
wait of a request held behind the batch in flight.  Scores over
HTTP are rounded to 6 decimals, so they match the direct call at 1e-5.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from torch_parity import DEVICE

from fusion_tpu_torch.core.ranked import RankedLists
from fusion_tpu_torch.data.preprocessor import TextPreprocessor
from fusion_tpu_torch.serving import HybridSearcher
from fusion_tpu_torch.server import SearchServer

WORDS = (
    "chat chien tribunal jugement contrat travail loi consommateur voiture "
    "route oiseau foret tapis salon jardin souris fromage pain livre page"
).split()


def _post(url: str, payload: dict) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def server():
    rng = np.random.default_rng(7)
    corpus = {
        1000 + i: " ".join(rng.choice(WORDS, size=5, replace=False))
        for i in range(20)
    }
    prep = TextPreprocessor(spacy_model=None)
    searcher = HybridSearcher.build(
        corpus,
        bm25_docs=prep.preprocess(list(corpus.values())),
        topk=8,
        bm25_preprocess=lambda t: prep.preprocess(list(t)),
        device=DEVICE,
    )
    srv = SearchServer(searcher, port=0, max_batch=8, max_wait_ms=30.0)
    srv.start()
    host, port = srv.address
    yield srv, searcher, f"http://{host}:{port}"
    srv.stop()


def test_healthz_and_search_match_direct(server):
    srv, searcher, base = server
    health = _get(f"{base}/healthz")
    assert health["ok"] and health["systems"] == ["bm25"]
    assert health["corpus_docs"] == 20

    queries = ["chat tapis", "tribunal jugement"]
    out = _post(f"{base}/search", {"queries": queries, "topk": 5})
    direct, _ = searcher.search(queries, batch_size=8)
    d_ids = direct.ids.numpy()
    d_scores = direct.scores.numpy()
    assert len(out["results"]) == 2
    for qi, res in enumerate(out["results"]):
        kr = len(res["ids"])
        assert 0 < kr <= 5
        assert res["ids"] == d_ids[qi][:kr].tolist()
        np.testing.assert_allclose(res["scores"], d_scores[qi][:kr], atol=1e-5)
        # descending, finite
        assert all(np.isfinite(res["scores"]))
        assert sorted(res["scores"], reverse=True) == res["scores"]


def test_concurrent_requests_coalesce(server):
    srv, _, base = server
    with srv._stats_lock:
        batches_before = srv.stats["batches"]
    results: dict[int, dict] = {}

    def worker(i):
        results[i] = _post(
            f"{base}/search", {"queries": [f"chat tapis {i}"], "topk": 3}
        )

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(results) == 6
    for out in results.values():
        assert len(out["results"]) == 1
    with srv._stats_lock:
        batches = srv.stats["batches"] - batches_before
    # six 1-query requests in flight together must share device batches
    # (max_batch=8, 30 ms coalesce window): strictly fewer batches than
    # requests proves the batching path; usually it is 1-2
    assert 1 <= batches < 6


def test_bad_requests_rejected(server):
    _, _, base = server
    for payload in ({}, {"queries": []}, {"queries": [1, 2]}):
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(f"{base}/search", payload)
        assert exc.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(f"{base}/nope")
    assert exc.value.code == 404


def test_stats_counters(server):
    srv, _, base = server
    stats = _get(f"{base}/stats")
    assert stats["requests"] >= 7  # the served (non-rejected) requests above
    assert stats["batches"] >= 1
    assert stats["queries"] >= stats["requests"]
    assert stats["mean_batch_ms"] > 0
    # every served request rode a batch, and waited for it in the queue
    assert stats["dispatched"] == stats["requests"]
    assert stats["queue_wait_ms_total"] > 0


def test_malformed_bodies_get_400_not_dropped_connection(server):
    """Non-dict JSON and non-coercible/invalid topk must produce an HTTP
    400, never a handler crash that drops the connection."""
    _, _, base = server
    for payload in ([1, 2, 3], {"queries": ["q"], "topk": None},
                    {"queries": ["q"], "topk": -3},
                    {"queries": ["q"], "topk": 0}):
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(f"{base}/search", payload)
        assert exc.value.code == 400, payload


def test_duplicate_queries_share_one_device_row(server):
    """Identical query strings coalesced into one batch are scored once and
    fanned back out — results must match the non-duplicated request."""
    srv, _, base = server
    single = _post(f"{base}/search", {"queries": ["chat tapis"], "topk": 3})
    dup = _post(
        f"{base}/search",
        {"queries": ["chat tapis", "tribunal", "chat tapis"], "topk": 3},
    )
    assert dup["results"][0] == dup["results"][2] == single["results"][0]
    assert dup["results"][1] != dup["results"][0]


def test_many_clients_at_once(server):
    """32 clients at once: every request is answered (the listen backlog
    holds them all) with the direct search's lists, in fewer batches."""
    srv, searcher, base = server
    queries = [f"{a} {b}" for a, b in zip(WORDS, WORDS[3:] + WORDS[:3])][:32]
    direct, _ = searcher.search(queries, batch_size=8)
    with srv._stats_lock:
        before = (srv.stats["requests"], srv.stats["batches"])
    results: dict[int, dict] = {}

    def worker(i):
        results[i] = _post(f"{base}/search", {"queries": [queries[i]], "topk": 3})

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(queries))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(results) == list(range(len(queries)))
    for i, out in results.items():
        res = out["results"][0]
        assert res["ids"] == direct.ids.numpy()[i][: len(res["ids"])].tolist()
    with srv._stats_lock:
        requests = srv.stats["requests"] - before[0]
        batches = srv.stats["batches"] - before[1]
    assert requests == len(queries) and 1 <= batches < requests


class _Broken:
    """A searcher whose every search fails, as one whose kernel does not
    build would."""

    corpus_ids = np.arange(3)
    active_systems = ["bm25"]

    def search(self, queries, batch_size=32):
        raise RuntimeError("kernel failed to build")


def test_failed_warmup_raises_instead_of_serving():
    srv = SearchServer(_Broken(), port=0, max_batch=4)
    with pytest.raises(RuntimeError, match="kernel failed to build"):
        srv.start()
    # the socket is closed and no dispatcher runs
    assert srv._http.socket.fileno() == -1 and not srv._dispatcher.is_alive()


class _HeldSearcher:
    """A searcher whose every search call waits until the test releases it."""

    active_systems = ["stub"]
    corpus_ids = np.arange(4)

    def __init__(self):
        self.entered, self.release = threading.Event(), threading.Event()

    def search(self, queries, batch_size=32):
        self.entered.set()
        assert self.release.wait(timeout=60)
        n = len(queries)
        return RankedLists(torch.zeros(n, 2, dtype=torch.int32), torch.ones(n, 2)), 0.0


def test_queue_wait_counts_the_time_behind_the_batch_in_flight():
    """Request B arrives while request A's batch runs and waits for it: the
    server's queue wait sums B's wait (at least the time the test held A's
    batch after B was queued) and A's (none to speak of)."""
    hold = 0.3
    stub = _HeldSearcher()
    srv = SearchServer(stub, port=0, max_batch=1, max_wait_ms=0.0)
    srv.start(warmup=False)
    host, port = srv.address
    base = f"http://{host}:{port}"
    try:
        replies = {}
        clients = [threading.Thread(target=lambda name=name: replies.update({name: _post(
            f"{base}/search", {"queries": [name], "topk": 2})})) for name in ("a", "b")]
        clients[0].start()
        assert stub.entered.wait(timeout=60)
        clients[1].start()
        for _ in range(6000):  # B is queued behind A's batch
            if srv._queue.qsize():
                break
            time.sleep(0.001)
        assert srv._queue.qsize() == 1
        time.sleep(hold)
        stub.release.set()
        for c in clients:
            c.join(timeout=60)
            assert not c.is_alive()
        assert set(replies) == {"a", "b"}
        stats = _get(f"{base}/stats")
    finally:
        stub.release.set()
        srv.stop()
    assert stats["dispatched"] == stats["requests"] == stats["batches"] == 2
    assert hold * 1000 <= stats["queue_wait_ms_total"] < hold * 1000 + 5000
