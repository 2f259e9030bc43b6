"""The port's multi-process bootstrap (``parallel/multihost.py``) in real
processes: ``tests/multihost_worker.py``'s serving half on a pod of two port
processes joined over gloo on 127.0.0.1 (``tests/torch_pod.py``).

One pod joins by ``initialize_multihost("127.0.0.1:PORT", 2, rank,
backend="gloo", device="cpu")``, twice (the second call a no-op), the other
from torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` /
``WORLD_SIZE`` / ``LOCAL_RANK`` with no arguments.  Checked, as the JAX
worker checks them: ``pod_mesh(index=2)``'s coordinates, ``is_primary_host``
on rank 0 only, rows held per process searched by ``sharded_dense_search``
equal to the exact search over all rows (ids equal, scores within 1e-5; and
to the JAX package's ``dense_search`` on the same inputs), and the full
four-leg ``ShardedHybridSearcher`` with the (packed) rerank against the
single-device searcher: the same top 1 and the same ids per query.  Besides,
each ``sharded_*`` function of the index forms against its single-device
search on the same rank's inputs (impact and scatter bit-equal; the MaxSim
forms and PLAID within 1e-5; ids equal but inside runs of tied scores).  JAX's gradient half (data-parallel training)
runs in ``tests/test_torch_train_parallel.py``'s pods.  In process (F5): with no ``device`` the bootstrap takes the
card ``cuda:{LOCAL_RANK}`` under either backend and raises without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from torch_pod import NPROC, start_pod
from torch_parity import assert_ranked_match

from fusion_tpu.ops.mips import dense_search

WORDS = (
    "chat chien tribunal jugement contrat travail loi consommateur voiture route oiseau foret tapis salon "
    "jardin souris fromage pain livre page juge avocat peine article code civil penal commerce"
).split()


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    import torch

    rng = np.random.default_rng(3)
    corpus = {100 + i: " ".join(rng.choice(WORDS, size=6, replace=False)) for i in range(24)}
    queries = ["chat tapis salon", "tribunal jugement peine", "contrat travail code"]
    out = {}
    for mode, init in (("multihost", "tcp"), ("env", "env")):
        d = tmp_path_factory.mktemp(mode)
        torch.save({"corpus": corpus, "queries": queries}, d / "payload.pt")
        out[mode] = start_pod(d, mode, init=init, timeout=240)
    return {mode: pod.results() for mode, pod in out.items()}


def test_mesh_and_primary(pods):
    for mode in ("multihost", "env"):
        for rank, report in enumerate(pods[mode]):
            assert report["mesh"]["shape"] == {"data": 1, "model": 1, "index": NPROC}
            assert report["mesh"]["coords"]["index"] == rank and report["mesh"]["backend"] == "gloo"
    assert [r["is_primary"] for r in pods["multihost"]] == [True, False]


@pytest.mark.parametrize("mode", ["multihost", "env"])
def test_rows_per_process_search_equals_the_exact_search(pods, mode):
    rng = np.random.default_rng(0)
    corpus = rng.normal(size=(128, 16)).astype(np.float32)
    queries = rng.normal(size=(4, 16)).astype(np.float32)
    want = dense_search(jnp.asarray(queries), jnp.asarray(corpus), k=10, similarity="dot")
    for report in pods[mode]:
        micro = report["micro"]
        assert micro["ids_match"] and micro["scores_close"]
        assert_ranked_match(micro["search"]["ids"], micro["search"]["scores"], want.ids, want.scores, atol=1e-5)
    a, b = (r["micro"]["search"] for r in pods[mode])
    np.testing.assert_array_equal(a["ids"], b["ids"])
    np.testing.assert_array_equal(a["scores"], b["scores"])


def test_sharded_hybrid_matches_single_device(pods):
    for report in pods["multihost"]:
        hybrid = report["hybrid"]
        assert hybrid["systems"] == ["bm25", "dpr", "splade", "colbert", "monobert"] and hybrid["packed"]
        assert hybrid["top1_match"] and hybrid["sets_match"]


@pytest.mark.parametrize("name", ["impact", "scatter", "maxsim", "maxsim_tm", "compressed", "plaid"])
def test_sharded_functions_match_their_single_device_search(pods, name):
    """Exact forms bit-equal, the f32 MaxSim forms within 1e-5; ids equal
    but inside runs of equal scores (the binned scatter merges on scores
    whose in-bin offset bits are cleared, so such a run keeps the lower
    shard first, as JAX's merge does)."""
    for report in pods["multihost"]:
        r = report["standalone"][name]
        assert_ranked_match(r["got"]["ids"], r["got"]["scores"], r["want"]["ids"], r["want"]["scores"],
                            atol=0.0 if r["exact"] else 1e-5, cut_ties=True)
        assert (r["got"]["ids"] >= 0).all()


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_initialize_multihost_defaults_to_the_card(monkeypatch, backend):
    """F5: with no ``device`` the rank's device is ``cuda:{LOCAL_RANK}``
    under either backend, and without a card the bare call raises through
    ``core.device.resolve_device`` before it joins any group; the CPU is
    only ever asked for (``device="cpu"``, as the pods pass it)."""
    import torch

    from fusion_tpu_torch.core import device as core_device
    from fusion_tpu_torch.parallel import multihost

    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    joined = []
    monkeypatch.setattr(multihost.dist, "init_process_group", lambda *a, **kw: joined.append(kw))
    asked = []

    def resolve(device):
        asked.append(str(device))
        return core_device.resolve_device(device)

    monkeypatch.setattr(multihost, "resolve_device", resolve)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize_multihost(backend=backend)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize_multihost("127.0.0.1:1", 2, 1, backend=backend)
    assert asked == ["cuda:1", "cuda:1"] and joined == []
    assert multihost.resolve_device("cpu") == torch.device("cpu")
