"""A pod of fusion_tpu_torch processes on the CPU, for the tests of the
multi-device tier (``parallel/``, ``serving_sharded.py``, sharded segments).

``start_pod(outdir, mode)`` launches ``NPROC`` copies of this file, one rank
each.  Each joins a ``gloo`` process group through the port's own bootstrap
(``parallel.multihost.initialize_multihost(..., backend="gloo",
device="cpu")``: a ``FileStore`` under ``outdir``, a TCP port on 127.0.0.1,
or torchrun's environment variables), runs ``mode`` on a mesh of ``NPROC``
index ranks, and writes what it found to ``outdir/<mode>_<rank>.pt``.  The
workers import torch and the port only, never JAX, so a pod starts in a few
seconds; the tests (which import JAX) write the inputs the workers need into
``outdir/payload.pt`` (weights converted from the JAX package's models, the
JAX-built ColBERT index, the corpora) and compare the workers' lists with the
JAX package's mesh programs in the parent.  The collectives need real
processes: one process cannot be two ranks of a group.

Modes:

  * ``serving`` — ``CONFIGS``: each built as a ``HybridSearcher`` and sharded
    by ``ShardedHybridSearcher.from_searcher``; ``search`` and
    ``search_systems`` of ``QUERIES`` (two batches of 4, the second padded);
  * ``segmented`` — ``SegmentedHybridSearcher(mesh=...)``: corpus A, the
    delta B, three deletes and compact against a sharded rebuild of the union
    (``tests/test_segmented.py``'s sharded cases), and the compressed ColBERT
    leg sharded against unsharded over the same two segments;
  * ``multihost`` — ``tests/multihost_worker.py``'s serving half: rows held
    per process searched by ``sharded_dense_search`` against the exact
    single-process search, the full four-leg searcher with the rerank
    against the single-device one, and each ``sharded_*`` function against
    its single-device search;
  * ``env`` — the bootstrap from torchrun's environment variables, then the
    ``multihost`` mode's dense search;
  * ``train`` — ``payload["parallel"]``'s cases: each train step on the
    pod's mesh (``data`` = 2, or ``data`` = 2 × ``model`` = 2 in a pod of 4)
    for 3 steps from the converted weights, its losses and its whole
    parameters after them; ``payload["alone"]``'s on one device (rank 0);
    and ``tests/multihost_worker.py``'s gradient half;
  * ``cli_train`` — the port's CLI commands of ``payload["cli"]``, each
    joining the group from torchrun's variables itself (``init='env'``);
  * ``server`` — ``SearchServer`` on both ranks, rank 0 listening on
    127.0.0.1: over the ``full`` configuration's sharded searcher,
    ``payload["requests"]`` from concurrent client threads in rank 0, a
    batch that raises on both ranks (a 500) and the next request; then over
    a ``SegmentedHybridSearcher(mesh=...)`` updated through
    ``SearchServer.update`` (add, three deletes, compact), searched over
    HTTP after each;
  * ``server_fail`` — a server whose rank 1 alone raises on a request, in a
    group with a short timeout: every rank's server ends with an error and
    its worker exits non-zero after writing its report.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

NPROC = 2
HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

TINY = dict(max_query_length=8, max_doc_length=16)
# build options of each serving configuration (tests/test_serving_sharded.py's),
# with the systems it takes; "sharded" are fields set on the sharded searcher
_FULL = dict(rerank_depth=4, batch_size=4, topk=8, int8_corpus=True, scale_mode=True, impact_cap=64,
             splade_prune_topk=512, splade_query_terms=512, colbert_compressed=True, colbert_nbits=4,
             colbert_plaid=True, plaid_nprobe=64, plaid_ncand=24, ivf_cap=64, rerank_packed=False)
_RERANK = dict(rerank_depth=4, batch_size=4, topk=8, int8_corpus=True)
_SPLADE_SCALE = dict(batch_size=4, topk=8, scale_mode=True, impact_cap=64, splade_prune_topk=512,
                     splade_query_terms=8)
CONFIGS = {
    "full": (("bm25", "dense", "splade", "colbert", "ce"), _FULL, {}),
    "bm25": (("bm25",), dict(topk=8, scale_mode=True, impact_cap=64), {}),
    "dense_fused": (("dense",), dict(batch_size=4, topk=8, int8_corpus=True), {"dense_impl": "fused"}),
    "matrix": (("dense", "splade"), dict(batch_size=4, topk=8, int8_corpus=True), {}),
    "scatter": (("splade",), dict(_SPLADE_SCALE, splade_impl="scatter", scatter_docs_per_chunk=2048), {}),
    "packed": (("dense", "ce"), dict(_RERANK, rerank_packed=True, rerank_row_width=64), {}),
    "flat": (("dense", "ce"), dict(_RERANK, rerank_packed=False), {}),
    "cascade": (("dense", "ce"), dict(_RERANK, rerank_cascade=(2, 8)), {}),
    "cascade_degenerate": (("dense", "ce"), dict(_RERANK, rerank_cascade=(4, 4096)), {}),
    "rescore_impact": (("splade",), dict(_SPLADE_SCALE, splade_impl="impact", splade_rescore_depth=24), {}),
    "rescore_scatter": (("splade",), dict(_SPLADE_SCALE, splade_impl="scatter", scatter_docs_per_chunk=2048,
                                          splade_rescore_depth=24), {}),
}
MODEL_ARGS = {"dense": "dense_model", "splade": "splade_model", "colbert": "colbert_model", "ce": "cross_encoder"}


SERVER_GROUP_TIMEOUT = 8.0  # seconds: server_fail's group, so a rank left in a collective raises soon


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Pod:
    """The running workers of one pod; ``results()`` waits for them."""

    def __init__(self, outdir, mode: str, procs, logs, timeout: float):
        self.outdir, self.mode, self.procs, self.logs = str(outdir), mode, procs, logs
        self.deadline = time.monotonic() + timeout
        self._results = None

    def results(self) -> list[dict]:
        """Each rank's report (raises with the workers' output if one failed
        or the pod outlived its timeout)."""
        if self._results is None:
            import torch

            for p in self.procs:
                try:
                    p.wait(timeout=max(self.deadline - time.monotonic(), 1))
                except subprocess.TimeoutExpired:
                    for q in self.procs:
                        q.kill()
                    raise AssertionError(f"pod {self.mode} timed out:\n{self._output()}") from None
            if any(p.returncode for p in self.procs):
                raise AssertionError(f"pod {self.mode} failed:\n{self._output()}")
            self._results = self._reports()
        return self._results

    def returncodes(self) -> list[int]:
        """Each rank's exit code (raises if the pod outlived its timeout)."""
        for p in self.procs:
            try:
                p.wait(timeout=max(self.deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                for q in self.procs:
                    q.kill()
                raise AssertionError(f"pod {self.mode} timed out:\n{self._output()}") from None
        return [p.returncode for p in self.procs]

    def _reports(self) -> list[dict]:
        import torch

        return [torch.load(os.path.join(self.outdir, f"{self.mode}_{r}.pt"), weights_only=False)
                for r in range(len(self.procs))]

    def _output(self) -> str:
        return "\n".join(f"--- rank {r}:\n{open(log).read()[-6000:]}" for r, log in enumerate(self.logs))


def start_pod(outdir, mode: str, init: str = "file", timeout: float = 240.0, nproc: int = NPROC) -> Pod:
    """Launch the ``nproc`` workers of ``mode`` (they run while the caller
    computes the JAX side).  ``init``: 'file' (a FileStore under ``outdir``),
    'tcp' (a free port on 127.0.0.1) or 'env' (torchrun's variables)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("JAX_PLATFORMS", None)
    spec = f"file://{outdir}/store" if init == "file" else f"127.0.0.1:{_free_port()}"
    procs, logs = [], []
    for rank in range(nproc):
        if init == "env":
            host, port = spec.split(":")
            env.update(MASTER_ADDR=host, MASTER_PORT=port, RANK=str(rank), WORLD_SIZE=str(nproc),
                       LOCAL_RANK=str(rank))
        log = os.path.join(str(outdir), f"{mode}_{rank}.log")
        logs.append(log)
        with open(log, "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), mode, str(rank), str(nproc), str(outdir),
                 "env" if init == "env" else spec],
                env=dict(env), stdout=out, stderr=subprocess.STDOUT,
            ))
    return Pod(outdir, mode, procs, logs, timeout)


# ----------------------------------------------------------------------
# the worker
# ----------------------------------------------------------------------
def _lists(ranked) -> dict:
    return {"ids": ranked.ids.numpy(), "scores": ranked.scores.numpy()}


def _models(payload):
    from fusion_tpu_torch.models.biencoder import BiEncoder
    from fusion_tpu_torch.models.colbert import ColBERT
    from fusion_tpu_torch.models.crossencoder import CrossEncoder
    from fusion_tpu_torch.models.encoder import EncoderConfig

    cfg = EncoderConfig.tiny(vocab_size=512)
    sd = payload["models"]
    return {
        "dense": BiEncoder(cfg, params=sd["dense"], head="dense", device="cpu", **TINY),
        "splade": BiEncoder(cfg, params=sd["splade"], head="splade", device="cpu", **TINY),
        "colbert": ColBERT(cfg, params=sd["colbert"], dim=16, device="cpu", **TINY),
        "ce": CrossEncoder(cfg, params=sd["ce"], max_length=32, device="cpu"),
    }


def _build(name, corpus, models, prep, colbert_arrays=None):
    from fusion_tpu_torch.models.convert import plaid_index_from_arrays
    from fusion_tpu_torch.serving import HybridSearcher

    systems, opts, _ = CONFIGS[name]
    kw = {MODEL_ARGS[s]: models[s] for s in systems if s != "bm25"}
    if "bm25" in systems:
        kw.update(bm25_docs=prep.preprocess(list(corpus.values())),
                  bm25_preprocess=lambda t: prep.preprocess(list(t)))
    searcher = HybridSearcher.build(corpus, **kw, **opts, device="cpu")
    if "colbert" in systems:
        # the JAX package's compressed index (the packages' k-means differ)
        searcher.colbert_index, searcher.colbert_ivf = plaid_index_from_arrays(**colbert_arrays, device="cpu")
    return searcher


def run_serving(mesh, payload) -> dict:
    from fusion_tpu_torch.data.preprocessor import TextPreprocessor
    from fusion_tpu_torch.serving_sharded import ShardedHybridSearcher

    models, prep = _models(payload), TextPreprocessor(spacy_model=None)
    queries, out = payload["queries"], {}
    for name, (_, _, fields) in CONFIGS.items():
        single = _build(name, payload["corpus"], models, prep, payload.get("colbert"))
        sharded = ShardedHybridSearcher.from_searcher(single, mesh)
        for field, value in fields.items():
            setattr(sharded, field, value)
        ranked, _ = sharded.search(queries, batch_size=4)
        out[name] = {
            "systems": sharded.active_systems,
            "search": _lists(ranked),
            "legs": {s: _lists(r) for s, r in sharded.search_systems(queries, batch_size=4).items()},
            "fused": _lists(_without_rerank(sharded, queries)),
        }
    return out


def _without_rerank(searcher, queries):
    depth, searcher.rerank_depth = searcher.rerank_depth, 0
    try:
        return searcher.search(queries, batch_size=4)[0]
    finally:
        searcher.rerank_depth = depth


def run_segmented(mesh, payload) -> dict:
    from fusion_tpu_torch.data.preprocessor import TextPreprocessor
    from fusion_tpu_torch.segmented import SegmentedHybridSearcher
    from fusion_tpu_torch.serving import HybridSearcher
    from fusion_tpu_torch.serving_sharded import ShardedHybridSearcher

    models, prep = _models(payload), TextPreprocessor(spacy_model=None)
    queries, out = payload["queries"], {}
    a, b = payload["seg_a"], payload["seg_b"]
    kwargs = dict(dense_model=models["dense"], splade_model=models["splade"], cross_encoder=models["ce"],
                  rerank_depth=4, batch_size=4, topk=8, bm25_preprocess=lambda t: prep.preprocess(list(t)),
                  int8_corpus=True, ce_max_doc_tokens=24, device="cpu")
    seg = SegmentedHybridSearcher(a, bm25_docs=prep.preprocess(list(a.values())), mesh=mesh, **kwargs)

    def step(**more):
        return {"search": _lists(seg.search(queries, batch_size=4)[0]), "legs": _segment_legs(seg, queries), **more}

    seg.add_documents(b, bm25_docs=prep.preprocess(list(b.values())))
    out["two_segments"] = step(n=len(seg.segments), systems=seg.active_systems)
    victims = sorted(b)[:3]
    seg.delete_documents(victims)
    out["tombstoned"] = step()
    seg.compact()
    out["compacted"] = step(n=len(seg.segments), tombstones=sorted(seg._tombstones))
    union = {k: v for k, v in {**a, **b}.items() if k not in set(victims)}
    full = ShardedHybridSearcher.from_searcher(
        HybridSearcher.build(union, bm25_docs=prep.preprocess(list(union.values())), **kwargs), mesh
    )
    out["rebuild"] = _lists(full.search(queries, batch_size=4)[0])
    out["victims"] = victims

    c, d = payload["seg_c"], payload["seg_d"]
    kw = dict(colbert_model=models["colbert"], colbert_compressed=True, colbert_plaid=True, plaid_nprobe=32,
              plaid_ncand=16, ivf_cap=16, batch_size=4, topk=8, device="cpu")
    plain = SegmentedHybridSearcher(c, **kw)
    plain.add_documents(d)
    sharded = SegmentedHybridSearcher(c, mesh=mesh, **kw)
    sharded.add_documents(d)
    out["colbert"] = {"systems": sharded.active_systems, "plain": _lists(plain.search(queries, batch_size=4)[0]),
                      "sharded": _lists(sharded.search(queries, batch_size=4)[0])}
    return out


def _segment_legs(seg, queries) -> dict:
    """Each system's list merged across the segments, tombstones stripped
    (what ``SegmentedHybridSearcher.search`` fuses)."""
    from fusion_tpu_torch import segmented

    per = {}
    for source in ([seg.bm25_searcher] if seg.bm25_searcher is not None else []) + seg.segments:
        for name, r in source.search_systems(queries, batch_size=4).items():
            per.setdefault(name, []).append(r)
    return {n: _lists(seg._strip_tombstones(segmented._merge_ranked(p, seg.topk))) for n, p in per.items()}


def _dense_micro(mesh, rank: int, world: int) -> dict:
    """multihost_worker.py's serving half: 128 rows, 32 per process... here
    64 per process of 2, searched index-parallel against the exact search."""
    import numpy as np
    import torch

    from fusion_tpu_torch.ops.mips import dense_search, sharded_dense_search

    n_total, h, q, k = 128, 16, 4, 10
    rng = np.random.default_rng(0)  # the same corpus on every process
    corpus = rng.normal(size=(n_total, h)).astype(np.float32)
    queries = torch.from_numpy(rng.normal(size=(q, h)).astype(np.float32))
    per = n_total // world
    local = torch.from_numpy(corpus[rank * per : (rank + 1) * per])
    got = sharded_dense_search(queries, local, mesh, k=k, similarity="dot", doc_block=per // 4)
    want = dense_search(queries, torch.from_numpy(corpus), k=k, similarity="dot")
    return {"search": _lists(got), "ids_match": bool(torch.equal(got.ids, want.ids)),
            "scores_close": bool(torch.allclose(got.scores, want.scores, atol=1e-5))}


def _standalone(mesh, rank: int, world: int) -> dict:
    """Each ``sharded_*`` function and its single-device search on the same
    inputs (seeded here), for the parent to compare."""
    import numpy as np
    import torch

    from fusion_tpu_torch.index import inverted, plaid
    from fusion_tpu_torch.index.compression import CompressedTokenIndex, compress_token_index, maxsim_search_compressed
    from fusion_tpu_torch.ops import maxsim, mips, scatter_score

    rng = np.random.default_rng(1)
    out = {}

    def same(name, got, want, exact=True):
        out[name] = {"got": _lists(got), "want": _lists(want), "exact": exact}

    v, n = 40, 64
    pairs = np.unique(rng.integers(0, v, 600) * n + rng.integers(0, n, 600))
    term, doc = pairs // n, pairs % n
    imp = rng.uniform(0.1, 3.0, size=term.size).astype(np.float32)
    idx = inverted.build_impact_index(term, doc, imp, vocab_size=v, n_docs=n, cap=64, device="cpu")
    qt = torch.from_numpy(rng.integers(0, v, size=(5, 6)).astype(np.int32))
    qw = torch.from_numpy(rng.uniform(0.5, 2.0, size=(5, 6)).astype(np.float32))
    same("impact", inverted.sharded_impact_search(qt, qw, inverted.shard_impact_index(idx, world), mesh, k=8),
         inverted.impact_search(qt, qw, idx, k=8))

    n_docs = 20_000
    doc = np.repeat(np.arange(n_docs), 4)
    pairs = np.unique(rng.integers(0, 200, doc.size) * n_docs + doc)
    term, doc = pairs // n_docs, pairs % n_docs
    imp = rng.uniform(0.1, 2.0, size=term.size).astype(np.float32)
    cidx = inverted.build_chunked_impact_index(term, doc, imp, vocab_size=200, n_docs=n_docs, docs_per_chunk=2048,
                                               cap_per_chunk=64, device="cpu")
    qt = torch.from_numpy(rng.integers(0, 200, size=(4, 8)).astype(np.int32))
    qw = torch.from_numpy(rng.uniform(0.2, 1.5, size=(4, 8)).astype(np.float32))
    got = scatter_score.sharded_scatter_search(qt, qw, scatter_score.shard_chunked_impact_index(cidx, world), mesh,
                                               k=50)
    want = scatter_score.scatter_impact_search(qt, qw, cidx, k=50)
    same("scatter", got, want)

    n, ld, d = 64, 5, 16
    q = torch.from_numpy(rng.normal(size=(3, 4, d)).astype(np.float32))
    qm = torch.ones((3, 4))
    ct = torch.from_numpy(rng.normal(size=(n, ld, d)).astype(np.float32))
    cm = torch.ones((n, ld))
    cm[9] = 0
    per = n // world
    rows = slice(rank * per, (rank + 1) * per)
    same("maxsim", mips.sharded_maxsim_search(q, qm, ct[rows], cm[rows], mesh, k=6),
         maxsim.maxsim_search(q, qm, ct, cm, k=6), exact=False)
    c_tm, valid = maxsim.prepare_token_corpus(ct, cm)
    same("maxsim_tm", mips.sharded_maxsim_search_tm(q, qm, c_tm[:, rows], valid[rows], mesh, k=6),
         maxsim.maxsim_search_tm(q, qm, c_tm, valid, k=6), exact=False)

    ct = ct / ct.norm(dim=-1, keepdim=True)
    index = compress_token_index(ct, cm, num_centroids=32, nbits=2, seed=0)
    shard = CompressedTokenIndex(index.centroids, index.centroid_ids[rows], index.codes[rows], index.mask[rows],
                                 index.bucket_weights, index.nbits)
    same("compressed", mips.sharded_maxsim_search_compressed(q, qm, shard, mesh, k=6),
         maxsim_search_compressed(q, qm, index, k=6), exact=False)
    ivf = plaid.build_ivf(index.centroid_ids, index.mask, 32, cap=n)
    got = plaid.sharded_plaid_search(q, qm, plaid.shard_plaid_index(index, world, ivf_cap=n), mesh, k=6, nprobe=32,
                                     ncand=n, cand_chunk=per)
    want = plaid.plaid_search(q, qm, index, ivf, k=6, nprobe=32, ncand=n, cand_chunk=per)
    same("plaid", got, want, exact=False)
    return out


def run_multihost(mesh, payload, rank: int, world: int) -> dict:
    import numpy as np

    from fusion_tpu_torch.data.preprocessor import TextPreprocessor
    from fusion_tpu_torch.models.biencoder import BiEncoder
    from fusion_tpu_torch.models.colbert import ColBERT
    from fusion_tpu_torch.models.crossencoder import CrossEncoder
    from fusion_tpu_torch.models.encoder import EncoderConfig
    from fusion_tpu_torch.parallel.multihost import is_primary_host
    from fusion_tpu_torch.serving import HybridSearcher
    from fusion_tpu_torch.serving_sharded import ShardedHybridSearcher

    out = {"is_primary": is_primary_host(), "micro": _dense_micro(mesh, rank, world),
           "standalone": _standalone(mesh, rank, world)}
    # the hybrid mode: identical corpus and seeded models on every process
    corpus, queries = payload["corpus"], payload["queries"]
    cfg = EncoderConfig.tiny(vocab_size=512)
    prep = TextPreprocessor(spacy_model=None)
    searcher = HybridSearcher.build(
        corpus, bm25_docs=prep.preprocess(list(corpus.values())),
        dense_model=BiEncoder(cfg, head="dense", seed=1, device="cpu", **TINY),
        splade_model=BiEncoder(cfg, head="splade", seed=2, device="cpu", **TINY),
        colbert_model=ColBERT(cfg, dim=16, seed=3, device="cpu", **TINY),
        cross_encoder=CrossEncoder(cfg, max_length=32, seed=4, device="cpu"),
        bm25_preprocess=lambda t: prep.preprocess(list(t)), **dict(_FULL, rerank_packed=None), device="cpu",
    )
    single, _ = searcher.search(queries, batch_size=4)
    sharded = ShardedHybridSearcher.from_searcher(searcher, mesh)
    multi, _ = sharded.search(queries, batch_size=4)
    s_ids, m_ids = single.ids.numpy(), multi.ids.numpy()
    out["hybrid"] = {
        "systems": sharded.active_systems,
        "packed": sharded.rerank_packed,
        "top1_match": bool(np.array_equal(m_ids[:, 0], s_ids[:, 0])),
        "sets_match": all(set(m_ids[i]) == set(s_ids[i]) for i in range(len(queries))),
    }
    return out


def _post(url: str, payload: dict) -> tuple[int, dict]:
    import json
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url: str) -> dict:
    import json
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def _raising(searcher, rank: int) -> None:
    """``searcher.search`` raises on a batch holding "RAISE" (every rank) or
    "RAISE<rank>" (this rank alone), before any collective."""
    search = searcher.search

    def wrapped(queries, batch_size=32, **kw):
        if "RAISE" in queries or f"RAISE{rank}" in queries:
            raise ValueError(f"a bad batch on rank {rank}")
        return search(queries, batch_size=batch_size, **kw)

    searcher.search = wrapped


def _serve_requests(srv, requests: list[dict]) -> list[tuple[int, dict]]:
    """``requests`` POSTed to ``srv`` at once, one client thread each."""
    from concurrent.futures import ThreadPoolExecutor

    host, port = srv.address
    with ThreadPoolExecutor(len(requests)) as pool:
        return list(pool.map(lambda r: _post(f"http://{host}:{port}/search", r), requests))


SERVER_KW = dict(host="127.0.0.1", port=0, max_batch=4, max_wait_ms=20.0)


def run_server(mesh, payload, rank: int) -> dict:
    """The ``server`` mode (see the module's note); rank 0 reports what the
    clients got, every rank its searcher's own lists."""
    from fusion_tpu_torch.data.preprocessor import TextPreprocessor
    from fusion_tpu_torch.segmented import SegmentedHybridSearcher
    from fusion_tpu_torch.server import SearchServer
    from fusion_tpu_torch.serving_sharded import ShardedHybridSearcher

    models, prep = _models(payload), TextPreprocessor(spacy_model=None)
    queries, out = payload["queries"], {}
    sharded = ShardedHybridSearcher.from_searcher(_build("full", payload["corpus"], models, prep, payload["colbert"]),
                                                  mesh)
    out["direct"] = _lists(sharded.search(queries, batch_size=4)[0])
    _raising(sharded, rank)
    srv = SearchServer(sharded, **SERVER_KW)
    srv.start()
    if srv.leader:
        host, port = srv.address
        url = f"http://{host}:{port}"
        out["answers"] = _serve_requests(srv, payload["requests"])
        out["healthz"], out["stats"] = _get(f"{url}/healthz"), _get(f"{url}/stats")
        out["bad_batch"] = _post(f"{url}/search", {"queries": ["RAISE"], "topk": 3})
        out["after_bad_batch"] = _post(f"{url}/search", {"queries": [queries[0]], "topk": 8})
    srv.stop()

    a, b = payload["seg_a"], payload["seg_b"]
    kwargs = dict(dense_model=models["dense"], splade_model=models["splade"], cross_encoder=models["ce"],
                  rerank_depth=4, batch_size=4, topk=8, bm25_preprocess=lambda t: prep.preprocess(list(t)),
                  int8_corpus=True, ce_max_doc_tokens=24, device="cpu")
    seg = SegmentedHybridSearcher(a, bm25_docs=prep.preprocess(list(a.values())), mesh=mesh, **kwargs)
    srv = SearchServer(seg, **SERVER_KW)
    srv.start()
    if srv.leader:
        host, port = srv.address
        url = f"http://{host}:{port}"

        def step(**more):
            answers = _serve_requests(srv, [{"queries": [q], "topk": 8} for q in queries])
            return {"answers": answers, "corpus_docs": _get(f"{url}/healthz")["corpus_docs"], **more}

        out["segmented"] = {"one_segment": step()}
        srv.update("add_documents", b, bm25_docs=prep.preprocess(list(b.values())))
        out["segmented"]["two_segments"] = step(n=len(seg.segments))
        victims = sorted(b)[:3]
        srv.update("delete_documents", victims)
        out["segmented"]["tombstoned"] = step()
        srv.update("compact")
        out["segmented"]["compacted"] = step(n=len(seg.segments))
        try:
            srv.update("add_documents", {victims[0] + 10_000: "chat"}, bm25_docs=None)
        except ValueError as e:  # raised by the searcher on every rank: the server serves on
            out["segmented"]["refused_update"] = str(e)
        out["segmented"]["after_refused_update"] = step()
    srv.stop()
    out["segments_after"] = len(seg.segments)
    return out


def run_server_fail(mesh, payload, rank: int, outdir: str) -> None:
    """The ``server_fail`` mode: rank 1 alone raises on a request; each
    rank writes its report (what the client got, how its server ended) and
    exits non-zero."""
    import torch

    from fusion_tpu_torch.data.preprocessor import TextPreprocessor
    from fusion_tpu_torch.server import SearchServer
    from fusion_tpu_torch.serving_sharded import ShardedHybridSearcher

    models, prep = _models(payload), TextPreprocessor(spacy_model=None)
    sharded = ShardedHybridSearcher.from_searcher(_build("bm25", payload["corpus"], models, prep), mesh)
    _raising(sharded, rank)
    srv = SearchServer(sharded, **SERVER_KW)
    srv.start()
    out = {}
    if srv.leader:
        host, port = srv.address
        out["first"] = _post(f"http://{host}:{port}/search", {"queries": [payload["queries"][0]], "topk": 3})
        out["failing"] = _post(f"http://{host}:{port}/search", {"queries": ["RAISE1"], "topk": 3})
    t0 = time.monotonic()
    try:
        srv.stop()
        out["ended"] = "cleanly"
    except RuntimeError as e:
        out["ended"] = f"{e} (from {e.__cause__!r})"
    out["stop_s"] = time.monotonic() - t0
    torch.save(out, os.path.join(outdir, f"server_fail_{rank}.pt"))
    raise SystemExit(f"rank {rank}: the server ended: {out['ended']}")


def _train_model(case: dict):
    import torch

    from fusion_tpu_torch.models.biencoder import BiEncoder
    from fusion_tpu_torch.models.colbert import ColBERT
    from fusion_tpu_torch.models.crossencoder import CrossEncoder
    from fusion_tpu_torch.models.encoder import EncoderConfig
    from fusion_tpu_torch.models.t5 import T5Config, T5CrossEncoder
    from fusion_tpu_torch.models.xmod import XmodConfig

    kw = dict(params=case["state_dict"], device="cpu", param_dtype=torch.float32)
    trunk = case.get("trunk", "bert")
    if trunk == "xmod":  # the SPLADE bi-encoder through its second adapter
        return BiEncoder(XmodConfig.tiny(**case["cfg"]), head=case["head"], **kw).set_language("en_XX")
    if trunk == "t5":
        return T5CrossEncoder(T5Config.tiny(**case["cfg"]), max_length=20, **kw)
    cfg = EncoderConfig.tiny(**case["cfg"])
    if case["kind"] == "colbert":
        return ColBERT(cfg, dim=16, **kw)
    if case["kind"] == "crossencoder":
        return CrossEncoder(cfg, max_length=20, **kw)
    return BiEncoder(cfg, head=case["head"], **kw)


def train_steps(case: dict, mesh) -> dict:
    """Three steps of ``case``'s train step on ``mesh`` (None: one device)
    from its converted weights: the losses and the whole parameters as a
    Flax tree."""
    from fusion_tpu_torch.parallel.sharding import COLLECTIVES
    from fusion_tpu_torch.train import trainer as tt

    model = _train_model(case)
    state, tx, _ = tt.init_train_state(model, tt.FitConfig(**case["fit"]))
    if case["kind"] == "colbert":
        step = tt.make_colbert_train_step(model, tx, "ce", mesh=mesh)
    elif case["kind"] == "crossencoder":
        step = tt.make_crossencoder_train_step(model, tx, mesh=mesh)
    else:
        step = tt.make_biencoder_train_step(model, tx, case["rank"], case["reg"], 10, mesh=mesh)
    if mesh is not None:
        state = step.place_state(state)
    batch = tt._to_device(case["batch"], model.device)
    calls0, losses = COLLECTIVES["calls"], []
    for _ in range(3):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    with tt.whole_parameters(model, mesh):
        tree = model.flax_tree(model.module.state_dict())
    return {"losses": losses, "params": tree, "collectives_per_step": (COLLECTIVES["calls"] - calls0) / 3}


def gradient_half(mesh) -> dict:
    """``tests/multihost_worker.py``'s gradient half: the gradient of
    ``mean((x @ w) ** 2)`` over the rows of every ``data`` rank, against the
    gradient of the full batch computed here alone."""
    import numpy as np
    import torch

    from fusion_tpu_torch.parallel.sharding import DATA_AXIS, all_gather_cat, all_reduce_flat

    rng = np.random.default_rng(0)  # the same arrays on every process
    x = torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32))
    w0 = rng.normal(size=(4, 3)).astype(np.float32)
    rows, coord = mesh.shape[DATA_AXIS], mesh.coords[DATA_AXIS]
    per = x.shape[0] // rows
    w = torch.tensor(w0, requires_grad=True)
    (all_gather_cat(x[coord * per : (coord + 1) * per] @ w, mesh) ** 2).mean().backward()
    all_reduce_flat([w.grad], mesh)
    full = torch.tensor(w0, requires_grad=True)
    ((x @ full) ** 2).mean().backward()
    return {"sharded": w.grad.numpy(), "full": full.grad.numpy()}


def run_train(mesh, payload, rank: int) -> dict:
    """``payload["parallel"]``'s cases on the mesh; on rank 0 also
    ``payload["alone"]``'s on one device (the parent compares the two)."""
    cases = payload["cases"]
    out = {"cases": {name: train_steps(cases[name], mesh) for name in payload["parallel"]},
           "gradient_half": gradient_half(mesh)}
    if rank == 0:
        out["alone"] = {name: train_steps(cases[name], None) for name in payload["alone"]}
    return out


def run_cli_train(payload, rank: int) -> dict:
    """Each command line of ``payload["cli"]``; where ``payload["init"]``
    names a checkpoint for it, the command trains that checkpoint (the JAX
    CLI's starting weights: the two packages' seeds give different ones) in
    place of the model it builds from its seed."""
    import torch

    from fusion_tpu_torch.cli import main as cli
    from fusion_tpu_torch.models.biencoder import BiEncoder

    make = cli._make_biencoder
    for i, argv in enumerate(payload["cli"]):
        init = payload.get("init", {}).get(i)

        def make_from_init(args, head, train, init=init):
            model, preset = make(args, head, train)
            if init is not None:
                model = BiEncoder.load(init, device=args.device, dtype=model.cfg.dtype, param_dtype=torch.float32)
            return model, preset

        cli._make_biencoder = make_from_init
        try:
            cli.main(argv)
        finally:
            cli._make_biencoder = make
    return {}


def main() -> None:
    mode, rank, world, outdir, init = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
    import torch

    torch.set_num_threads(2)
    sys.path.insert(0, REPO)
    from fusion_tpu_torch.parallel.multihost import initialize_multihost, pod_mesh

    if mode == "cli_train":  # the CLI joins the group from torchrun's variables itself
        payload = torch.load(os.path.join(outdir, "payload.pt"), weights_only=False)
        run_cli_train(payload, rank)
        torch.save({}, os.path.join(outdir, f"{mode}_{rank}.pt"))
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
        return
    timeout = SERVER_GROUP_TIMEOUT if mode == "server_fail" else None
    if init == "env":
        initialize_multihost(backend="gloo", device="cpu")
    else:
        initialize_multihost(init, world, rank, backend="gloo", device="cpu", timeout=timeout)
        # a second call is a no-op, not a crash
        initialize_multihost(init, world, rank, backend="gloo", device="cpu")
    payload = torch.load(os.path.join(outdir, "payload.pt"), weights_only=False)
    mesh = pod_mesh(model=world // 2) if mode == "train" else pod_mesh(index=world)
    if mode == "server_fail":  # exits non-zero, without the group's teardown
        run_server_fail(mesh, payload, rank, outdir)
    if mode == "train":
        out = run_train(mesh, payload, rank)
    elif mode == "serving":
        out = run_serving(mesh, payload)
    elif mode == "segmented":
        out = run_segmented(mesh, payload)
    elif mode == "multihost":
        out = run_multihost(mesh, payload, rank, world)
    elif mode == "server":
        out = run_server(mesh, payload, rank)
    else:
        out = {"micro": _dense_micro(mesh, rank, world)}
    out["mesh"] = {"shape": mesh.shape, "coords": mesh.coords, "backend": mesh.backend}
    torch.save(out, os.path.join(outdir, f"{mode}_{rank}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
