"""HTTP serving front-end with dynamic batching.

Wraps a built (or reloaded) ``HybridSearcher``, or a
``SegmentedHybridSearcher`` that takes updates while it serves, in a small
dependency-free HTTP server:

  * POST /search   {"queries": ["..."], "topk": 10}  →
                   {"results": [{"ids": [...], "scores": [...]}, ...],
                    "batch_ms": ...}
  * GET  /healthz  → {"ok": true, "systems": [...], "corpus_docs": N}
                   (a segmented searcher's live ``n_docs``)
  * GET  /stats    → request/batch/query counters and latency aggregates

One process owns the card:

  * every HTTP handler thread only enqueues its queries and waits;
  * one dispatcher thread owns the searcher.  It drains the queue, coalesces
    up to ``max_batch`` queries across requests (waiting at most
    ``max_wait_ms`` after the first arrival), de-duplicates identical query
    strings, pads the batch to a multiple of ``max_batch``, runs one
    ``searcher.search`` call, and fans the results back out.  Concurrent
    small requests therefore share one batch on the device.

``start()`` warms the searcher with one padded batch first, and raises if
that fails: a kernel that does not build or launch stops the server instead
of surfacing as a 500 on the first request.

A sharded searcher (``ShardedHybridSearcher``, or a segmented one built with
``mesh=``) is served on a mesh of one rank.  Over more ranks it raises: only
rank 0 would see the requests, and the other ranks would wait in their
collectives forever (a multi-rank server is ROADMAP.md Queue 1, item 19).
"""

from __future__ import annotations

import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

__all__ = ["SearchServer", "serve_forever"]


class _HTTPServer(ThreadingHTTPServer):
    # the socket's listen backlog: http.server's default of 5 resets
    # connections once more than 5 clients connect at once
    request_queue_size = 128


@dataclass
class _Pending:
    queries: list[str]
    topk: int
    event: threading.Event = field(default_factory=threading.Event)
    ids: list[list[int]] | None = None
    scores: list[list[float]] | None = None
    error: str | None = None
    batch_ms: float = 0.0


class SearchServer:
    """Dynamic-batching HTTP wrapper around a built searcher."""

    def __init__(
        self,
        searcher,
        host: str = "127.0.0.1",
        port: int = 8080,
        max_batch: int = 32,
        max_wait_ms: float = 5.0,
        default_topk: int = 10,
    ) -> None:
        mesh = getattr(searcher, "mesh", None)
        if mesh is not None and mesh.size > 1:
            raise NotImplementedError(
                f"SearchServer over a mesh of {mesh.size} ranks: a server that feeds every rank the same "
                "batches is not ported to fusion_tpu_torch yet (ROADMAP.md Queue 1, item 19)"
            )
        self.searcher = searcher
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.default_topk = default_topk
        self._queue: queue.Queue[_Pending | None] = queue.Queue()
        self._stats_lock = threading.Lock()
        self.stats = {
            "requests": 0,
            "queries": 0,
            "batches": 0,
            "errors": 0,
            "batch_ms_total": 0.0,
        }
        self._dispatcher = threading.Thread(target=self._dispatch_loop, daemon=True)
        server = self

        class Handler(BaseHTTPRequestHandler):
            # silence per-request stderr logging
            def log_message(self, fmt, *args):  # noqa: N802
                pass

            def _reply(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                if self.path == "/healthz":
                    s = server.searcher
                    n = getattr(s, "n_docs", None)  # SegmentedHybridSearcher
                    if n is None:
                        n = int(np.asarray(s.corpus_ids).shape[0])
                    self._reply(
                        200,
                        {
                            "ok": True,
                            "systems": s.active_systems,
                            "corpus_docs": int(n),
                        },
                    )
                elif self.path == "/stats":
                    with server._stats_lock:
                        s = dict(server.stats)
                    s["mean_batch_ms"] = (
                        s["batch_ms_total"] / s["batches"] if s["batches"] else 0.0
                    )
                    self._reply(200, s)
                else:
                    self._reply(404, {"error": "unknown path"})

            def do_POST(self):  # noqa: N802
                if self.path != "/search":
                    self._reply(404, {"error": "unknown path"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(length) or b"{}")
                    if not isinstance(req, dict):
                        raise ValueError("body must be a JSON object")
                    queries = req.get("queries")
                    if isinstance(queries, str):
                        queries = [queries]
                    if not queries or not all(isinstance(q, str) for q in queries):
                        raise ValueError('"queries" must be a non-empty list of strings')
                    topk = int(req.get("topk", server.default_topk))
                    if topk < 1:
                        raise ValueError('"topk" must be >= 1')
                except (ValueError, TypeError, json.JSONDecodeError) as e:
                    with server._stats_lock:
                        server.stats["errors"] += 1
                    self._reply(400, {"error": str(e)})
                    return
                pending = _Pending(queries=list(queries), topk=topk)
                server._queue.put(pending)
                pending.event.wait()
                with server._stats_lock:
                    server.stats["requests"] += 1
                    server.stats["queries"] += len(pending.queries)
                if pending.error is not None:
                    with server._stats_lock:
                        server.stats["errors"] += 1
                    self._reply(500, {"error": pending.error})
                    return
                self._reply(
                    200,
                    {
                        "results": [
                            {"ids": i, "scores": s}
                            for i, s in zip(pending.ids, pending.scores)
                        ],
                        "batch_ms": round(pending.batch_ms, 3),
                    },
                )

        self._http = _HTTPServer((host, port), Handler)

    # ------------------------------------------------------------------
    @property
    def address(self) -> tuple[str, int]:
        return self._http.server_address[:2]

    def start(self, warmup: bool = True) -> None:
        """``warmup=True`` runs one padded dummy batch through the searcher
        before accepting traffic (the kernels build at their first launch),
        and lets its exception propagate: a searcher that cannot serve
        never starts listening."""
        if warmup:
            try:
                self.searcher.search([""] * self.max_batch, batch_size=self.max_batch)
            except Exception:
                self._http.server_close()
                raise
        self._dispatcher.start()
        self._serve_thread = threading.Thread(
            target=self._http.serve_forever, daemon=True
        )
        self._serve_thread.start()

    def stop(self) -> None:
        self._http.shutdown()
        self._http.server_close()
        self._queue.put(None)  # dispatcher sentinel
        self._dispatcher.join(timeout=10)

    # ------------------------------------------------------------------
    def _dispatch_loop(self) -> None:
        while True:
            first = self._queue.get()
            if first is None:
                return
            batch = [first]
            n = len(first.queries)
            deadline = time.perf_counter() + self.max_wait_ms / 1000.0
            # coalesce until the batch is full or the wait budget is spent
            while n < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._run_batch(batch)
                    return
                batch.append(nxt)
                n += len(nxt.queries)
            self._run_batch(batch)

    def _run_batch(self, batch: list[_Pending]) -> None:
        flat = [q for p in batch for q in p.queries]
        # dedup identical query strings across the coalesced requests: every
        # duplicate slot is a wasted encoder forward (resubmits and hot
        # queries are common online); results fan back out by string
        uniq: dict[str, int] = {}
        slot_of = [uniq.setdefault(q, len(uniq)) for q in flat]
        queries = list(uniq.keys())
        n_real = len(queries)
        # pad to a multiple of max_batch, as the JAX package's server does
        # (one program shape there); the port keeps it so both serve the
        # same batches
        queries = queries + [""] * (-n_real % self.max_batch)
        t0 = time.perf_counter()
        try:
            ranked, _ = self.searcher.search(queries, batch_size=self.max_batch)
            ids = ranked.ids.cpu().numpy()
            scores = ranked.scores.cpu().numpy()
        except Exception as e:  # surface to every waiting request
            for p in batch:
                p.error = f"{type(e).__name__}: {e}"
                p.event.set()
            return
        batch_ms = (time.perf_counter() - t0) * 1000.0
        with self._stats_lock:
            self.stats["batches"] += 1
            self.stats["batch_ms_total"] += batch_ms
        row = 0
        for p in batch:
            p.ids, p.scores = [], []
            for _ in p.queries:
                qi = slot_of[row]  # dedup: duplicate strings share one row
                row += 1
                # rows are score-descending with -inf pads at the tail, so
                # the finite entries are a prefix
                kr = min(p.topk, int(np.isfinite(scores[qi]).sum()))
                p.ids.append(ids[qi][:kr].astype(int).tolist())
                p.scores.append([round(float(x), 6) for x in scores[qi][:kr]])
            p.batch_ms = batch_ms
            p.event.set()


def serve_forever(searcher, host: str = "0.0.0.0", port: int = 8080, **kw) -> None:
    """Blocking entry point of the CLI's ``serve --http_port`` mode."""
    srv = SearchServer(searcher, host=host, port=port, **kw)
    srv.start()
    print(
        json.dumps(
            {
                "serving": f"http://{host}:{port}",
                "systems": searcher.active_systems,
                "max_batch": srv.max_batch,
            }
        ),
        flush=True,
    )
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()
