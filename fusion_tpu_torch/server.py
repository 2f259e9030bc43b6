"""HTTP serving front-end with dynamic batching.

Wraps a built (or reloaded) ``HybridSearcher``, or a
``SegmentedHybridSearcher`` that takes updates while it serves, in a small
dependency-free HTTP server:

  * POST /search   {"queries": ["..."], "topk": 10}  →
                   {"results": [{"ids": [...], "scores": [...]}, ...],
                    "batch_ms": ...}
  * GET  /healthz  → {"ok": true, "systems": [...], "corpus_docs": N}
                   (a segmented searcher's live ``n_docs``)
  * GET  /stats    → request/batch/query counters and latency aggregates:
                   ``queue_wait_ms_total`` sums, over the ``dispatched``
                   requests, the time from a request's enqueue to the start
                   of the search call of the batch that carries it

One dispatcher owns the searcher:

  * every HTTP handler thread only enqueues its queries and waits;
  * one dispatcher thread drains the queue, coalesces up to ``max_batch``
    queries across requests (waiting at most ``max_wait_ms`` after the first
    arrival), de-duplicates identical query strings, pads the batch to a
    multiple of ``max_batch``, runs one ``searcher.search`` call, and fans
    the results back out.  Concurrent small requests therefore share one
    batch on the device.

``start()`` warms the searcher with one padded batch first, and raises if
that fails: a kernel that does not build or launch stops the server instead
of surfacing as a 500 on the first request.

A sharded searcher (``ShardedHybridSearcher``, or a segmented one built with
``mesh=``) is served on every rank of its mesh, started as torchrun starts
every rank: each rank builds ``SearchServer(searcher, ...)`` and calls
``start()`` (or ``serve_forever``).  The JAX package drives every device
from one process; the port runs one process per card, so:

  * the rank at index coordinate 0 (the leader) binds the HTTP port and
    coalesces the requests, and sends each padded, de-duplicated batch to
    every rank over a process group of its own
    (``parallel.sharding.Channel``); every rank runs the same
    ``searcher.search`` call on it, in the same order, and the leader fans
    the lists out.  The other ranks run a loop that takes each message and
    returns on the leader's ``stop()``; an idle leader sends a message every
    few seconds (``Channel.idle_s``, well inside the group's timeout), so no
    rank's wait for the next one outlasts the timeout;
  * a segmented searcher's updates make collectives, so they go through the
    same dispatcher: ``update("add_documents", corpus, bm25_docs=...)`` (or
    ``delete_documents``, ``compact``) on the leader runs the call on every
    rank between two batches and returns its result (on one device it is
    ``searcher.add_documents`` serialized with the searches);
  * after each batch and update the ranks count their failures in one small
    all-gather.  A failure on every rank at the same point (a bad batch, a
    kernel that fails on every rank) is a 500 for that batch's requests and
    the server serves on, as on one device.  A failure on some ranks only
    ends the server on every rank with an error; so does a collective that
    outlives the group's timeout (``initialize_multihost(timeout=...)``),
    which is how a rank that fails before a collective releases the ranks
    waiting in it.  ``wait()`` and ``serve_forever`` raise that error, and
    so does ``stop()``;
  * the mesh must lie along ``index`` alone: the sharded searcher splits its
    work over that axis only, and a ``data`` or ``model`` rank would repeat
    every search (serve each replica with a server of its own).
"""

from __future__ import annotations

import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from fusion_tpu_torch.parallel import sharding
from fusion_tpu_torch.parallel.sharding import INDEX_AXIS
from fusion_tpu_torch.utils.profiling import span

__all__ = ["SearchServer", "serve_forever"]

# the searcher calls ``SearchServer.update`` runs on every rank
UPDATES = ("add_documents", "delete_documents", "compact")
_IDLE = object()  # the dispatcher's queue stayed empty for the channel's idle_s


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
    enqueued: float = field(default_factory=time.perf_counter)
    started: float | None = None  # when its batch's search call started

    def fail(self, e: BaseException) -> None:
        self.error = f"{type(e).__name__}: {e}"
        self.event.set()


@dataclass
class _Update:
    method: str
    args: tuple
    kwargs: dict
    event: threading.Event = field(default_factory=threading.Event)
    result: object = None
    error: BaseException | None = None

    def fail(self, e: BaseException) -> None:
        self.error = e
        self.event.set()


class SearchServer:
    """Dynamic-batching HTTP wrapper around a built searcher (on every rank
    of a sharded searcher's mesh: see the module's note)."""

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
        if mesh is not None and mesh.size > mesh.shape[INDEX_AXIS]:
            raise ValueError(
                f"SearchServer serves a mesh along index alone, got {mesh.shape}: the sharded searcher splits "
                "its work over index only, so each data or model rank would repeat every search; serve each "
                "replica with a server of its own"
            )
        self.searcher = searcher
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.default_topk = default_topk
        self._channel = sharding.Channel(mesh) if mesh is not None and mesh.size > 1 else None
        # the rank that listens and coalesces (index coordinate 0)
        self.leader = self._channel is None or self._channel.rank == 0
        self._queue: queue.Queue = queue.Queue()
        self._stats_lock = threading.Lock()
        self.stats = {
            "requests": 0,
            "queries": 0,
            "batches": 0,
            "errors": 0,
            "batch_ms_total": 0.0,
            "queue_wait_ms_total": 0.0,
            "dispatched": 0,
        }
        self._failure: BaseException | None = None
        self._failure_lock = threading.Lock()  # no request is queued after a failure drained the queue
        self._ended = threading.Event()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop if self.leader else self._follow_loop, daemon=True
        )
        self._http = _HTTPServer((host, port), self._handler()) if self.leader else None

    def _handler(self):
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
                        n = int(np.asarray(s.corpus_ids).shape[0])  # every rank holds all ids
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
                if not server._submit(pending):
                    self._reply(503, {"error": f"the server has ended: {server._failure}"})
                    return
                pending.event.wait()
                with server._stats_lock:
                    server.stats["requests"] += 1
                    server.stats["queries"] += len(pending.queries)
                    if pending.started is not None:
                        server.stats["dispatched"] += 1
                        server.stats["queue_wait_ms_total"] += (pending.started - pending.enqueued) * 1000.0
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

        return Handler

    # ------------------------------------------------------------------
    @property
    def address(self) -> tuple[str, int] | None:
        """The leader's (host, port); None on the other ranks."""
        return self._http.server_address[:2] if self._http is not None else None

    def start(self, warmup: bool = True) -> None:
        """``warmup=True`` runs one padded dummy batch through the searcher
        on every rank before accepting traffic (the kernels build at their
        first launch), and raises if it fails: a searcher that cannot serve
        never starts listening."""
        if warmup:
            try:
                _, error = self._run(("search", [""] * self.max_batch, self.max_batch))
            except BaseException:
                self._close()
                raise
            if error is not None:
                self._close()
                raise error
        self._dispatcher.start()
        if self._http is not None:
            self._serve_thread = threading.Thread(target=self._http.serve_forever, daemon=True)
            self._serve_thread.start()

    def update(self, method: str, *args, **kwargs):
        """Run ``searcher.<method>(*args, **kwargs)`` (one of ``UPDATES``) on
        every rank, between two batches, and return its result; raises what
        it raised.  Call it on the leader: on another rank it returns None at
        once, and the leader's call reaches the searcher there through the
        channel."""
        if method not in UPDATES:
            raise ValueError(f"update runs one of {UPDATES}, got {method!r}")
        if not self.leader:
            return None
        if not self._dispatcher.is_alive():
            raise RuntimeError("the server is not running: start() it first")
        item = _Update(method, args, kwargs)
        if not self._submit(item):
            raise RuntimeError("the server has ended") from self._failure
        item.event.wait()
        if item.error is not None:
            raise item.error
        return item.result

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the server ends (``stop()``, the leader's stop on
        another rank, or a failure) or ``timeout`` seconds pass → whether it
        ended; raises the failure that ended it."""
        ended = self._ended.wait(timeout)
        self._raise_failure()
        return ended

    def stop(self) -> None:
        """On the leader: stop listening and send every rank the stop; on
        another rank: wait for the leader's.  Raises if the server ended
        with a failure."""
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
            self._queue.put(None)  # dispatcher sentinel
            if self._dispatcher.ident is not None:
                self._dispatcher.join(timeout=10)
        elif self._dispatcher.ident is not None:
            self._dispatcher.join()
        self._raise_failure()

    # ------------------------------------------------------------------
    def _raise_failure(self) -> None:
        if self._failure is not None:
            raise RuntimeError(f"the server ended with an error: {self._failure}") from self._failure

    def _close(self) -> None:
        if self._http is not None:
            self._http.server_close()

    def _submit(self, item) -> bool:
        with self._failure_lock:
            if self._failure is not None:
                return False
            self._queue.put(item)
            return True

    def _send(self, message) -> None:
        """The leader's ``message`` to every other rank."""
        if self._channel is not None:
            self._channel.broadcast(message)

    def _run(self, message) -> tuple[object, BaseException | None]:
        """Run ``message`` on this rank, as every rank does (the warm-up, or
        what the leader sent) → (result, error): the error is None when every rank
        succeeded, this rank's when every rank failed at the same point;
        raises when only some failed, or failed at different points (the
        ranks may now hold different states, and a group whose collective
        failed on one rank is out of step: no rank can go on)."""
        entered = sharding.COLLECTIVES["entered"]
        result, error = self._execute(message)
        if self._channel is None:
            return result, error
        failed, same_point = self._channel.failures(error is not None, sharding.COLLECTIVES["entered"] - entered)
        if failed == 0 or (failed == self._channel.size and same_point):
            return result, error
        raise RuntimeError(
            f"{failed} of {self._channel.size} ranks failed a step"
            + ("" if same_point else ", at different points")
            + ": the ranks are out of step"
        ) from error

    def _execute(self, message) -> tuple[object, BaseException | None]:
        kind, *rest = message
        try:
            if kind == "search":
                queries, batch_size = rest
                ranked, _ = self.searcher.search(queries, batch_size=batch_size)
                return (ranked.ids.cpu().numpy(), ranked.scores.cpu().numpy()), None
            method, args, kwargs = rest
            return getattr(self.searcher, method)(*args, **kwargs), None
        except Exception as e:  # every rank's outcome is compared in _run
            return None, e

    def _fail(self, e: BaseException) -> None:
        """The server ends with ``e``: every queued request gets it, the
        leader stops listening, ``wait`` and ``stop`` raise it."""
        with self._failure_lock:
            self._failure = e
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if isinstance(item, (_Pending, _Update)):
                item.fail(e)
        if self._http is not None:
            self._http.shutdown()

    # ------------------------------------------------------------------
    def _dispatch_loop(self) -> None:
        try:
            held = None  # an update or the sentinel that ended a coalescing wait
            while True:
                if held is not None:
                    first, held = held, None
                else:
                    with span("serve.take"):
                        first = self._take()
                if first is _IDLE:
                    self._send(("idle",))
                    continue
                if first is None:
                    self._send(("stop",))
                    return
                if isinstance(first, _Update):
                    self._run_update(first)
                    continue
                batch = [first]
                n = len(first.queries)
                deadline = time.perf_counter() + self.max_wait_ms / 1000.0
                # coalesce until the batch is full or the wait budget is spent
                with span("serve.coalesce"):
                    while n < self.max_batch:
                        remaining = deadline - time.perf_counter()
                        if remaining <= 0:
                            break
                        try:
                            nxt = self._queue.get(timeout=remaining)
                        except queue.Empty:
                            break
                        if not isinstance(nxt, _Pending):
                            held = nxt  # runs after this batch, in arrival order
                            break
                        batch.append(nxt)
                        n += len(nxt.queries)
                self._run_batch(batch)
        except BaseException as e:  # the ranks are out of step: the server ends
            self._fail(e)
        finally:
            self._ended.set()

    def _take(self):
        if self._channel is None:
            return self._queue.get()
        try:
            return self._queue.get(timeout=self._channel.idle_s)
        except queue.Empty:
            return _IDLE

    def _follow_loop(self) -> None:
        try:
            while True:
                message = self._channel.broadcast()
                if message[0] == "stop":
                    return
                if message[0] != "idle":
                    self._run(message)
        except BaseException as e:
            self._fail(e)
        finally:
            self._ended.set()

    def _run_update(self, item: _Update) -> None:
        message = ("update", item.method, item.args, item.kwargs)
        self._send(message)
        try:
            item.result, error = self._run(message)
        except BaseException as e:
            item.fail(e)
            raise
        if error is not None:
            item.fail(error)
        else:
            item.event.set()

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
        for p in batch:
            p.started = t0
        message = ("search", queries, self.max_batch)
        self._send(message)
        try:
            out, error = self._run(message)
        except BaseException as e:
            for p in batch:
                p.fail(e)
            raise
        if error is not None:  # surface to every waiting request
            for p in batch:
                p.fail(error)
            return
        ids, scores = out
        batch_ms = (time.perf_counter() - t0) * 1000.0
        with self._stats_lock:
            self.stats["batches"] += 1
            self.stats["batch_ms_total"] += batch_ms
        with span("serve.fanout"):
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
    """Blocking entry point of the CLI's ``serve --http_port`` mode; every
    rank of a sharded searcher's mesh calls it (the leader listens).  It
    returns when the leader stops, and raises if the server ends with a
    failure."""
    srv = SearchServer(searcher, host=host, port=port, **kw)
    srv.start()
    if srv.leader:
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
        while not srv.wait(3600):
            pass
    except KeyboardInterrupt:
        srv.stop()
