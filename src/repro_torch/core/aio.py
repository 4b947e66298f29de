"""Selector-based event-loop HTTP/1.1 frontend for the HOPAAS service.

The stdlib ``ThreadingHTTPServer`` frontend spends most of a tiny
ask/tell exchange on transport bookkeeping: one OS thread per
connection, ``email``-module header parsing, readline-based socket IO,
and whitespace-padded ``json.dumps`` on every response.  At thousands of
concurrent trial workers that overhead scales with *connection count*
instead of with work.  This module replaces it with the paper's
"scalable set of Uvicorn instances" shape in one process:

* **One IO thread** runs a ``selectors`` event loop: non-blocking
  accept/read/write over every connection, with an incremental HTTP/1.1
  request parser (plain ``bytes`` ops — no ``email`` module, no
  readline).  Keep-alive is the default and pipelined requests are
  parsed out of a single read.

* **A bounded pool of dispatch lanes** (worker threads) executes the
  router.  Requests are routed by a stable hash of the study key pulled
  from the URL (``/api/v2/studies/{key}…``, ``/api/v2/trials/{uid}…``
  where ``uid = key:n``), so all requests for one study land on the
  same lane: cross-thread contention on the per-study lock becomes
  in-order queue consumption, and the study's ``ObservationCache``
  stays hot on one thread.  Requests without a study key in the URL
  (v1 RPC, study list) use connection affinity.  Each lane is pinned to
  one ``HopaasServer`` worker, so per-study server state is not
  bounced between workers either.

* **A wire fast path**: responses are serialized with compact JSON
  separators, status/header blocks are pre-encoded once per status, and
  idempotent hot GETs are served from a response cache — the constant
  v1 ``/api/version`` body, and study resources keyed on the shard's
  ``data_version`` (the mutation counter: equal versions prove the
  serialized resource is still exact).  Cache probes still verify the
  bearer token; any miss or auth anomaly falls through to the full
  router so error envelopes stay byte-identical.

Responses to pipelined requests are written strictly in request order
(per-connection completion slots), whatever order the lanes finish in.
When a request's lane is idle and the loop isn't fanning out a busy
select round, the IO thread dispatches it *inline* — tiny exchanges
skip two thread handoffs, while sustained load flows through the lanes
and keeps its study affinity.  ``stop()`` drains in-flight work: the
listener closes immediately, established connections get a bounded
window to finish (requests already submitted — or still arriving on
them during the window — are answered), then everything closes.

The public entry point is ``HttpServiceRunner(..., backend="evloop")``
in ``repro_torch.core.transport`` (the default backend); this module has no
HTTP *client* side.
"""
from __future__ import annotations

import collections
import http.client
import itertools
import json
import os
import queue
import selectors
import socket
import sys
import threading
import time
import zlib
from typing import Any

from .api.errors import error_payload
from .auth import bearer_token

_MAX_HEADER_BYTES = 64 * 1024
_MAX_BODY_BYTES = 32 * 1024 * 1024
_RECV_SIZE = 64 * 1024
_CACHE_MAX_STUDIES = 1024
# read backpressure: a client that pipelines requests faster than it
# reads responses stops being read past these high-water marks (the
# threaded frontend got this for free by blocking in wfile.write);
# reading resumes once both drain below half
_MAX_PENDING = 128
_MAX_OUTBUF = 1 << 20


def open_server_socket(host: str, port: int, *, reuseport: bool = False,
                       blocking: bool = False) -> socket.socket:
    """Bound + listening TCP server socket with the service's standard
    options.  Shared by the event-loop frontend (non-blocking, feeds the
    selector) and the replication hub (blocking, one accept thread)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    if reuseport:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    sock.bind((host, port))
    sock.listen(256)
    sock.setblocking(blocking)
    return sock

_JSON_SEPARATORS = (",", ":")        # compact wire encoding


def _encode_body(payload: Any) -> bytes:
    return json.dumps(payload, separators=_JSON_SEPARATORS).encode()


# pre-encoded "status line + fixed headers + Content-Length: " blocks,
# built once per distinct status code ever sent
_HEAD_CACHE: dict[int, bytes] = {}


def _head(status: int) -> bytes:
    head = _HEAD_CACHE.get(status)
    if head is None:
        reason = http.client.responses.get(status, "Unknown")
        head = (f"HTTP/1.1 {status} {reason}\r\n"
                "Content-Type: application/json\r\n"
                "Content-Length: ").encode()
        _HEAD_CACHE[status] = head
    return head


def _encode_response(status: int, blob: bytes,
                     extra_headers: dict[str, str] | None = None,
                     close: bool = False, head_only: bool = False) -> bytes:
    # head_only (HEAD requests): Content-Length still describes the
    # body a GET would carry, but no body bytes follow (RFC 7231 §4.3.2)
    parts = [_head(status), str(len(blob)).encode(), b"\r\n"]
    if extra_headers:
        for k, v in extra_headers.items():
            parts.append(f"{k}: {v}\r\n".encode())
    if close:
        parts.append(b"Connection: close\r\n")
    parts.append(b"\r\n")
    if not head_only:
        parts.append(blob)
    return b"".join(parts)


# The frontend's few threads bounce the GIL at every recv/send/queue
# boundary; CPython's default 5 ms switch interval makes each of those
# reacquisitions wait up to a full interval behind a running dispatch,
# which dominates per-request cost under contention (profiled at ~600 us
# per syscall boundary on a loaded 2-core host).  A 1 ms interval cuts
# that convoy ~3x for a negligible preemption overhead.  It is an
# interpreter-wide knob, so it is scoped to the frontend's lifetime and
# refcounted across overlapping frontends.
_FAST_SWITCH_SECONDS = 0.001
_switch_lock = threading.Lock()
_switch_depth = 0
_switch_saved: float | None = None


def _acquire_fast_switch() -> None:
    global _switch_depth, _switch_saved
    with _switch_lock:
        _switch_depth += 1
        if _switch_depth == 1:
            saved = sys.getswitchinterval()
            if saved > _FAST_SWITCH_SECONDS:
                _switch_saved = saved
                sys.setswitchinterval(_FAST_SWITCH_SECONDS)


def _release_fast_switch() -> None:
    global _switch_depth, _switch_saved
    with _switch_lock:
        _switch_depth = max(0, _switch_depth - 1)
        if _switch_depth == 0 and _switch_saved is not None:
            sys.setswitchinterval(_switch_saved)
            _switch_saved = None


class _WireError(Exception):
    """A request the HTTP layer itself must reject (the router never
    sees it); the connection closes after the error response."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class _Pending:
    """One in-flight request's response slot.  Slots are appended in
    request order and flushed front-to-back, so pipelined responses
    never reorder even when lanes finish out of order."""

    __slots__ = ("data", "close_after")

    def __init__(self) -> None:
        self.data: bytes | None = None
        self.close_after = False


class _Connection:
    __slots__ = ("sock", "id", "lock", "inbuf", "outbuf", "pending",
                 "partial", "interest", "stop_reading", "throttled",
                 "closing", "closed", "broken")

    def __init__(self, sock: socket.socket, conn_id: int):
        self.sock = sock
        self.id = conn_id
        # guards pending/outbuf/socket writes: dispatch lanes write their
        # response directly from the lane thread when it is head-of-line
        # (saves two thread handoffs per request); the IO thread holds
        # the same lock in its read/write paths
        self.lock = threading.Lock()
        self.inbuf = bytearray()
        self.outbuf = bytearray()                 # reused response buffer
        self.pending: collections.deque[_Pending] = collections.deque()
        self.partial: tuple | None = None         # parsed-headers stash
        self.interest = 0                         # selector event mask
        self.stop_reading = False
        self.throttled = False                    # backpressure: no reads
        self.closing = False                      # close once outbuf drains
        self.closed = False
        self.broken = False                       # write error; IO closes


def _parse_one(conn: _Connection) -> tuple | None:
    """One complete request out of ``conn.inbuf`` -> (method, target,
    headers, body, keep_alive), or None when more bytes are needed.
    Raises ``_WireError`` for requests the HTTP layer must reject.

    Incremental: once the header block parses, it is stashed on the
    connection so body bytes arriving later never re-parse headers.
    """
    if conn.partial is None:
        end = conn.inbuf.find(b"\r\n\r\n")
        if end < 0:
            if len(conn.inbuf) > _MAX_HEADER_BYTES:
                raise _WireError(431, "request header block too large")
            return None
        lines = bytes(conn.inbuf[:end]).split(b"\r\n")
        try:
            method_b, target_b, version_b = lines[0].split(b" ", 2)
        except ValueError:
            raise _WireError(400, "malformed request line")
        keep_alive = not version_b.strip().endswith(b"/1.0")
        headers: dict[str, str] = {}
        content_length = 0
        for line in lines[1:]:
            name, sep, value = line.partition(b":")
            if not sep:
                continue
            key = name.decode("latin-1").strip()
            val = value.decode("latin-1").strip()
            headers[key] = val
            low = key.lower()
            if low == "content-length":
                try:
                    content_length = int(val)
                except ValueError:
                    raise _WireError(400, "invalid Content-Length")
                if content_length < 0:
                    raise _WireError(400, "invalid Content-Length")
            elif low == "connection":
                tokens = val.lower()
                if "close" in tokens:
                    keep_alive = False
                elif "keep-alive" in tokens:
                    keep_alive = True
            elif low == "transfer-encoding":
                raise _WireError(501, "Transfer-Encoding is not supported; "
                                      "send a Content-Length body")
        if content_length > _MAX_BODY_BYTES:
            raise _WireError(413, "request body too large")
        conn.partial = (method_b.decode("latin-1"),
                        target_b.decode("latin-1"), headers,
                        end + 4 + content_length, end + 4, keep_alive)
    method, target, headers, total, body_start, keep_alive = conn.partial
    if len(conn.inbuf) < total:
        return None
    body = bytes(conn.inbuf[body_start:total])
    del conn.inbuf[:total]
    conn.partial = None
    return method, target, headers, body, keep_alive


_STUDY_PREFIX = "/api/v2/studies/"
_TRIAL_PREFIX = "/api/v2/trials/"


def _study_key_of_target(target: str) -> str | None:
    """Study key embedded in a v2 URL, for lane affinity."""
    if target.startswith(_STUDY_PREFIX):
        rest = target[len(_STUDY_PREFIX):]
        key = rest.split("/", 1)[0].split("?", 1)[0]
        return key or None
    if target.startswith(_TRIAL_PREFIX):
        rest = target[len(_TRIAL_PREFIX):]
        seg = rest.split("/", 1)[0].split("?", 1)[0]
        key = seg.partition(":")[0]          # uid = "<study_key>:<n>"
        return key or None
    return None


class _Lane(threading.Thread):
    """One dispatch lane: a queue feeding one pinned server worker."""

    def __init__(self, frontend: "EventLoopFrontend", idx: int):
        super().__init__(daemon=True, name=f"hopaas-lane-{idx}")
        self.frontend = frontend
        self.idx = idx
        self.queue: queue.SimpleQueue = queue.SimpleQueue()
        self.busy = False                    # mid-request (inline gate)
        self.handled = 0                     # stats (single-writer)
        self.inline = 0                      # requests run on the IO thread
        self.cache_hits = 0

    def run(self) -> None:
        fe = self.frontend
        while True:
            item = self.queue.get()
            if item is None:
                return
            self.busy = True
            fe._execute(self, item)
            self.busy = False


class EventLoopFrontend:
    """Event-loop HTTP server over a list of ``HopaasServer`` workers.

    ``lanes`` bounds the dispatch pool (default: 2×cores, capped at 8).
    The listening socket binds in the constructor so ``host``/``port``
    are known before ``start()`` — same contract as the threaded
    frontend.
    """

    def __init__(self, workers: list, host: str = "127.0.0.1",
                 port: int = 0, lanes: int | None = None,
                 drain_seconds: float = 5.0, inline: bool | None = None,
                 dispatcher: Any = None, reuseport: bool = False,
                 extra_port: int | None = None):
        # ``dispatcher`` extends the crc32 study-key lane dispatch across
        # the process boundary (the shard fabric): each request is offered
        # to ``dispatcher.handle(lane, method, target, headers, body,
        # keep_alive)`` first — bytes returned are the (already encoded)
        # response, usually proxied from the owning worker process; None
        # falls through to the local workers.  A dispatcher may block on
        # upstream sockets, so inline dispatch is disabled with one.
        if not workers and dispatcher is None:
            raise ValueError("at least one server worker is required")
        self.workers = list(workers)
        self.dispatcher = dispatcher
        self._drain_seconds = float(drain_seconds)
        if dispatcher is not None:
            inline = False
        if not self.workers:
            inline = False
        elif inline is None:
            # Inline dispatch skips two thread handoffs per request, but
            # runs the handler on the IO thread.  Under the GIL that is
            # a straight win for handlers that never *block* — pure
            # in-memory dispatch is GIL-serialized whichever thread runs
            # it.  A storage engine that can sleep in fsync (journal /
            # durable backends) must stay on the lanes, or one group
            # commit would stall every connection.
            try:
                backend = self.workers[0].storage.storage_stats().get(
                    "backend")
            except Exception:
                backend = None
            inline = backend == "memory"
        self._inline_ok = bool(inline)
        if lanes is None:
            lanes = max(2, min(8, 2 * (os.cpu_count() or 2)))
        elif lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes}")
        self._lanes = [_Lane(self, i) for i in range(int(lanes))]
        self._listener = self._make_listener(host, port, reuseport)
        self.host, self.port = self._listener.getsockname()[:2]
        # optional second accept socket on a shared port (SO_REUSEPORT):
        # fabric workers accept straight off the public port where the
        # platform supports it, with the router proxy as the portable
        # fallback accept point on the same port
        self._extra_listener = None
        if extra_port is not None:
            if not hasattr(socket, "SO_REUSEPORT"):
                raise OSError("SO_REUSEPORT is not supported here")
            self._extra_listener = self._make_listener(host, extra_port,
                                                       True)
        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._done: queue.SimpleQueue = queue.SimpleQueue()
        self._conns: dict[int, _Connection] = {}
        self._conn_seq = itertools.count()
        self._thread: threading.Thread | None = None
        # one-way False->True shutdown flag; GIL-atomic bool that the IO
        # loop re-reads every wakeup, so a stale read costs one iteration
        self._closing = False  # repro-check: allow(shared-state)
        self._started = False
        self._stopped = False
        # response cache (wire fast path) — workers share storage/tokens
        self._storage = self.workers[0].storage if self.workers else None
        self._tokens = self.workers[0].tokens if self.workers else None
        self._cache_lock = threading.Lock()
        # writes serialized by _cache_lock; lock-free dict reads are
        # GIL-atomic and every hit is re-validated against the shard's
        # data_version before being served
        self._study_cache: dict[str, tuple[int, bytes, bytes]] = {}  # repro-check: allow(shared-state)
        # idempotent write-once cache: every writer stores identical
        # frozen bytes, so duplicate lock-free stores are benign
        self._v1_version_response: bytes | None = None  # repro-check: allow(shared-state)

    @staticmethod
    def _make_listener(host: str, port: int,
                       reuseport: bool) -> socket.socket:
        return open_server_socket(host, port, reuseport=reuseport,
                                  blocking=False)

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def start(self) -> "EventLoopFrontend":
        self._started = True
        _acquire_fast_switch()
        for lane in self._lanes:
            lane.start()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="hopaas-evloop")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._stopped:
            return
        self._stopped = True
        if not self._started:
            self._listener.close()
            if self._extra_listener is not None:
                self._extra_listener.close()
            return
        self._closing = True
        self._wake()
        if self._thread is not None:
            self._thread.join(timeout=self._drain_seconds + 2.0)
        for lane in self._lanes:
            lane.queue.put(None)
        for lane in self._lanes:
            lane.join(timeout=1.0)
        _release_fast_switch()

    def stats(self) -> dict[str, Any]:
        return {"backend": "evloop", "lanes": len(self._lanes),
                "requests": sum(l.handled for l in self._lanes),
                "inline_requests": sum(l.inline for l in self._lanes),
                "cache_hits": sum(l.cache_hits for l in self._lanes),
                "cache_entries": len(self._study_cache)}

    # ------------------------------------------------------------------ #
    # dispatch (lane threads; also the IO thread via the inline path)
    # ------------------------------------------------------------------ #
    def _execute(self, lane: _Lane, item: tuple) -> None:
        """Run one queued request to completion (response + flush)."""
        conn, slot, method, target, headers, body, keep_alive = item
        try:
            response = self._handle(lane, method, target, headers, body,
                                    keep_alive)
        except Exception as e:       # the frontend never drops a socket
            blob = _encode_body(error_payload(
                "internal", f"{type(e).__name__}: {e}"))
            response = _encode_response(500, blob, close=not keep_alive,
                                        head_only=method == "HEAD")
        lane.handled += 1
        slot.data = response
        slot.close_after = not keep_alive
        self._complete(conn)

    def _handle(self, lane: _Lane, method: str, target: str,
                headers: dict[str, str], body_bytes: bytes,
                keep_alive: bool) -> bytes:
        if self.dispatcher is not None:
            routed = self.dispatcher.handle(lane, method, target, headers,
                                            body_bytes, keep_alive)
            if routed is not None:
                return routed
            # None: the dispatcher determined this worker owns the study
            # (or has no opinion) — fall through to the local workers
        probe_key = None
        probe_version = -1
        body: Any = None
        body_error: str | None = None
        if method == "GET":
            # GET bodies were drained by the parser and are ignored —
            # same semantics as the threaded frontend
            if self._storage is not None:
                cached = self._cache_probe(lane, target, headers,
                                           keep_alive)
                if cached is not None:
                    return cached
                probe_key = self._cacheable_study_key(target)
                if probe_key is not None:
                    # read the version *before* dispatch: a concurrent
                    # mutation can only make the stored entry
                    # conservatively stale-keyed (next probe misses),
                    # never stale-served
                    probe_version = self._storage.data_version(probe_key)
        elif body_bytes:
            try:
                body = json.loads(body_bytes)
            except json.JSONDecodeError as e:
                body_error = f"request body is not valid JSON: {e.msg}"
        worker = self.workers[lane.idx % len(self.workers)]
        status, payload, extra = worker.handle_request(
            method, target, body, headers, body_error)
        blob = _encode_body(payload)
        if probe_key is not None and status == 200 and probe_version >= 0:
            with self._cache_lock:
                if len(self._study_cache) >= _CACHE_MAX_STUDIES:
                    self._study_cache.pop(next(iter(self._study_cache)))
                self._study_cache[probe_key] = (
                    probe_version, blob, _encode_response(200, blob))
        return _encode_response(status, blob, extra or None,
                                close=not keep_alive,
                                head_only=method == "HEAD")

    @staticmethod
    def _cacheable_study_key(target: str) -> str | None:
        """Key when ``target`` is exactly ``GET /api/v2/studies/{key}`` —
        the one study resource URL (no subpath, query, or verb)."""
        if not target.startswith(_STUDY_PREFIX):
            return None
        rest = target[len(_STUDY_PREFIX):]
        if not rest or "/" in rest or "?" in rest or ":" in rest:
            return None
        return rest

    def _cache_probe(self, lane: _Lane, target: str,
                     headers: dict[str, str],
                     keep_alive: bool) -> bytes | None:
        """Serve a hot GET from the response cache, or None to fall
        through to the router.  Auth is still enforced; anything
        unusual (bad token, unknown study) falls through so the error
        envelope is produced by the one true code path."""
        if target == "/api/version":
            if not keep_alive:
                return None      # rare: build via the normal path
            response = self._v1_version_response
            if response is None:
                status, payload, _ = self.workers[0].handle_request(
                    "GET", target, None, {})
                if status != 200:
                    return None
                # the v1 version payload is byte-frozen — cache forever
                response = _encode_response(status, _encode_body(payload))
                self._v1_version_response = response
            else:
                lane.cache_hits += 1
            return response
        key = self._cacheable_study_key(target)
        if key is None:
            return None
        token = bearer_token(headers)     # the router's parsing policy
        if token is None:
            return None
        try:
            self._tokens.verify(token)
        except Exception:
            return None
        entry = self._study_cache.get(key)
        if entry is None:
            return None
        version, blob, response = entry
        if self._storage.data_version(key) != version:
            return None
        lane.cache_hits += 1
        if not keep_alive:
            return _encode_response(200, blob, close=True)
        return response

    def _complete(self, conn: _Connection) -> None:
        """Called from a lane thread when its response slot is filled.

        Fast path: if this response is head-of-line, write it straight
        from the lane thread — the common one-request-in-flight case
        then never bounces back through the IO thread (two thread
        handoffs saved per request).  Anything left over (partial
        write, connection teardown, selector interest changes) is
        handed to the IO thread, which owns the selector.
        """
        with conn.lock:
            if not conn.closed and not conn.broken:
                self._flush_ready(conn)
                self._write_some(conn)
            needs_io_thread = bool(
                conn.broken or conn.outbuf or conn.throttled
                or (conn.closing and not conn.pending))
        if needs_io_thread:
            self._done.put(conn)
            self._wake()

    def _wake(self) -> None:
        try:
            # repro-check: allow(blocking) -- non-blocking wake pipe;
            # a full pipe means a wakeup is already pending
            self._wake_w.send(b"x")
        except (BlockingIOError, OSError):
            pass                 # wakeup already pending / loop gone

    # ------------------------------------------------------------------ #
    # IO thread
    # ------------------------------------------------------------------ #
    def _loop(self) -> None:
        sel = self._sel
        listeners = [self._listener]
        if self._extra_listener is not None:
            listeners.append(self._extra_listener)
        for lsock in listeners:
            sel.register(lsock, selectors.EVENT_READ, ("accept", lsock))
        sel.register(self._wake_r, selectors.EVENT_READ, ("wake", None))
        listener_open = True
        drain_deadline: float | None = None
        while True:
            if self._closing:
                if listener_open:
                    # clients already in the listen backlog completed
                    # their handshake (and likely sent a request); adopt
                    # them into the drain instead of RSTing them
                    for lsock in listeners:
                        self._accept(lsock)
                        sel.unregister(lsock)
                        lsock.close()
                    listener_open = False
                    drain_deadline = time.monotonic() + self._drain_seconds
                timeout = 0.05
            else:
                timeout = 0.5
            for key, events in sel.select(timeout):
                kind, conn = key.data
                if kind == "accept":
                    self._accept(conn)
                elif kind == "wake":
                    try:
                        # repro-check: allow(blocking) -- draining the
                        # non-blocking wake pipe after readiness
                        while self._wake_r.recv(4096):
                            pass
                    except (BlockingIOError, OSError):
                        pass
                else:
                    if events & selectors.EVENT_READ:
                        self._on_read(conn)
                    if events & selectors.EVENT_WRITE and not conn.closed:
                        self._on_write(conn)
            self._drain_done()
            if self._closing and not listener_open:
                # reap only after a select pass, so requests whose bytes
                # arrived before the shutdown still get parsed, answered,
                # and flushed; a connection with nothing in flight after
                # that pass is genuinely idle
                for conn in [c for c in self._conns.values()
                             if not c.pending and not c.outbuf]:
                    self._close_conn(conn)
                if not self._conns or (drain_deadline is not None
                                       and time.monotonic() > drain_deadline):
                    break
        for conn in list(self._conns.values()):
            self._close_conn(conn)
        if listener_open:
            for lsock in listeners:
                sel.unregister(lsock)
                lsock.close()
        sel.close()
        self._wake_r.close()
        self._wake_w.close()

    def _accept(self, listener: socket.socket | None = None) -> None:
        if listener is None:
            listener = self._listener
        while True:
            try:
                # repro-check: allow(blocking) -- non-blocking listener,
                # called only after select() reported it readable
                sock, _addr = listener.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _Connection(sock, next(self._conn_seq))
            self._conns[conn.id] = conn
            self._set_interest(conn)

    def _on_read(self, conn: _Connection) -> None:
        try:
            # repro-check: allow(blocking) -- non-blocking socket read
            # after readiness; EWOULDBLOCK returns to the loop
            data = conn.sock.recv(_RECV_SIZE)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close_conn(conn)
            return
        if not data:                       # peer closed its write side
            with conn.lock:
                conn.stop_reading = True
                idle = not conn.pending and not conn.outbuf
                if not idle:
                    conn.closing = True    # flush in-flight, then close
            if idle:
                self._close_conn(conn)
            else:
                self._set_interest(conn)
            return
        conn.inbuf += data
        dispatches = []
        with conn.lock:
            while True:
                try:
                    request = _parse_one(conn)
                except _WireError as e:
                    slot = _Pending()
                    slot.data = _encode_response(
                        e.status, _encode_body(
                            error_payload("bad_request", e.message)),
                        close=True)
                    slot.close_after = True
                    conn.pending.append(slot)
                    conn.stop_reading = True
                    break
                if request is None:
                    break
                method, target, headers, body, keep_alive = request
                slot = _Pending()
                conn.pending.append(slot)
                dispatches.append(
                    (conn, slot, method, target, headers, body, keep_alive))
            if (len(conn.pending) >= _MAX_PENDING
                    or len(conn.outbuf) >= _MAX_OUTBUF):
                conn.throttled = True      # stop reading until drained
        for item in dispatches:
            lane = self._route(item[3], conn)
            # adaptive inline fast path: when dispatch cannot block (see
            # __init__), the target lane is idle, and this is the
            # connection's only in-flight request, running the handler
            # on the IO thread skips two thread handoffs — the dominant
            # per-request cost for tiny exchanges.  Pipelined bursts and
            # anything queued behind a busy lane still flow through the
            # lanes and keep their study-affinity batching.
            if (self._inline_ok and len(conn.pending) == 1
                    and not lane.busy and lane.queue.empty()):
                lane.inline += 1
                # repro-check: allow(blocking) -- _inline_ok is set only
                # for the pure in-memory backend with no fabric
                # dispatcher (see __init__): nothing on this path can
                # fsync, wait for replication, or touch a socket
                self._execute(lane, item)
            else:
                lane.queue.put(item)
        self._flush(conn)

    def _route(self, target: str, conn: _Connection) -> _Lane:
        key = _study_key_of_target(target)
        if key is None:
            return self._lanes[conn.id % len(self._lanes)]
        return self._lanes[zlib.crc32(key.encode()) % len(self._lanes)]

    def _drain_done(self) -> None:
        while True:
            try:
                conn = self._done.get_nowait()
            except queue.Empty:
                return
            if not conn.closed:
                self._flush(conn)

    @staticmethod
    def _flush_ready(conn: _Connection) -> None:
        """Move ready responses (in request order) into the output
        buffer.  Caller holds ``conn.lock``."""
        while conn.pending and conn.pending[0].data is not None:
            slot = conn.pending.popleft()
            conn.outbuf += slot.data
            if slot.close_after:
                conn.closing = True
                conn.stop_reading = True
                conn.pending.clear()       # never respond past a close
                break

    @staticmethod
    def _write_some(conn: _Connection) -> None:
        """Send as much of the output buffer as the socket accepts.
        Caller holds ``conn.lock``; never raises — write failures mark
        the connection broken for the IO thread to reap."""
        while conn.outbuf:
            try:
                # repro-check: allow(blocking) -- non-blocking socket
                # write; EWOULDBLOCK leaves the rest for the next round
                sent = conn.sock.send(conn.outbuf)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                conn.broken = True
                return
            if not sent:
                return
            del conn.outbuf[:sent]

    def _flush(self, conn: _Connection) -> None:
        """IO-thread flush: drain ready slots, write, then reconcile
        selector interest / teardown (lanes cannot touch the selector)."""
        with conn.lock:
            self._flush_ready(conn)
            self._write_some(conn)
            if (conn.throttled and len(conn.pending) < _MAX_PENDING // 2
                    and len(conn.outbuf) < _MAX_OUTBUF // 2):
                conn.throttled = False     # drained: resume reading
            done = conn.broken or (conn.closing and not conn.outbuf
                                   and not conn.pending)
        if done:
            self._close_conn(conn)
        else:
            self._set_interest(conn)

    def _on_write(self, conn: _Connection) -> None:
        self._flush(conn)

    def _set_interest(self, conn: _Connection) -> None:
        events = 0
        if not conn.stop_reading and not conn.throttled:
            events |= selectors.EVENT_READ
        if conn.outbuf:
            events |= selectors.EVENT_WRITE
        if events == conn.interest:
            return
        try:
            if events == 0:
                self._sel.unregister(conn.sock)
            elif conn.interest == 0:
                self._sel.register(conn.sock, events, ("conn", conn))
            else:
                self._sel.modify(conn.sock, events, ("conn", conn))
        except (KeyError, ValueError, OSError):
            pass
        conn.interest = events

    def _close_conn(self, conn: _Connection) -> None:
        with conn.lock:
            if conn.closed:
                return
            conn.closed = True
            if conn.interest:
                try:
                    self._sel.unregister(conn.sock)
                except (KeyError, ValueError, OSError):
                    pass
                conn.interest = 0
            try:
                conn.sock.close()
            except OSError:
                pass
        self._conns.pop(conn.id, None)
