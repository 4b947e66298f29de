"""Transports between HOPAAS clients and the service.

* ``DirectTransport``      — in-process function call (fast path for tests
                             and single-host campaigns).
* ``HttpTransport``        — one persistent HTTP/1.1 connection (stdlib
                             ``http.client``), reconnect-once on stale
                             keep-alive sockets.
* ``PooledHttpTransport``  — N persistent connections with checkout /
                             checkin, so multi-threaded workers sharing
                             one transport stop serializing on a single
                             socket.
* ``HttpServiceRunner``    — the server side: mounts ``HopaasServer``
                             workers behind either the event-loop
                             frontend (``repro_torch.core.aio``, the default)
                             or the legacy thread-per-connection stdlib
                             server (``backend="threaded"``).
* ``ReverseProxy`` role    — both frontends fan requests out over N
                             backend workers sharing one storage (the
                             NGINX + Uvicorn×N shape of paper sec. 3).

All transports carry request *headers* (the v2 surface authenticates via
``Authorization: Bearer``) and pass query strings through untouched, so
``GET /api/v2/studies/{key}/trials?state=completed&limit=50`` works
identically in-process and over the wire.  ``request_full`` additionally
exposes response headers (e.g. the ``Allow`` list on a 405).

The frontend backend is selected per runner (``backend=``) or globally
via ``REPRO_FRONTEND=evloop|threaded`` (CI runs the suite under both).
"""
from __future__ import annotations

import http.client
import itertools
import json
import os
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from .server import HopaasServer

# (status, payload) / (status, payload, response headers)
Result = tuple[int, dict[str, Any]]
FullResult = tuple[int, dict[str, Any], dict[str, str]]


class Transport:
    def request(self, method: str, path: str,
                body: dict[str, Any] | None = None,
                headers: dict[str, str] | None = None) -> Result:
        return self.request_full(method, path, body, headers)[:2]

    def request_full(self, method: str, path: str,
                     body: dict[str, Any] | None = None,
                     headers: dict[str, str] | None = None) -> FullResult:
        raise NotImplementedError


class DirectTransport(Transport):
    def __init__(self, server: HopaasServer):
        self.server = server

    def request_full(self, method, path, body=None, headers=None):
        return self.server.handle_request(method, path, body, headers)


class RoundRobinTransport(Transport):
    """Client-side round robin across several in-proc workers (used to test
    the shared-storage consistency of horizontally scaled servers)."""

    def __init__(self, servers: list[HopaasServer]):
        self.servers = servers
        self._counter = itertools.count()    # next() is GIL-atomic

    def request_full(self, method, path, body=None, headers=None):
        i = next(self._counter) % len(self.servers)
        return self.servers[i].handle_request(method, path, body, headers)


# --------------------------------------------------------------------------- #
# HTTP server side
# --------------------------------------------------------------------------- #
def _make_handler(target):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 => persistent connections; every response carries an
        # explicit Content-Length so keep-alive framing is unambiguous.
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):   # quiet
            pass

        def _respond(self, status: int, payload: dict[str, Any],
                     extra_headers: dict[str, str] | None = None,
                     head_only: bool = False) -> None:
            blob = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            for k, v in (extra_headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            if not head_only:      # HEAD: headers only (RFC 7231 §4.3.2)
                self.wfile.write(blob)

        def _read_body(self) -> tuple[Any, str | None]:
            """(parsed JSON, parse-error message).  Always drains the
            socket so keep-alive framing survives a bad body."""
            n = int(self.headers.get("Content-Length", 0) or 0)
            raw = self.rfile.read(n) if n else b""
            if not raw:
                return None, None
            try:
                return json.loads(raw), None
            except json.JSONDecodeError as e:
                return None, f"request body is not valid JSON: {e.msg}"

        def _dispatch(self, method: str, body: Any,
                      body_error: str | None) -> None:
            self._respond(*target(self.path, method, body,
                                  dict(self.headers), body_error),
                          head_only=method == "HEAD")

        def do_GET(self):
            self._read_body()    # drain any body; GET bodies are ignored
            self._dispatch("GET", None, None)

        def do_HEAD(self):
            self._read_body()
            self._dispatch("HEAD", None, None)

        # every other method reaches the router, which answers 405 with
        # an ``Allow`` header (not the stdlib's bare 501) for paths that
        # exist under a different method — wire parity with
        # ``Router.dispatch``
        def _do_with_body(self, method: str) -> None:
            body, err = self._read_body()
            self._dispatch(method, body, err)

        def do_POST(self):
            self._do_with_body("POST")

        def do_PUT(self):
            self._do_with_body("PUT")

        def do_PATCH(self):
            self._do_with_body("PATCH")

        def do_DELETE(self):
            self._do_with_body("DELETE")

        def do_OPTIONS(self):
            self._do_with_body("OPTIONS")

    return Handler


class _ThreadedFrontend:
    """Legacy thread-per-connection frontend (stdlib ThreadingHTTPServer).

    Kept as the ``backend="threaded"`` reference implementation and the
    baseline for ``benchmarks/bench_transport.py``.
    """

    def __init__(self, workers: list[HopaasServer], host: str, port: int):
        self.workers = workers
        # lock-free round robin: itertools.count().__next__ is atomic
        # under the GIL, so the old per-request Lock is pure overhead
        self._counter = itertools.count()
        self.httpd = ThreadingHTTPServer((host, port), _make_handler(
            lambda path, method, body, headers, body_error:
                self._pick().handle_request(method, path, body, headers,
                                            body_error)))
        self.host, self.port = self.httpd.server_address[:2]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)

    def _pick(self) -> HopaasServer:
        return self.workers[next(self._counter) % len(self.workers)]

    def start(self) -> "_ThreadedFrontend":
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()

    def stats(self) -> dict[str, Any]:
        return {"backend": "threaded"}


def _env_workers() -> int:
    try:
        return max(1, int(os.environ.get("REPRO_WORKERS", "1") or 1))
    except ValueError:
        return 1


_FABRIC_MISSING = ("the multi-process shard fabric is not ported to "
                   "repro_torch yet (see ROADMAP.md)")


class HttpServiceRunner:
    """Hosts one or more HopaasServer workers behind an HTTP frontend.

    ``backend`` selects the frontend: ``"evloop"`` (default) is the
    selector-based event-loop server with sharded dispatch lanes
    (``repro_torch.core.aio``); ``"threaded"`` is the legacy stdlib
    thread-per-connection server.  ``REPRO_FRONTEND`` overrides the
    default process-wide.  With multiple workers, requests fan out
    across worker instances that share one storage — the paper's
    Uvicorn×N + PostgreSQL deployment shape; the event loop pins each
    dispatch lane (and therefore each study) to one worker.

    ``workers=N`` (or ``REPRO_WORKERS=N``) with N > 1 would thread the
    shard-fabric router into the request path; the fabric is not ported
    yet, so that raises ``NotImplementedError``.
    """

    def __init__(self, server: HopaasServer | list[HopaasServer],
                 host: str = "127.0.0.1", port: int = 0,
                 backend: str | None = None, lanes: int | None = None,
                 workers: int | None = None):
        self.workers = server if isinstance(server, list) else [server]
        self.backend = (backend
                        or os.environ.get("REPRO_FRONTEND", "evloop")).lower()
        self.fabric_workers = (_env_workers() if workers is None
                               else max(1, int(workers)))
        if self.backend == "evloop":
            if self.fabric_workers > 1:
                raise NotImplementedError(_FABRIC_MISSING)
            from .aio import EventLoopFrontend
            self._frontend = EventLoopFrontend(self.workers, host=host,
                                               port=port, lanes=lanes)
        elif self.backend == "threaded":
            self.fabric_workers = 1
            self._frontend = _ThreadedFrontend(self.workers, host, port)
        else:
            raise ValueError(f"unknown frontend backend {self.backend!r} "
                             "(expected 'evloop' or 'threaded')")
        self.host, self.port = self._frontend.host, self._frontend.port

    def start(self) -> "HttpServiceRunner":
        self._frontend.start()
        return self

    def stop(self) -> None:
        self._frontend.stop()
        # durability: no acknowledged mutation may ride only in an OS
        # buffer once the frontend is gone (workers usually share one
        # storage object — flush each distinct one once)
        for storage in {id(w.storage): w.storage for w in self.workers}.values():
            storage.flush()

    def frontend_stats(self) -> dict[str, Any]:
        """Frontend-level counters (lane count, cache hits, ...)."""
        return self._frontend.stats()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"


class ShardedHttpTransport(Transport):
    """Client-side shard routing over the fabric's worker endpoints.

    The shard fabric is not ported yet, so this raises
    ``NotImplementedError``; use ``HttpTransport`` or
    ``PooledHttpTransport`` against a single-process service.
    """

    def __init__(self, endpoints: list[tuple[str, int]],
                 timeout: float = 30.0, pool_size: int = 2):
        raise NotImplementedError(_FABRIC_MISSING)


# --------------------------------------------------------------------------- #
# HTTP client side
# --------------------------------------------------------------------------- #

# failure modes of an idle keep-alive socket the server closed between
# requests — the only case where resending is known-safe (the request
# never reached the application).  Timeouts and fresh-connection errors
# must surface: the server may already have processed the (non-
# idempotent) ask/tell, and a blind resend would duplicate it.
_STALE_ERRORS = (http.client.RemoteDisconnected,
                 http.client.BadStatusLine,
                 ConnectionResetError, BrokenPipeError)


class _PersistentConnection:
    """One keep-alive connection with stale-socket recovery.

    Not thread-safe — callers (``HttpTransport``'s lock,
    ``PooledHttpTransport``'s checkout queue) guarantee exclusive use.
    """

    def __init__(self, host: str, port: int, timeout: float):
        self.host, self.port, self.timeout = host, int(port), timeout
        self._conn: http.client.HTTPConnection | None = None

    def _exchange(self, method: str, path: str, payload: str | None,
                  headers: dict[str, str] | None) -> FullResult:
        if self._conn is None:
            self._conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout)
        send_headers = {"Content-Type": "application/json"}
        if headers:
            send_headers.update(headers)
        self._conn.request(method, path, body=payload, headers=send_headers)
        resp = self._conn.getresponse()
        data = resp.read()
        try:
            parsed = json.loads(data) if data else {}
        except json.JSONDecodeError:
            # a proxy error page / crashing server wrote a non-JSON body;
            # surface it as a structured client error, never a raw
            # JSONDecodeError (satellite: 502-style HopaasError)
            from .client import HopaasError
            snippet = data[:120].decode("utf-8", "replace")
            raise HopaasError(
                f"{method} {path} -> {resp.status}: server returned a "
                f"non-JSON body: {snippet!r}", status=502,
                code="bad_upstream_body")
        return resp.status, parsed, {k: v for k, v in resp.getheaders()}

    def roundtrip(self, method: str, path: str, payload: str | None,
                  headers: dict[str, str] | None) -> FullResult:
        reused = self._conn is not None
        try:
            return self._exchange(method, path, payload, headers)
        except _STALE_ERRORS:
            self.close()
            if not reused:
                raise
            # the keep-alive socket died idle: resending is safe
            try:
                return self._exchange(method, path, payload, headers)
            except (http.client.HTTPException, OSError):
                self.close()
                raise
        except (http.client.HTTPException, OSError):
            self.close()
            raise

    def close(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            finally:
                self._conn = None


class HttpTransport(Transport):
    """Client side of the HTTP transport (stdlib http.client).

    Keeps one persistent connection per transport (HTTP/1.1 keep-alive)
    and transparently reconnects once when the socket has gone stale —
    a dropped keep-alive never surfaces to the caller.  Pass
    ``persistent=False`` for the old connection-per-request behavior
    (kept for the benchmark comparison).  Thread-safe, but concurrent
    callers serialize on the single socket — use ``PooledHttpTransport``
    for multi-threaded workers sharing one transport.
    """

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 persistent: bool = True):
        self.host, self.port, self.timeout = host, int(port), timeout
        self.persistent = bool(persistent)
        self._box = _PersistentConnection(host, int(port), timeout)
        self._lock = threading.Lock()     # the connection is not thread-safe

    @classmethod
    def from_url(cls, url: str, timeout: float = 30.0,
                 persistent: bool = True) -> "HttpTransport":
        host, port = _split_url(url)
        return cls(host, port, timeout, persistent=persistent)

    def request_full(self, method, path, body=None, headers=None):
        # GET carries no body: unread body bytes would corrupt keep-alive
        # framing on servers that don't drain them.
        payload = None if method == "GET" else json.dumps(body or {})
        with self._lock:
            try:
                return self._box.roundtrip(method, path, payload, headers)
            finally:
                if not self.persistent:
                    self._box.close()

    def close(self) -> None:
        with self._lock:
            self._box.close()


class PooledHttpTransport(Transport):
    """A bounded pool of persistent connections (checkout / checkin).

    One ``PooledHttpTransport`` can be shared by many worker threads:
    each request checks a connection out of the pool (blocking when all
    ``pool_size`` sockets are in flight), so concurrent callers use
    distinct sockets instead of serializing on one.  Checked-in sockets
    stay open — the steady state is ``pool_size`` keep-alive
    connections, matching the event-loop frontend's cheap-connection
    model.  Stale-socket recovery is per connection, identical to
    ``HttpTransport``.
    """

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 pool_size: int = 4):
        if pool_size < 1:
            raise ValueError(f"pool_size must be >= 1, got {pool_size}")
        self.host, self.port, self.timeout = host, int(port), timeout
        self.pool_size = int(pool_size)
        self._closed = False
        # LIFO: reuse the warmest socket first, idle ones age out server-side
        self._pool: queue.LifoQueue = queue.LifoQueue()
        for _ in range(self.pool_size):
            self._pool.put(_PersistentConnection(host, int(port), timeout))

    @classmethod
    def from_url(cls, url: str, timeout: float = 30.0,
                 pool_size: int = 4) -> "PooledHttpTransport":
        host, port = _split_url(url)
        return cls(host, port, timeout, pool_size=pool_size)

    def request_full(self, method, path, body=None, headers=None):
        payload = None if method == "GET" else json.dumps(body or {})
        box = self._pool.get()
        try:
            return box.roundtrip(method, path, payload, headers)
        finally:
            if self._closed:       # closed mid-flight: don't re-pool open
                box.close()
            self._pool.put(box)

    def close(self) -> None:
        """Close every pooled socket.  Idle boxes close here; a box
        checked out mid-request closes on checkin (its response still
        completes first).  The transport keeps working after close(),
        but in connection-per-request mode — nothing persistent can
        outlive a close()."""
        self._closed = True
        drained = []
        while True:
            try:
                drained.append(self._pool.get_nowait())
            except queue.Empty:
                break
        for box in drained:
            box.close()
            self._pool.put(box)


def _split_url(url: str) -> tuple[str, int]:
    url = url.replace("http://", "")
    host, _, port = url.partition(":")
    return host, int(port or 80)
