"""Multi-process shard fabric: a consistent-hash worker pool behind the
event-loop frontend.

The paper deploys Hopaas as "a scalable set of Uvicorn instances behind
NGINX" (sec. 3).  One Python process is held back by the GIL, so this
module spreads the study shards across N *worker processes*, extending
the frontend's crc32 study-key lane dispatch across the process
boundary.  Every worker runs its TPE and GP samplers on the fabric's
torch device (``device=``, CUDA unless the caller asks for the CPU),
resolved once in the parent and passed to each child as ``--device``;
the router process itself builds no server and touches no device:

* **Workers** — each worker process runs its own ``EventLoopFrontend``
  + ``HopaasServer`` over a consistent-hash slice of the study shards,
  with a *private* durable WAL directory (``root/worker-<id>``, guarded
  by an exclusive flock so two processes can never share a segment
  stream).
* **Router** — the parent process fronts the fleet with a dispatcher
  plugged into the event-loop frontend: each request is classified to
  its study key (URL, trial uid, or study-spec content hash), mapped to
  the owning worker through a consistent-hash ring, and proxied as raw
  bytes over a per-lane persistent upstream connection.  Requests for
  one study always flow through one lane to one worker, so the
  per-study ordering the single-process frontend guaranteed survives
  the process split.  Study lists scatter-gather across the fleet;
  ``tell_batch`` bodies are split by owner and merged back in order.
  Where the platform offers ``SO_REUSEPORT`` the workers can accept on
  the public port directly (``reuseport=True``) — every worker runs the
  same dispatcher, so a connection landing on a non-owner is forwarded
  one hop to the owner; the router's byte-level proxy remains the
  portable fallback accept point on the same port.
* **Shard handoff** (rebalance on worker join/leave) — the owning
  worker freezes the shard (requests get a retryable 503
  ``shard_migrating`` under the shard lock, so nothing mutates after
  the cut), seals its WAL, and ships snapshot + sealed segments to the
  new owner, which filter-replays the shard's records into a shadow
  store and adopts it only if ``InMemoryStorage.shard_digest`` matches
  the exporter's — index-identical or no cutover.  Traffic flips via a
  per-key override pushed to every routing table before the old owner
  drops the shard, so no request ever lands on a missing shard.
* **Crash respawn** — a monitor thread respawns dead workers on their
  own WAL directory (digest-verified recovery via the WAL), re-pushes
  the endpoint table, and sweeps lapsed leases so trials leased through
  the dead worker are requeued.  A worker that hangs mid-request trips
  the proxy's per-upstream timeout and the client sees a retryable 502
  ``bad_upstream`` instead of a hung router.
* **Replication + failover** (``replicas > 0``, durable storage) —
  every leader worker publishes its WAL stream through a
  ``ReplicationHub``; per-leader follower processes subscribe with a
  ``ReplicationClient`` and continuously replay the stream into their
  own journaled store (``--replication semisync`` makes the leader's
  fsync ack additionally wait for a follower ack).  When the monitor
  declares a leader dead (process exit) or hung (control-plane pings
  failing for ``hang_grace`` seconds), it promotes the most-caught-up
  follower: the follower replays the dead leader's WAL directory
  read-only as the digest authority, reconciles, bumps the lease
  epoch, and takes over the dead leader's ring id — the routing
  tables flip workers-first, so placement never changes.  A deposed
  leader that comes back is *fenced*: the monitor delivers the new
  epoch and every data-plane request it would serve answers a
  retryable 409 ``shard_failover``.

``ShardFabric(workers=1, replicas=0)`` collapses to the plain
single-process event-loop service (no children, no proxy hop), so N=1
is exactly the single-process service.
"""
from __future__ import annotations

import bisect
import contextlib
import http.client
import json
import logging
import os
import select
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import zlib
from typing import Any

from . import faults
from .aio import (EventLoopFrontend, _encode_body, _encode_response,
                  _study_key_of_target)
from .api.errors import error_payload
from .auth import AuthError, TokenManager, bearer_token
from .durable import DurableStorage
from .kernels import resolve_device
from .replication import (ReplicationClient, ReplicationHub,
                          recover_dir_state, reconcile_with)
from .server import HopaasServer
from .storage import InMemoryStorage, record_study_key

logger = logging.getLogger("repro_torch.fabric")

_HOP_HEADER = "X-Fabric-Hop"
_SCOPE_HEADER = "X-Fabric-Scope"
_MAX_HOPS = 2
_GATHER_PAGE = 500                     # upstream page size for scatters


# --------------------------------------------------------------------- #
# consistent-hash ring
# --------------------------------------------------------------------- #
class HashRing:
    """Consistent-hash ring over integer worker ids with virtual nodes.

    Key placement is a pure function of the *live id set*: adding a
    worker remaps only the keys the new worker takes over, removing one
    remaps only the keys it owned — the property that keeps a rebalance
    proportional to 1/N of the studies instead of a full reshuffle.
    crc32 is used for both vnode points and keys so every process
    (router, workers, clients) computes identical placement.
    """

    def __init__(self, worker_ids, replicas: int = 64):
        self.worker_ids = sorted(set(int(w) for w in worker_ids))
        if not self.worker_ids:
            raise ValueError("HashRing needs at least one worker id")
        self.replicas = max(1, int(replicas))
        points: list[tuple[int, int]] = []
        for wid in self.worker_ids:
            for v in range(self.replicas):
                h = zlib.crc32(f"fabric-{wid}#{v}".encode()) & 0xFFFFFFFF
                points.append((h, wid))
        points.sort()
        self._points = [p for p, _ in points]
        self._owners = [w for _, w in points]

    def owner(self, key: str) -> int:
        h = zlib.crc32(key.encode()) & 0xFFFFFFFF
        i = bisect.bisect_right(self._points, h) % len(self._points)
        return self._owners[i]


class RouteTable:
    """Mutable routing state shared by one dispatcher: worker endpoints,
    the ring membership, and per-key overrides (the cutover mechanism —
    during a handoff the override flips one study to its new owner
    before the ring itself moves)."""

    def __init__(self, endpoints: dict[int, tuple[str, int]] | None = None,
                 self_id: int | None = None, replicas: int = 64):
        self._lock = threading.Lock()
        self.self_id = self_id
        self.replicas = int(replicas)
        self._endpoints: dict[int, tuple[str, int]] = dict(endpoints or {})
        self._ring_ids: list[int] = sorted(self._endpoints)
        self._ring = (HashRing(self._ring_ids, replicas)
                      if self._ring_ids else None)
        self._overrides: dict[str, int] = {}

    def update(self, endpoints: dict[int, tuple[str, int]] | None = None,
               ring_ids: list[int] | None = None,
               overrides: dict[str, int] | None = None,
               clear_overrides: bool = False) -> None:
        with self._lock:
            if endpoints is not None:
                self._endpoints = dict(endpoints)
            if ring_ids is not None:
                self._ring_ids = sorted(set(int(w) for w in ring_ids))
            elif endpoints is not None and self._ring is None:
                self._ring_ids = sorted(self._endpoints)
            if self._ring_ids:
                self._ring = HashRing(self._ring_ids, self.replicas)
            if clear_overrides:
                self._overrides = {}
            if overrides:
                self._overrides.update(
                    {str(k): int(v) for k, v in overrides.items()})

    def owner(self, key: str) -> int:
        with self._lock:
            wid = self._overrides.get(key)
            if wid is not None:
                return wid
            if self._ring is None:
                raise RuntimeError("routing table has no workers")
            return self._ring.owner(key)

    def default_owner(self) -> int:
        with self._lock:
            if not self._ring_ids:
                raise RuntimeError("routing table has no workers")
            return self._ring_ids[0]

    def worker_ids(self) -> list[int]:
        with self._lock:
            return list(self._ring_ids)

    def n_workers(self) -> int:
        with self._lock:
            return len(self._ring_ids)

    def endpoint(self, wid: int) -> tuple[str, int]:
        with self._lock:
            return self._endpoints[wid]

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {
                "endpoints": {str(w): list(ep)
                              for w, ep in self._endpoints.items()},
                "ring_ids": list(self._ring_ids),
                "overrides": dict(self._overrides),
            }


# --------------------------------------------------------------------- #
# request classification (shared by dispatcher + worker freeze gate)
# --------------------------------------------------------------------- #
def classify_target(method: str, target: str) -> tuple:
    """Route class of one request: ("key", k) for URL-keyed paths,
    ("spec",) when the study key is the content hash of the body's
    study spec, ("uid",) when it is derived from a trial uid in the
    body, ("tell_batch",) / ("gather",) for the scatter endpoints, and
    ("default",) for everything keyless."""
    path = target.partition("?")[0]
    key = _study_key_of_target(path)
    if key is not None:
        return ("key", key)
    if path == "/api/v2/trials:tell_batch":
        return ("tell_batch",) if method == "POST" else ("default",)
    if path == "/api/v2/studies":
        if method == "POST":
            return ("spec",)
        if method in ("GET", "HEAD"):
            return ("gather",)
        return ("default",)
    parts = path.split("/")
    if len(parts) == 4 and parts[0] == "" and parts[1] == "api":
        op = parts[2]
        if op in ("ask", "ask_batch"):
            return ("spec",) if method == "POST" else ("default",)
        if op in ("tell", "should_prune"):
            return ("uid",) if method == "POST" else ("default",)
        if op == "tell_batch":
            return ("tell_batch",) if method == "POST" else ("default",)
        if op == "studies":
            return ("gather",) if method in ("GET", "HEAD") else ("default",)
    return ("default",)


def _key_from_spec(body: Any) -> str | None:
    """Study content key from an ask / create-study body, or None when
    the body cannot produce one (the owning default worker will then
    emit the proper validation error)."""
    if not isinstance(body, dict):
        return None
    try:
        return HopaasServer._study_config(body).key()
    except Exception:
        return None


def _key_from_uid(body: Any) -> str | None:
    if not isinstance(body, dict):
        return None
    uid = body.get("trial_uid")
    if not isinstance(uid, str) or ":" not in uid:
        return None
    return uid.partition(":")[0]


def request_study_keys(method: str, target: str, body: Any) -> list[str]:
    """Concrete study key(s) a request touches — the freeze gate's view.
    Empty list = keyless (never gated)."""
    kind = classify_target(method, target)
    if kind[0] == "key":
        return [kind[1]]
    if kind[0] == "spec":
        key = _key_from_spec(body)
        return [key] if key else []
    if kind[0] == "uid":
        key = _key_from_uid(body)
        return [key] if key else []
    if kind[0] == "tell_batch":
        if not isinstance(body, dict) or not isinstance(body.get("tells"),
                                                        list):
            return []
        keys = []
        for item in body["tells"]:
            key = _key_from_uid(item)
            if key:
                keys.append(key)
        return sorted(set(keys))
    return []


# --------------------------------------------------------------------- #
# upstream proxy connections
# --------------------------------------------------------------------- #
class _UpstreamConn:
    """One blocking keep-alive connection to a worker's data port.  Lane
    threads each own their connections, so per-study request order is
    preserved across the proxy hop (one study -> one lane -> one
    ordered byte stream to one worker)."""

    def __init__(self, host: str, port: int, timeout: float):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        try:
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self._buf = b""

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def roundtrip(self, data: bytes, head: bool = False
                  ) -> tuple[int, list[tuple[str, str]], bytes]:
        self.sock.sendall(data)
        while b"\r\n\r\n" not in self._buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("upstream closed the connection")
            self._buf += chunk
        head_blob, _, rest = self._buf.partition(b"\r\n\r\n")
        lines = head_blob.split(b"\r\n")
        try:
            status = int(lines[0].split(None, 2)[1])
        except (IndexError, ValueError):
            raise ConnectionError("malformed upstream status line")
        headers: list[tuple[str, str]] = []
        clen = 0
        for ln in lines[1:]:
            name, sep, val = ln.partition(b":")
            if not sep:
                continue
            k = name.decode("latin-1").strip()
            v = val.decode("latin-1").strip()
            headers.append((k, v))
            if k.lower() == "content-length":
                try:
                    clen = int(v)
                except ValueError:
                    raise ConnectionError("malformed upstream Content-Length")
        if head:
            # HEAD responses advertise the would-be body length but never
            # send it — waiting on clen bytes would hang the lane
            self._buf = rest
            return status, headers, b""
        while len(rest) < clen:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("upstream closed mid-body")
            rest += chunk
        self._buf = rest[clen:]
        return status, headers, rest[:clen]


# failures that prove the reused idle socket died *before* the request
# was processed — safe to resend once on a fresh connection.  Timeouts
# are deliberately absent: a timed-out request may have been executed.
_RESEND_SAFE = (ConnectionResetError, BrokenPipeError, ConnectionError)

_HOP_BY_HOP = ("connection", "content-length", "content-type")


class FabricDispatcher:
    """The cross-process extension of the frontend's lane dispatch.

    Plugged into ``EventLoopFrontend(dispatcher=...)``: every request is
    offered here first.  Returns encoded response bytes (proxied from
    the owning worker, or a scatter-gather merge), or None when the
    local process owns the study (worker processes run the same
    dispatcher with ``local`` set, so misrouted requests forward one
    hop instead of being served from the wrong shard slice).
    """

    def __init__(self, table: RouteTable, local: Any = None,
                 timeout: float = 10.0):
        self._table = table
        self._local = local               # local request sink (workers)
        self._timeout = float(timeout)
        # lane.idx -> {wid: (endpoint, conn)}; each lane is a single
        # thread, so its connection map needs no lock.  The outer map is
        # only ever extended under _conns_lock via setdefault; the
        # lock-free .get() probe is a GIL-atomic read and a stale miss
        # just retries under the lock.
        self._conns: dict[int, dict[int, tuple[tuple[str, int],  # repro-check: allow(shared-state)
                                               _UpstreamConn]]] = {}
        self._conns_lock = threading.Lock()   # map-of-maps creation only
        # lossy observability counters: concurrent += from lanes may drop
        # an increment, which stats() tolerates by design
        self.proxied = 0  # repro-check: allow(shared-state)
        self.scatters = 0  # repro-check: allow(shared-state)
        self.bad_upstream = 0  # repro-check: allow(shared-state)

    # -- public entry (called by the frontend, lane threads only) ------- #
    def handle(self, lane, method: str, target: str,
               headers: dict[str, str], body_bytes: bytes,
               keep_alive: bool):
        if target.partition("?")[0].startswith("/fabric/"):
            if self._local is not None:
                return None              # worker control plane is local
            blob = _encode_body(error_payload(
                "not_found", "no /fabric control plane on the router"))
            return _encode_response(404, blob, close=not keep_alive,
                                    head_only=method == "HEAD")
        if headers.get(_SCOPE_HEADER) == "local":
            return None                  # scatter subrequest: no re-fanout
        try:
            hop = int(headers.get(_HOP_HEADER, 0))
        except (TypeError, ValueError):
            hop = 0
        kind = classify_target(method, target)
        single = self._table.n_workers() <= 1
        if kind[0] == "gather" and not single:
            self.scatters += 1
            if target.partition("?")[0] == "/api/v2/studies":
                return self._gather_studies_v2(lane, method, target,
                                               headers, keep_alive)
            return self._gather_studies_v1(lane, method, target, headers,
                                           keep_alive)
        if kind[0] == "tell_batch" and not single:
            self.scatters += 1
            return self._scatter_tell_batch(lane, target, headers,
                                            body_bytes, keep_alive)
        if kind[0] == "key":
            wid = self._owner_or_default(kind[1])
        elif kind[0] == "spec":
            wid = self._owner_or_default(_key_from_spec(
                self._parse_body(body_bytes)))
        elif kind[0] == "uid":
            wid = self._owner_or_default(_key_from_uid(
                self._parse_body(body_bytes)))
        else:
            wid = self._table.default_owner()
        if wid == self._table.self_id:
            return None
        if hop >= _MAX_HOPS and self._local is not None:
            # routing tables disagree mid-update: stop the ping-pong and
            # answer from here; the freeze gate still protects migrating
            # shards with a retryable 503
            return None
        self.proxied += 1
        return self._forward(lane, wid, method, target, headers,
                             body_bytes, keep_alive, hop + 1)

    def close(self) -> None:
        with self._conns_lock:
            lanes = list(self._conns.values())
            self._conns = {}
        for conns in lanes:
            for _ep, conn in conns.values():
                conn.close()

    def stats(self) -> dict[str, Any]:
        return {"proxied": self.proxied, "scatters": self.scatters,
                "bad_upstream": self.bad_upstream,
                "workers": self._table.n_workers()}

    # -- internals ------------------------------------------------------ #
    @staticmethod
    def _parse_body(body_bytes: bytes) -> Any:
        if not body_bytes:
            return None
        try:
            return json.loads(body_bytes)
        except ValueError:
            return None

    def _owner_or_default(self, key: str | None) -> int:
        if key is None:
            return self._table.default_owner()
        return self._table.owner(key)

    def _lane_conns(self, lane) -> dict:
        conns = self._conns.get(lane.idx)
        if conns is None:
            with self._conns_lock:
                conns = self._conns.setdefault(lane.idx, {})
        return conns

    @staticmethod
    def _encode_upstream(method: str, target: str, headers: dict[str, str],
                         body: bytes, hop: int,
                         scope_local: bool = False) -> bytes:
        lines = [f"{method} {target} HTTP/1.1"]
        for k, v in headers.items():
            if k.lower() in ("connection", "content-length") \
                    or k in (_HOP_HEADER, _SCOPE_HEADER):
                continue
            lines.append(f"{k}: {v}")
        lines.append(f"{_HOP_HEADER}: {hop}")
        if scope_local:
            lines.append(f"{_SCOPE_HEADER}: local")
        lines.append(f"Content-Length: {len(body)}")
        return ("\r\n".join(lines) + "\r\n\r\n").encode() + body

    def _roundtrip(self, lane, wid: int, data: bytes, head: bool = False
                   ) -> tuple[int, list[tuple[str, str]], bytes]:
        conns = self._lane_conns(lane)
        ep = self._table.endpoint(wid)
        entry = conns.get(wid)
        conn: _UpstreamConn | None = None
        reused = False
        if entry is not None:
            if entry[0] == ep:
                conn, reused = entry[1], True
            else:
                entry[1].close()         # worker respawned on a new port
                conns.pop(wid, None)
        for attempt in (0, 1):
            if conn is None:
                conn = _UpstreamConn(ep[0], ep[1], self._timeout)
                conns[wid] = (ep, conn)
                reused = False
            try:
                return conn.roundtrip(data, head=head)
            except _RESEND_SAFE:
                conn.close()
                conns.pop(wid, None)
                conn = None
                if reused and attempt == 0:
                    continue             # idle keep-alive died: one resend
                raise
            except Exception:
                conn.close()
                conns.pop(wid, None)
                raise
        raise ConnectionError("unreachable")

    def _forward(self, lane, wid: int, method: str, target: str,
                 headers: dict[str, str], body: bytes, keep_alive: bool,
                 hop: int) -> bytes:
        head_only = method == "HEAD"
        data = self._encode_upstream(method, target, headers, body, hop)
        try:
            status, up_headers, up_body = self._roundtrip(lane, wid, data,
                                                          head=head_only)
        except Exception as e:
            self.bad_upstream += 1
            blob = _encode_body(error_payload(
                "bad_upstream",
                f"worker {wid} did not answer: {type(e).__name__}: {e}"))
            return _encode_response(502, blob, close=not keep_alive,
                                    head_only=head_only)
        extras = {k: v for k, v in up_headers
                  if k.lower() not in _HOP_BY_HOP}
        if head_only:
            # relay the upstream's advertised length: the encoder frames
            # Content-Length from len(blob), and head_only drops the bytes
            clen = next((int(v) for k, v in up_headers
                         if k.lower() == "content-length"), 0)
            up_body = b"\x00" * clen
        return _encode_response(status, up_body, extras or None,
                                close=not keep_alive, head_only=head_only)

    def _sub_request(self, lane, wid: int, method: str, target: str,
                     headers: dict[str, str], body: Any
                     ) -> tuple[int, Any]:
        """One scatter subrequest: local direct call when this process
        owns ``wid``, else a scope-local proxied exchange (the receiver
        must not fan out again)."""
        if wid == self._table.self_id and self._local is not None:
            status, payload, _extra = self._local.handle_request(
                method, target, body, headers, None)
            return status, payload
        blob = b"" if body is None else _encode_body(body)
        data = self._encode_upstream(method, target, headers, blob,
                                     hop=_MAX_HOPS, scope_local=True)
        status, _up_headers, up_body = self._roundtrip(lane, wid, data)
        try:
            payload = json.loads(up_body) if up_body else {}
        except ValueError:
            raise ConnectionError("non-JSON scatter subresponse")
        return status, payload

    def _relay(self, status: int, payload: Any, keep_alive: bool,
               head_only: bool = False) -> bytes:
        return _encode_response(status, _encode_body(payload),
                                close=not keep_alive, head_only=head_only)

    def _upstream_error(self, wid: int, e: Exception,
                        keep_alive: bool) -> bytes:
        self.bad_upstream += 1
        blob = _encode_body(error_payload(
            "bad_upstream",
            f"worker {wid} did not answer: {type(e).__name__}: {e}"))
        return _encode_response(502, blob, close=not keep_alive)

    def _gather_studies_v2(self, lane, method: str, target: str,
                           headers: dict[str, str],
                           keep_alive: bool) -> bytes:
        head_only = method == "HEAD"
        try:
            limit, cursor = _parse_page_query(target.partition("?")[2])
        except ValueError:
            # invalid paging params: let the default worker's router
            # produce the canonical 422
            return self._forward(lane, self._table.default_owner(), method,
                                 target, headers, b"", keep_alive, 1)
        merged: list[dict] = []
        seen: set[str] = set()
        for wid in self._table.worker_ids():
            cur: int | None = None
            while True:
                t = f"/api/v2/studies?limit={_GATHER_PAGE}"
                if cur is not None:
                    t += f"&cursor={cur}"
                try:
                    status, payload = self._sub_request(lane, wid, "GET", t,
                                                        headers, None)
                except Exception as e:
                    return self._upstream_error(wid, e, keep_alive)
                if status != 200:
                    return self._relay(status, payload, keep_alive,
                                       head_only)
                for s in payload.get("studies", []):
                    k = s.get("key")
                    if k not in seen:
                        seen.add(k)
                        merged.append(s)
                cur = payload.get("next_cursor")
                if cur is None:
                    break
        start = 0 if cursor is None else cursor + 1
        page = merged[start:start + limit]
        next_cursor = (start + len(page) - 1) if len(page) == limit else None
        return self._relay(200, {"studies": page,
                                 "next_cursor": next_cursor},
                           keep_alive, head_only)

    def _gather_studies_v1(self, lane, method: str, target: str,
                           headers: dict[str, str],
                           keep_alive: bool) -> bytes:
        head_only = method == "HEAD"
        merged: list[dict] = []
        seen: set[str] = set()
        for wid in self._table.worker_ids():
            try:
                status, payload = self._sub_request(lane, wid, "GET", target,
                                                    headers, None)
            except Exception as e:
                return self._upstream_error(wid, e, keep_alive)
            if status != 200:
                return self._relay(status, payload, keep_alive, head_only)
            for s in payload.get("studies", []):
                k = s.get("key")
                if k not in seen:
                    seen.add(k)
                    merged.append(s)
        return self._relay(200, {"studies": merged}, keep_alive, head_only)

    def _scatter_tell_batch(self, lane, target: str,
                            headers: dict[str, str], body_bytes: bytes,
                            keep_alive: bool) -> bytes:
        body = self._parse_body(body_bytes)
        if not isinstance(body, dict) or not isinstance(body.get("tells"),
                                                        list):
            # malformed: the default worker produces the canonical error
            return self._forward(lane, self._table.default_owner(), "POST",
                                 target, headers, body_bytes, keep_alive, 1)
        tells = body["tells"]
        groups: dict[int, list[tuple[int, Any]]] = {}
        for i, item in enumerate(tells):
            key = _key_from_uid(item)
            wid = self._owner_or_default(key)
            groups.setdefault(wid, []).append((i, item))
        results: list[Any] = [None] * len(tells)
        for wid, items in groups.items():
            sub = dict(body)
            sub["tells"] = [item for _i, item in items]
            try:
                status, payload = self._sub_request(lane, wid, "POST",
                                                    target, headers, sub)
            except Exception as e:
                return self._upstream_error(wid, e, keep_alive)
            if status != 200:
                # whole-batch failure (auth / schema): relay it verbatim;
                # other owner groups may already have executed — their
                # retried items answer 409 per item, never double-count
                return self._relay(status, payload, keep_alive)
            sub_results = payload.get("results", [])
            for (i, _item), r in zip(items, sub_results):
                results[i] = r
        return self._relay(200, {"results": results}, keep_alive)


def _parse_page_query(query: str) -> tuple[int, int | None]:
    """``limit``/``cursor`` of a studies-list query with the router's
    bounds; raises ValueError on anything the router would 422."""
    import urllib.parse
    limit, cursor = 100, None
    for k, vals in urllib.parse.parse_qs(query,
                                         keep_blank_values=True).items():
        if k == "limit":
            limit = int(vals[-1])
            if not 1 <= limit <= 500:
                raise ValueError(f"limit out of range: {limit}")
        elif k == "cursor":
            cursor = int(vals[-1])
            if cursor < 0:
                raise ValueError(f"cursor out of range: {cursor}")
    return limit, cursor


# --------------------------------------------------------------------- #
# worker-process server wrapper: freeze gate + /fabric control plane
# --------------------------------------------------------------------- #
class FabricWorkerServer:
    """Wraps one ``HopaasServer`` for a fabric worker process.

    Adds the migration *freeze gate* — while a shard is being exported,
    every request touching it answers a retryable 503
    ``shard_migrating`` (the check runs under the shard lock, so a
    request that passed the gate finishes before the export reads the
    shard) — and the ``/fabric/*`` control plane (freeze / export /
    import / drop / ring / sweep / digest), authenticated with the same
    HMAC bearer tokens as the data plane.
    """

    def __init__(self, server: HopaasServer, worker_id: int = 0):
        self.server = server
        self.storage = server.storage
        self.tokens = server.tokens
        self.worker_id = int(worker_id)
        self.table: RouteTable | None = None     # attached by the host
        self._gate_lock = threading.Lock()
        self._frozen: set[str] = set()
        self._moved: set[str] = set()
        # replication / failover state (wired up by _serve_worker)
        self.role = "leader"
        self.fenced = False
        self.fence_epoch: int | None = None
        self.replication_mode = "async"
        self.hub: ReplicationHub | None = None
        self.repl_client: ReplicationClient | None = None

    @property
    def epoch(self) -> int:
        return int(getattr(self.storage, "lease_epoch", 0))

    # -- wire entry ----------------------------------------------------- #
    def handle_request(self, method: str, path: str, body: Any = None,
                       headers: dict[str, str] | None = None,
                       body_error: str | None = None
                       ) -> tuple[int, dict[str, Any], dict[str, str]]:
        if path.partition("?")[0].startswith("/fabric/"):
            return self._control(method, path.partition("?")[0], body,
                                 headers or {})
        gated = self._role_gate(method, path)
        if gated is not None:
            return gated
        keys = request_study_keys(method, path, body)
        if not keys:
            return self.server.handle_request(method, path, body, headers,
                                              body_error)
        with self._gate_lock:
            blocked = any(k in self._frozen or k in self._moved
                          for k in keys)
        if blocked:
            return self._migrating(keys)
        # hold every touched shard lock (sorted — same order as the
        # freeze path) across the whole dispatch: a freeze that lands
        # after this gate check waits for the request to finish, so the
        # exported shard always contains it
        with contextlib.ExitStack() as stack:
            for k in keys:
                try:
                    stack.enter_context(self.storage.study_lock(k))
                except KeyError:
                    continue             # study not created here (yet)
            with self._gate_lock:
                blocked = any(k in self._frozen or k in self._moved
                              for k in keys)
            if blocked:
                return self._migrating(keys)
            return self.server.handle_request(method, path, body, headers,
                                              body_error)

    def _role_gate(self, method: str, path: str
                   ) -> tuple[int, dict[str, Any], dict[str, str]] | None:
        """Data-plane admission by replication role.  Followers and
        fenced ex-leaders answer a retryable 409 ``shard_failover`` —
        the client's retry lands on the current leader once the routing
        tables flip.  Health and version probes stay answerable from
        any role (that is how lag is observed)."""
        if self.role == "leader" and not self.fenced:
            return None
        p = path.partition("?")[0]
        if method in ("GET", "HEAD") and p in ("/api/v2/health",
                                               "/api/v2/version"):
            return None
        if self.fenced:
            msg = (f"worker {self.worker_id} was deposed: lease epoch "
                   f"{self.epoch} is fenced by epoch {self.fence_epoch}; "
                   "retry against the current leader")
        else:
            msg = (f"worker {self.worker_id} is a replication follower "
                   "(read-only replica); retry against the leader")
        return 409, error_payload("shard_failover", msg), {
            "Retry-After": "0.1"}

    def health_extra(self) -> dict[str, Any]:
        """``HopaasServer.health_hook``: merge the fabric role, lease
        epoch, and live replication lag into ``GET /api/v2/health``."""
        out: dict[str, Any] = {"epoch": self.epoch}
        if self.fenced:
            out["status"] = "fenced"
            out["role"] = "leader"
        elif self.role != "leader":
            out["status"] = "follower"
            out["role"] = "follower"
        repl: dict[str, Any] = {}
        if self.hub is not None:
            repl["mode"] = self.replication_mode
            repl.update(self.hub.status())
        if self.repl_client is not None:
            repl["client"] = self.repl_client.status()
        if repl:
            out["replication"] = repl
        return out

    @staticmethod
    def _migrating(keys: list[str]
                   ) -> tuple[int, dict[str, Any], dict[str, str]]:
        payload = error_payload(
            "shard_migrating",
            f"stud{'ies' if len(keys) > 1 else 'y'} "
            f"{', '.join(keys)} is being rebalanced; retry")
        return 503, payload, {"Retry-After": "0.1"}

    # -- control plane -------------------------------------------------- #
    def _control(self, method: str, path: str, body: Any,
                 headers: dict[str, str]
                 ) -> tuple[int, dict[str, Any], dict[str, str]]:
        token = bearer_token(headers)
        if token is None:
            return 401, error_payload("unauthorized",
                                      "control plane needs a bearer "
                                      "token"), {}
        try:
            self.tokens.verify(token)
        except AuthError as e:
            return 401, error_payload("unauthorized", str(e)), {}
        body = body if isinstance(body, dict) else {}
        try:
            op = path[len("/fabric/"):]
            if op == "ping":
                return 200, {"ok": True, "worker": self.worker_id,
                             "pid": os.getpid()}, {}
            if op == "digest":
                return 200, {"digest": self.storage.state_digest()}, {}
            if op == "studies":
                return 200, {"keys": sorted(
                    s.key for s in self.storage.studies())}, {}
            if op == "stats":
                with self._gate_lock:
                    frozen = sorted(self._frozen)
                return 200, {"worker": self.worker_id, "pid": os.getpid(),
                             "frozen": frozen,
                             "storage": self.storage.storage_stats()}, {}
            if op == "shard_digest":
                digest = self.storage.shard_digest(str(body.get(
                    "study_key", "")))
                if digest is None:
                    return 404, error_payload("study_not_found",
                                              "unknown study"), {}
                return 200, {"digest": digest}, {}
            if op == "freeze":
                return self._op_freeze(str(body.get("study_key", "")))
            if op == "unfreeze":
                key = str(body.get("study_key", ""))
                with self._gate_lock:
                    self._frozen.discard(key)
                return 200, {"frozen": False}, {}
            if op == "export":
                return self._op_export(str(body.get("study_key", "")))
            if op == "import":
                return self._op_import(body)
            if op == "drop":
                return self._op_drop(str(body.get("study_key", "")))
            if op == "ring":
                return self._op_ring(body)
            if op == "sweep":
                if self.role != "leader":
                    # a follower's state is whatever the stream says —
                    # expiring leases locally would diverge from the WAL
                    return 200, {"expired": 0, "suppressed": True}, {}
                return 200, {"expired": self.server.sweep_expired()}, {}
            if op == "replication":
                return 200, self._replication_status(), {}
            if op == "promote":
                return self._op_promote(body)
            if op == "fence":
                return self._op_fence(body)
            return 404, error_payload("not_found",
                                      f"unknown control op {op!r}"), {}
        except Exception as e:          # control bugs must not kill the gate
            logger.exception("control op %s failed", path)
            return 500, error_payload(
                "internal", f"{type(e).__name__}: {e}"), {}

    def _op_freeze(self, key: str
                   ) -> tuple[int, dict[str, Any], dict[str, str]]:
        try:
            lock = self.storage.study_lock(key)
        except KeyError:
            return 404, error_payload("study_not_found",
                                      f"unknown study {key!r}"), {}
        # taking the shard lock fences out every in-flight request that
        # already passed the gate; once we hold it, the freeze flag is
        # visible before any further mutation can start
        with lock:
            with self._gate_lock:
                self._frozen.add(key)
        return 200, {"frozen": True}, {}

    def _op_export(self, key: str
                   ) -> tuple[int, dict[str, Any], dict[str, str]]:
        with self._gate_lock:
            if key not in self._frozen:
                return 409, error_payload(
                    "not_frozen", f"study {key!r} must be frozen before "
                    "export"), {}
        lock = self.storage.study_lock(key)
        with lock:
            digest = self.storage.shard_digest(key)
            if isinstance(self.storage, DurableStorage):
                # seal the WAL so every acknowledged record of this shard
                # lives in an immutable file, then ship snapshot+segments
                # (the importer filter-replays just this study's records)
                self.storage.seal_active()
                files = self.storage.read_immutable_files()
                return 200, {"study_key": key, "digest": digest,
                             "snapshot": files["snapshot"],
                             "segments": files["segments"]}, {}
            return 200, {"study_key": key, "digest": digest,
                         "record": self.storage.shard_record(key)}, {}

    def _op_import(self, body: dict[str, Any]
                   ) -> tuple[int, dict[str, Any], dict[str, str]]:
        key = str(body.get("study_key", ""))
        want = body.get("digest")
        if self.storage.get_study(key) is not None:
            return 409, error_payload(
                "shard_exists", f"study {key!r} is already owned here"), {}
        shadow = InMemoryStorage()
        if body.get("record") is not None:
            shadow._restore_shard(body["record"])
        else:
            _filter_replay(shadow, key, body.get("snapshot"),
                           body.get("segments") or [])
        got = shadow.shard_digest(key)
        if got is None:
            return 404, error_payload(
                "study_not_found",
                f"study {key!r} not present in the shipped files"), {}
        if want is not None and got != want:
            return 409, error_payload(
                "digest_mismatch",
                f"migrated shard digest {got} != exporter digest "
                f"{want}"), {}
        self.storage.adopt_shard(shadow.shard_record(key))
        self.server.evict_context(key)
        with self._gate_lock:
            self._frozen.discard(key)
            self._moved.discard(key)
        return 200, {"adopted": True, "digest": got}, {}

    def _op_drop(self, key: str
                 ) -> tuple[int, dict[str, Any], dict[str, str]]:
        # mark moved *before* removing the shard: a request arriving in
        # between answers a retryable 503 instead of recreating the
        # study locally
        with self._gate_lock:
            self._moved.add(key)
            self._frozen.discard(key)
        dropped = self.storage.drop_shard(key)
        self.server.evict_context(key)
        return 200, {"dropped": dropped}, {}

    def _op_ring(self, body: dict[str, Any]
                 ) -> tuple[int, dict[str, Any], dict[str, str]]:
        if self.table is None:
            return 409, error_payload("no_table",
                                      "worker has no routing table"), {}
        endpoints = None
        if isinstance(body.get("endpoints"), dict):
            endpoints = {int(w): (ep[0], int(ep[1]))
                         for w, ep in body["endpoints"].items()}
        ring_ids = body.get("ring_ids")
        overrides = body.get("overrides") or None
        self.table.update(endpoints=endpoints,
                          ring_ids=ring_ids,
                          overrides=overrides,
                          clear_overrides=bool(body.get("clear_overrides")))
        return 200, {"table": self.table.snapshot()}, {}

    # -- replication control ops ---------------------------------------- #
    def _replication_status(self) -> dict[str, Any]:
        out: dict[str, Any] = {"worker": self.worker_id, "pid": os.getpid(),
                               "role": self.role, "epoch": self.epoch,
                               "fenced": self.fenced}
        if self.hub is not None:
            out["mode"] = self.replication_mode
            out["hub"] = self.hub.status()
        if self.repl_client is not None:
            out["client"] = self.repl_client.status()
        out["speculation"] = self.server.speculation_stats()
        return out

    def _op_promote(self, body: dict[str, Any]
                    ) -> tuple[int, dict[str, Any], dict[str, str]]:
        """Become the leader at ``epoch``: stop following, replay the
        dead leader's WAL directory read-only as the digest authority,
        reconcile to it through journaled drop/adopt, journal the new
        lease epoch, and open the data plane."""
        epoch = int(body.get("epoch", 0))
        if epoch <= self.epoch:
            return 409, error_payload(
                "stale_epoch",
                f"promotion epoch {epoch} is not newer than the current "
                f"lease epoch {self.epoch}"), {}
        if self.repl_client is not None:
            self.repl_client.stop()
        out: dict[str, Any] = {"promoted": True, "epoch": epoch,
                               "worker": self.worker_id}
        leader_root = body.get("leader_root")
        if leader_root:
            # the dead leader's disk is a superset of every acked write
            # (flush precedes publish; the page cache survives SIGKILL),
            # so it is the authority the promoted state must match
            authority, recovery = recover_dir_state(str(leader_root))
            out["recovery"] = recovery
            out["reconcile"] = reconcile_with(self.storage, authority)
            out["digest_match"] = out["reconcile"]["digest_match"]
        self.storage.note_lease(epoch)
        if self.hub is not None:
            # the leader write path now waits on *this* hub's followers
            self.storage.attach_replicator(
                self.hub, semisync=self.replication_mode == "semisync")
        # sampler/pruner contexts built from a partially-replayed view
        # must be rebuilt from the reconciled trials
        for study in list(self.storage.studies()):
            self.server.evict_context(study.key)
        self.role = "leader"
        self.fenced = False
        self.fence_epoch = None
        faults.set_context(role="leader")
        out["digest"] = self.storage.state_digest()
        return 200, out, {}

    def _op_fence(self, body: dict[str, Any]
                  ) -> tuple[int, dict[str, Any], dict[str, str]]:
        epoch = int(body.get("epoch", 0))
        if epoch <= self.epoch:
            return 409, error_payload(
                "stale_epoch",
                f"fence epoch {epoch} is not newer than the current "
                f"lease epoch {self.epoch}"), {}
        self.fence_epoch = epoch
        self.fenced = True
        return 200, {"fenced": True, "epoch": epoch}, {}


def _filter_replay(shadow: InMemoryStorage, key: str,
                   snapshot_text: str | None,
                   segment_texts: list[str]) -> None:
    """Rebuild one study's shard inside ``shadow`` from a shipped
    snapshot + sealed segments, replaying only the records that belong
    to ``key`` (both files interleave every study the exporter owns)."""
    if snapshot_text:
        snap = json.loads(snapshot_text)
        for srec in snap["state"]["studies"]:
            if srec["key"] == key:
                shadow._restore_shard(srec)
    for text in segment_texts:
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if record_study_key(rec) == key:
                shadow._apply(rec)


# --------------------------------------------------------------------- #
# worker process entry point
# --------------------------------------------------------------------- #
def _serve_worker(args) -> int:
    faults.load_from_env()
    role = "follower" if args.follow else "leader"
    faults.set_context(worker=args.worker_id, role=role)
    if args.storage == "durable":
        storage: InMemoryStorage = DurableStorage(
            args.root, fsync=args.fsync, segment_bytes=args.segment_bytes)
    else:
        storage = InMemoryStorage()
    if role == "leader" and args.epoch > storage.lease_epoch:
        storage.note_lease(args.epoch)
    hub = None
    if args.repl_listen and args.storage == "durable":
        hub = ReplicationHub(storage)
        storage.attach_replicator(
            hub, semisync=(role == "leader"
                           and args.replication == "semisync"))
    secret = os.environ.get("REPRO_FABRIC_SECRET", "hopaas-secret")
    tokens = TokenManager(secret)
    server = HopaasServer(storage=storage, tokens=tokens,
                          lease_seconds=args.lease_seconds, seed=args.seed,
                          worker_name=f"fabric-{args.worker_id}",
                          device=args.device)
    worker = FabricWorkerServer(server, worker_id=args.worker_id)
    worker.role = role
    worker.replication_mode = args.replication
    worker.hub = hub
    server.health_hook = worker.health_extra
    repl_client = None
    if args.follow:
        fhost, _, fport = args.follow.rpartition(":")
        follower_id = (os.path.basename(args.root) if args.root
                       else f"worker-{args.worker_id}-f{os.getpid()}")
        repl_client = ReplicationClient(storage, (fhost, int(fport)),
                                        follower_id=follower_id)
        worker.repl_client = repl_client
        repl_client.start()
    table = RouteTable({args.worker_id: (args.host, 0)},
                       self_id=args.worker_id)
    worker.table = table
    dispatcher = FabricDispatcher(table, local=worker,
                                  timeout=args.upstream_timeout)
    frontend = EventLoopFrontend(
        [worker], host=args.host, port=0, lanes=args.lanes,
        dispatcher=dispatcher,
        extra_port=args.reuseport_port if args.reuseport_port else None)
    frontend.start()
    stop_event = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_a: stop_event.set())
    ready = {"worker": args.worker_id, "port": frontend.port,
             "pid": os.getpid(), "digest": storage.state_digest(),
             "recovery": getattr(storage, "last_recovery", None),
             "role": role, "epoch": storage.lease_epoch,
             "repl_port": hub.port if hub is not None else None}
    sys.stdout.write(json.dumps(ready) + "\n")
    sys.stdout.flush()
    stop_event.wait()
    frontend.stop()
    dispatcher.close()
    if repl_client is not None:
        repl_client.stop()
    if hub is not None:
        hub.stop()
    storage.close()
    return 0


def main(argv: list[str] | None = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="repro_torch.core.fabric")
    ap.add_argument("--serve-worker", action="store_true")
    ap.add_argument("--worker-id", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--root", default=None)
    ap.add_argument("--storage", choices=("durable", "memory"),
                    default="durable")
    ap.add_argument("--fsync", choices=("always", "group", "off"),
                    default="off")
    ap.add_argument("--segment-bytes", type=int, default=4 * 1024 * 1024)
    ap.add_argument("--lease-seconds", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lanes", type=int, default=None)
    ap.add_argument("--upstream-timeout", type=float, default=10.0)
    ap.add_argument("--reuseport-port", type=int, default=0)
    ap.add_argument("--epoch", type=int, default=0,
                    help="initial leader lease epoch (journaled if newer "
                         "than the recovered one)")
    ap.add_argument("--follow", default=None, metavar="HOST:PORT",
                    help="run as a follower replicating from this "
                         "leader's replication hub")
    ap.add_argument("--replication", choices=("async", "semisync"),
                    default="async")
    ap.add_argument("--repl-listen", action="store_true",
                    help="serve a replication hub (durable storage only)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the worker's TPE and GP samplers "
                         "compute on (default: cuda; the worker fails to "
                         "start if there is no CUDA device)")
    args = ap.parse_args(argv)
    if not args.serve_worker:
        ap.error("only --serve-worker mode is supported")
    if args.storage == "durable" and not args.root:
        ap.error("--root is required for durable storage")
    return _serve_worker(args)


# --------------------------------------------------------------------- #
# the fabric: spawn, route, rebalance, respawn
# --------------------------------------------------------------------- #
def _merge_speculation(entries: list[dict[str, Any]]) -> dict[str, Any]:
    """Sum per-worker speculative-ask counters into one fleet block.

    Each worker's ``/fabric/replication`` payload carries the
    ``speculation`` dict from ``HopaasServer.speculation_stats()``;
    workers that failed the control ping (or predate the field) simply
    don't contribute."""
    blocks = [e["speculation"] for e in entries
              if isinstance(e.get("speculation"), dict)]
    merged: dict[str, Any] = {
        "enabled": any(b.get("enabled") for b in blocks),
        "workers_reporting": len(blocks)}
    for key in ("hits", "stale_hits", "misses", "published", "rejected",
                "discarded", "queued", "pending_trials", "rounds",
                "errors"):
        merged[key] = sum(int(b.get(key, 0)) for b in blocks)
    return merged


class _WorkerProc:
    __slots__ = ("wid", "proc", "host", "port", "pid", "root", "digest",
                 "recovery", "role", "epoch", "repl_port", "replica_k")

    def __init__(self, wid: int, proc: subprocess.Popen, host: str,
                 port: int, pid: int, root: str | None,
                 digest: str | None, recovery: Any, *,
                 role: str = "leader", epoch: int = 0,
                 repl_port: int | None = None,
                 replica_k: int | None = None):
        self.wid = wid
        self.proc = proc
        self.host = host
        self.port = port
        self.pid = pid
        self.root = root
        self.digest = digest             # state digest reported at ready
        self.recovery = recovery         # DurableStorage.last_recovery
        self.role = role
        self.epoch = epoch               # lease epoch reported at ready
        self.repl_port = repl_port       # replication hub port, if any
        self.replica_k = replica_k       # follower slot (None = leader)


class ShardFabric:
    """N worker processes over consistent-hash study slices, fronted by
    a router (see module docstring).  ``workers=1`` runs fully inline —
    no children, no proxy hop — the single-process service path.
    """

    def __init__(self, workers: int = 2, *, host: str = "127.0.0.1",
                 port: int = 0, root: str | None = None,
                 storage: str = "durable", fsync: str = "off",
                 segment_bytes: int = 4 * 1024 * 1024,
                 lease_seconds: float = 60.0, seed: int = 0,
                 secret: str = "hopaas-secret", lanes: int | None = None,
                 upstream_timeout: float = 10.0, respawn: bool = True,
                 respawn_poll: float = 0.2, drain_seconds: float = 5.0,
                 reuseport: bool = False, api_workers: int = 2,
                 spawn_timeout: float = 30.0,
                 replicas: int | None = None,
                 replication: str | None = None,
                 hang_grace: float = 2.0,
                 device: str | None = None):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if storage not in ("durable", "memory"):
            raise ValueError(f"unknown fabric storage {storage!r}")
        if replicas is None:
            try:
                replicas = int(os.environ.get("REPRO_REPLICAS", "0") or 0)
            except ValueError:
                replicas = 0
        if replication is None:
            replication = os.environ.get("REPRO_REPLICATION",
                                         "async") or "async"
        if replication not in ("async", "semisync"):
            raise ValueError(f"unknown replication mode {replication!r}")
        if storage != "durable":
            replicas = 0                 # nothing durable to ship
        # resolved once, before any child exists: None -> CUDA, raising
        # here (and spawning nothing) when there is no card; every
        # leader, follower and respawn then proposes on this device
        self.device = resolve_device(device)
        self.n_workers = int(workers)
        self.host = host
        self._port = int(port)
        self.storage_kind = storage
        self.fsync = fsync
        self.segment_bytes = int(segment_bytes)
        self.lease_seconds = float(lease_seconds)
        self.seed = int(seed)
        self.secret = secret
        self.lanes = lanes
        self.upstream_timeout = float(upstream_timeout)
        self.respawn = bool(respawn)
        self.respawn_poll = float(respawn_poll)
        self.drain_seconds = float(drain_seconds)
        self.reuseport = bool(reuseport)
        self.api_workers = max(1, int(api_workers))
        self.spawn_timeout = float(spawn_timeout)
        self.replicas = max(0, int(replicas))
        self.replication = replication
        self.hang_grace = float(hang_grace)
        self.inline = self.n_workers == 1 and self.replicas == 0
        self.tokens = TokenManager(secret)
        self._tmp: tempfile.TemporaryDirectory | None = None
        if root is None and storage == "durable":
            self._tmp = tempfile.TemporaryDirectory(prefix="hopaas-fabric-")
            root = self._tmp.name
        self.root = root
        # runtime state
        self._fleet_lock = threading.RLock()
        self._workers: dict[int, _WorkerProc] = {}
        self._next_wid = 0
        self._table: RouteTable | None = None
        self._dispatcher: FabricDispatcher | None = None
        self._frontend: EventLoopFrontend | None = None
        self._monitor: threading.Thread | None = None
        self._stop_event = threading.Event()
        self._started = False
        self._stopped = False
        self._control_token = self.tokens.issue("fabric-control")
        self.respawns = 0
        self.failovers = 0
        self.handoffs: list[dict[str, Any]] = []
        self.events: list[dict[str, Any]] = []
        # replication bookkeeping: leader wid -> live follower procs,
        # monotonically numbered replica roots, deposed leaders awaiting
        # a fence, and deposed procs to reap at stop()
        self._followers: dict[int, list[_WorkerProc]] = {}
        self._replica_seq: dict[int, int] = {}
        self._fence_pending: list[dict[str, Any]] = []
        self._deposed: list[_WorkerProc] = []
        # inline (workers=1) state
        self.storage: InMemoryStorage | None = None
        self.servers: list[HopaasServer] = []

    # -- lifecycle ------------------------------------------------------ #
    def start(self) -> "ShardFabric":
        if self._started:
            return self
        self._started = True
        if self.inline:
            self._start_inline()
            return self
        self._table = RouteTable({}, self_id=None)
        self._dispatcher = FabricDispatcher(self._table, local=None,
                                            timeout=self.upstream_timeout)
        self._frontend = EventLoopFrontend(
            [], host=self.host, port=self._port, lanes=self.lanes,
            dispatcher=self._dispatcher, drain_seconds=self.drain_seconds,
            reuseport=self.reuseport)
        with self._fleet_lock:
            for _ in range(self.n_workers):
                wid = self._next_wid
                self._next_wid += 1
                wp = self._spawn(wid)
                self._workers[wid] = self._cold_start_adopt(wid, wp)
            self._table.update(endpoints=self._endpoint_map())
        self._frontend.start()
        self._push_tables()
        if self.replicas:
            with self._fleet_lock:
                wids = sorted(self._workers)
            for wid in wids:
                self._followers[wid] = [self._spawn_follower(wid)
                                        for _ in range(self.replicas)]
        if self.respawn:
            self._monitor = threading.Thread(target=self._monitor_loop,
                                             daemon=True,
                                             name="fabric-monitor")
            self._monitor.start()
        return self

    def _start_inline(self) -> None:
        if self.storage_kind == "durable":
            self.storage = DurableStorage(
                os.path.join(self.root, "worker-0"), fsync=self.fsync,
                segment_bytes=self.segment_bytes)
        else:
            self.storage = InMemoryStorage()
        self.servers = [
            HopaasServer(storage=self.storage, tokens=self.tokens,
                         lease_seconds=self.lease_seconds, seed=self.seed,
                         worker_name=f"fabric-0-api-{i}",
                         device=self.device)
            for i in range(self.api_workers)]
        self._frontend = EventLoopFrontend(
            self.servers, host=self.host, port=self._port, lanes=self.lanes,
            drain_seconds=self.drain_seconds)
        self._frontend.start()

    def stop(self) -> None:
        if self._stopped or not self._started:
            self._stopped = True
            return
        self._stopped = True
        self._stop_event.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
        if self._frontend is not None:
            self._frontend.stop()
        if self._dispatcher is not None:
            self._dispatcher.close()
        with self._fleet_lock:
            procs = [wp.proc for wp in self._workers.values()]
            procs += [fp.proc for fols in self._followers.values()
                      for fp in fols]
            procs += [wp.proc for wp in self._deposed]
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
        deadline = time.monotonic() + 5.0
        for proc in procs:
            timeout = max(0.1, deadline - time.monotonic())
            try:
                proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5.0)
        if self.storage is not None:
            self.storage.close()
        if self._tmp is not None:
            self._tmp.cleanup()

    # -- addresses ------------------------------------------------------ #
    @property
    def port(self) -> int:
        return self._frontend.port if self._frontend is not None else 0

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    @property
    def endpoints(self) -> list[tuple[str, int]]:
        """Data endpoints of every live worker (private ports), for
        endpoint-aware clients running without the router hop."""
        if self.inline:
            return [(self.host, self.port)]
        with self._fleet_lock:
            return [(wp.host, wp.port)
                    for _wid, wp in sorted(self._workers.items())]

    def issue_token(self, user: str = "fabric-user",
                    ttl_seconds: float = 24 * 3600.0) -> str:
        return self.tokens.issue(user, ttl_seconds=ttl_seconds)

    def owner_of(self, study_key: str) -> int:
        if self.inline:
            return 0
        return self._table.owner(study_key)

    def owner_endpoint(self, study_key: str) -> tuple[str, int]:
        if self.inline:
            return (self.host, self.port)
        wp = self._workers[self._table.owner(study_key)]
        return (wp.host, wp.port)

    def stats(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "workers": 1 if self.inline else len(self._workers),
            "inline": self.inline,
            "respawns": self.respawns,
            "failovers": self.failovers,
            "replicas": self.replicas,
            "replication": self.replication,
            "handoffs": len(self.handoffs),
        }
        if self._frontend is not None:
            out["frontend"] = self._frontend.stats()
        if self._dispatcher is not None:
            out["dispatcher"] = self._dispatcher.stats()
        return out

    # -- child processes ------------------------------------------------ #
    def _worker_root(self, wid: int) -> str | None:
        if self.storage_kind != "durable":
            return None
        return os.path.join(self.root, f"worker-{wid}")

    def _spawn(self, wid: int, *, epoch: int = 0,
               follow: tuple[str, int] | None = None,
               replica_k: int | None = None) -> _WorkerProc:
        # -c instead of -m: runpy warns when the module is also imported
        # through the package __init__ (it is, for the API exports)
        entry = ("import sys; from repro_torch.core.fabric import main; "
                 "sys.exit(main(sys.argv[1:]))")
        cmd = [sys.executable, "-c", entry, "--serve-worker",
               "--worker-id", str(wid), "--host", self.host,
               "--storage", self.storage_kind, "--fsync", self.fsync,
               "--segment-bytes", str(self.segment_bytes),
               "--lease-seconds", str(self.lease_seconds),
               "--seed", str(self.seed + wid),
               "--upstream-timeout", str(self.upstream_timeout),
               "--device", str(self.device)]
        if replica_k is None:
            root = self._worker_root(wid)
        else:
            root = (os.path.join(self.root,
                                 f"worker-{wid}-replica-{replica_k}")
                    if self.storage_kind == "durable" else None)
        if root is not None:
            cmd += ["--root", root]
        if self.lanes is not None:
            cmd += ["--lanes", str(self.lanes)]
        if self.reuseport and replica_k is None \
                and self._frontend is not None:
            cmd += ["--reuseport-port", str(self._frontend.port)]
        if self.replicas and self.storage_kind == "durable":
            cmd += ["--repl-listen", "--replication", self.replication]
        if epoch:
            cmd += ["--epoch", str(epoch)]
        if follow is not None:
            cmd += ["--follow", f"{follow[0]}:{follow[1]}"]
        env = dict(os.environ)
        env["REPRO_FABRIC_SECRET"] = self.secret
        src_dir = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = (src_dir + os.pathsep + env["PYTHONPATH"]
                             if env.get("PYTHONPATH") else src_dir)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, env=env)
        try:
            ready = self._read_ready(proc)
        except Exception:
            proc.kill()
            raise
        return _WorkerProc(wid, proc, self.host, int(ready["port"]),
                           int(ready["pid"]), root, ready.get("digest"),
                           ready.get("recovery"),
                           role=ready.get("role", "leader"),
                           epoch=int(ready.get("epoch") or 0),
                           repl_port=ready.get("repl_port"),
                           replica_k=replica_k)

    def _spawn_follower(self, wid: int) -> _WorkerProc:
        with self._fleet_lock:
            leader = self._workers[wid]
            k = self._replica_seq.get(wid, 0)
            self._replica_seq[wid] = k + 1
        if leader.repl_port is None:
            raise RuntimeError(
                f"worker {wid} serves no replication hub; cannot attach "
                "a follower")
        return self._spawn(wid, follow=(leader.host, leader.repl_port),
                           replica_k=k)

    def _replica_roots(self, wid: int) -> list[tuple[int, str]]:
        """``worker-{wid}-replica-{k}`` directories present on disk,
        sorted by replica index."""
        if self.storage_kind != "durable" or self.root is None:
            return []
        prefix = f"worker-{wid}-replica-"
        out: list[tuple[int, str]] = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        for name in names:
            if not name.startswith(prefix):
                continue
            suffix = name[len(prefix):]
            if suffix.isdigit() and os.path.isdir(
                    os.path.join(self.root, name)):
                out.append((int(suffix), os.path.join(self.root, name)))
        return sorted(out)

    def _cold_start_adopt(self, wid: int, wp: _WorkerProc) -> _WorkerProc:
        """Epoch-aware cold start: a full-fleet kill after an in-flight
        failover leaves the highest-epoch state in a
        ``worker-{wid}-replica-{k}`` directory while the restarted
        worker boots from ``worker-{wid}`` at the old epoch — acked
        post-failover writes would sit recoverable on disk but unserved.
        Scan every candidate root, replay each read-only
        (``recover_dir_state`` is the authority, exactly as in runtime
        promotion), and if any replica journaled a newer lease epoch,
        promote the fresh worker onto that state before the fleet takes
        traffic.  Also seeds ``_replica_seq`` past any surviving replica
        directories so new followers never collide with old roots."""
        replicas = self._replica_roots(wid)
        if not replicas:
            return wp
        with self._fleet_lock:
            self._replica_seq[wid] = max(self._replica_seq.get(wid, 0),
                                         replicas[-1][0] + 1)
        best_root: str | None = None
        best = (wp.epoch, -1)            # (lease epoch, records replayed)
        for _k, root in replicas:
            try:
                store, meta = recover_dir_state(root)
            except Exception:
                logger.warning("cold start: replica root %s unreadable, "
                               "skipping", root, exc_info=True)
                continue
            cand = (int(getattr(store, "lease_epoch", 0) or 0),
                    int(meta.get("records_replayed") or 0))
            if cand[0] > wp.epoch and cand > best:
                best, best_root = cand, root
        if best_root is None:
            return wp
        # strictly newer term than any root on disk, mirroring _failover:
        # the adopting worker's own WAL journals the reconcile + lease,
        # so the next cold start picks worker-{wid} again
        new_epoch = best[0] + 1
        promoted = self._control_checked(wp, "/fabric/promote", {
            "epoch": new_epoch, "leader_root": best_root})
        wp.epoch = new_epoch
        wp.digest = promoted.get("digest")
        wp.recovery = promoted.get("recovery")
        self.events.append({
            "event": "cold_start_adopt", "worker": wid,
            "adopted_root": best_root, "epoch": new_epoch,
            "digest_match": bool(promoted.get("digest_match", True)),
            "reconcile": promoted.get("reconcile")})
        return wp

    def _read_ready(self, proc: subprocess.Popen) -> dict[str, Any]:
        deadline = time.monotonic() + self.spawn_timeout
        fd = proc.stdout.fileno()
        buf = b""
        while b"\n" not in buf:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError("fabric worker did not become ready")
            if proc.poll() is not None:
                raise RuntimeError(
                    f"fabric worker exited with {proc.returncode} before "
                    "becoming ready")
            ready, _, _ = select.select([fd], [], [], min(remaining, 0.25))
            if not ready:
                continue
            chunk = os.read(fd, 4096)
            if not chunk:
                raise RuntimeError("fabric worker closed stdout before "
                                   "becoming ready")
            buf += chunk
        return json.loads(buf.split(b"\n", 1)[0])

    def _endpoint_map(self) -> dict[int, tuple[str, int]]:
        return {wid: (wp.host, wp.port) for wid, wp in self._workers.items()}

    # -- control-plane client ------------------------------------------- #
    def _control(self, wp: _WorkerProc, path: str,
                 body: dict[str, Any] | None = None, *,
                 timeout: float | None = None
                 ) -> tuple[int, dict[str, Any]]:
        conn = http.client.HTTPConnection(wp.host, wp.port,
                                          timeout=timeout or 10.0)
        try:
            data = json.dumps(body or {}).encode()
            conn.request("POST", path, data, {
                "Authorization": f"Bearer {self._control_token}",
                "Content-Type": "application/json"})
            resp = conn.getresponse()
            blob = resp.read()
            payload = json.loads(blob) if blob else {}
            return resp.status, payload
        finally:
            conn.close()

    def _control_checked(self, wp: _WorkerProc, path: str,
                         body: dict[str, Any] | None = None
                         ) -> dict[str, Any]:
        status, payload = self._control(wp, path, body)
        if status != 200:
            raise RuntimeError(
                f"fabric control {path} on worker {wp.wid} failed: "
                f"{status} {payload}")
        return payload

    def _push_tables(self, **update: Any) -> None:
        """Push the parent's routing view (plus ``update`` deltas) to
        every worker, then apply it to the router's own table last —
        workers learn a cutover before the router starts using it."""
        with self._fleet_lock:
            body = {"endpoints": {str(w): [h, p] for w, (h, p)
                                  in self._endpoint_map().items()},
                    "ring_ids": self._table.worker_ids(), **update}
            workers = list(self._workers.values())
        for wp in workers:
            try:
                self._control(wp, "/fabric/ring", body, timeout=5.0)
            except Exception:
                logger.warning("ring push to worker %d failed", wp.wid,
                               exc_info=True)
        self._table.update(
            endpoints=self._endpoint_map(),
            ring_ids=body.get("ring_ids"),
            overrides=body.get("overrides"),
            clear_overrides=bool(body.get("clear_overrides")))

    # -- membership / rebalance ----------------------------------------- #
    def locations(self) -> dict[int, list[str]]:
        """Actual shard placement: worker id -> study keys it owns."""
        if self.inline:
            return {0: sorted(s.key for s in self.storage.studies())}
        out: dict[int, list[str]] = {}
        with self._fleet_lock:
            workers = list(self._workers.values())
        for wp in workers:
            out[wp.wid] = self._control_checked(
                wp, "/fabric/studies")["keys"]
        return out

    def worker_digest(self, wid: int) -> str:
        with self._fleet_lock:
            wp = self._workers[wid]
        digest = self._control_checked(wp, "/fabric/digest")["digest"]
        wp.digest = digest
        return digest

    def migrate(self, study_key: str, src_wid: int, dst_wid: int
                ) -> dict[str, Any]:
        """Hand one shard from ``src`` to ``dst``: freeze -> seal+export
        -> filter-replay import -> digest verify -> override cutover ->
        drop.  Zero lost writes: requests hitting the frozen shard get
        a retryable 503 until the override lands."""
        with self._fleet_lock:
            src = self._workers[src_wid]
            dst = self._workers[dst_wid]
        self._control_checked(src, "/fabric/freeze",
                              {"study_key": study_key})
        try:
            export = self._control_checked(src, "/fabric/export",
                                           {"study_key": study_key})
            imported = self._control_checked(dst, "/fabric/import", {
                "study_key": study_key, "digest": export["digest"],
                "snapshot": export.get("snapshot"),
                "segments": export.get("segments"),
                "record": export.get("record")})
            if imported["digest"] != export["digest"]:
                raise RuntimeError("digest mismatch after import")
        except Exception:
            with contextlib.suppress(Exception):
                self._control(src, "/fabric/unfreeze",
                              {"study_key": study_key}, timeout=5.0)
            raise
        # cutover: flip this one key everywhere, then drop the source
        self._push_tables(overrides={study_key: dst_wid})
        self._control_checked(src, "/fabric/drop", {"study_key": study_key})
        record = {"study_key": study_key, "src": src_wid, "dst": dst_wid,
                  "src_digest": export["digest"],
                  "dst_digest": imported["digest"],
                  "verified": imported["digest"] == export["digest"]}
        self.handoffs.append(record)
        self.events.append({"event": "handoff", **record})
        return record

    def add_worker(self) -> int:
        """Grow the fleet by one worker and rebalance: consistent
        hashing moves only the keys the new worker takes over."""
        if self.inline:
            raise RuntimeError("inline fabric (workers=1) cannot grow; "
                               "start with workers>=2")
        with self._fleet_lock:
            old_ids = self._table.worker_ids()
            wid = self._next_wid
            self._next_wid += 1
            self._workers[wid] = self._spawn(wid)
            # workers can *reach* the newcomer before any key routes to
            # it: endpoints grow now, the ring flips only after the moves
            self._push_tables(ring_ids=old_ids)
            new_ring = HashRing(old_ids + [wid],
                                replicas=self._table.replicas)
            moves = []
            for src_wid, keys in self.locations().items():
                if src_wid == wid:
                    continue
                for key in keys:
                    dst = new_ring.owner(key)
                    if dst != src_wid:
                        moves.append((key, src_wid, dst))
            for key, src_wid, dst in moves:
                self.migrate(key, src_wid, dst)
            self._push_tables(ring_ids=old_ids + [wid],
                              clear_overrides=True)
            if self.replicas:
                self._followers[wid] = [self._spawn_follower(wid)
                                        for _ in range(self.replicas)]
            self.n_workers = len(self._workers)
            return wid

    def remove_worker(self, wid: int) -> None:
        """Shrink the fleet: migrate every shard off ``wid``, flip the
        ring, then terminate the worker."""
        with self._fleet_lock:
            ids = self._table.worker_ids()
            if wid not in ids or len(ids) < 2:
                raise ValueError(f"cannot remove worker {wid}")
            remaining = [w for w in ids if w != wid]
            new_ring = HashRing(remaining, replicas=self._table.replicas)
            for key in self.locations().get(wid, []):
                self.migrate(key, wid, new_ring.owner(key))
            wp = self._workers.pop(wid)
            doomed = [wp] + self._followers.pop(wid, [])
            self._push_tables(ring_ids=remaining, clear_overrides=True)
            for dp in doomed:
                dp.proc.terminate()
            for dp in doomed:
                try:
                    dp.proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    dp.proc.kill()
                    dp.proc.wait(timeout=5.0)
            self.n_workers = len(self._workers)

    def kill_worker(self, wid: int, sig: int = signal.SIGKILL) -> None:
        """Send ``sig`` to a worker process (crash injection for tests)."""
        with self._fleet_lock:
            os.kill(self._workers[wid].pid, sig)

    def wait_respawn(self, wid: int, old_pid: int,
                     timeout: float = 30.0) -> _WorkerProc:
        """Block until the monitor respawned worker ``wid``."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._fleet_lock:
                wp = self._workers[wid]
            if wp.pid != old_pid and wp.proc.poll() is None:
                return wp
            time.sleep(0.05)
        raise TimeoutError(f"worker {wid} was not respawned")

    # -- fleet health ---------------------------------------------------- #
    def health(self) -> dict[str, Any]:
        """Fleet-wide health: per-worker role, lease epoch, and
        replication lag gathered over the control plane (leaders *and*
        their followers), plus the fabric's failover counters."""
        if self.inline:
            h = self.servers[0].op_health()
            h["workers"] = [{"worker": 0, "role": "leader",
                             "epoch": h.get("epoch", 0)}]
            return h
        with self._fleet_lock:
            leaders = sorted(self._workers.items())
            followers = {wid: list(fols)
                         for wid, fols in self._followers.items()}
        entries: list[dict[str, Any]] = []
        for wid, wp in leaders:
            for peer in [wp] + followers.get(wid, []):
                entry: dict[str, Any] = {
                    "worker": wid, "pid": peer.pid,
                    "endpoint": [peer.host, peer.port]}
                try:
                    status, payload = self._control(
                        peer, "/fabric/replication", {}, timeout=2.0)
                    if status == 200:
                        entry.update(payload)
                    else:
                        entry["error"] = f"control status {status}"
                except Exception as e:
                    entry["error"] = f"{type(e).__name__}: {e}"
                entries.append(entry)
        return {"status": "ok", "workers": entries,
                "speculation": _merge_speculation(entries),
                "replicas": self.replicas, "replication": self.replication,
                "respawns": self.respawns, "failovers": self.failovers}

    # -- crash respawn / failover ----------------------------------------- #
    def _monitor_loop(self) -> None:
        ping_fail: dict[int, int] = {}
        hang_ticks = max(1, int(round(self.hang_grace
                                      / max(self.respawn_poll, 1e-3))))
        while not self._stop_event.wait(self.respawn_poll):
            self._deliver_fences()
            self._reap_followers()
            with self._fleet_lock:
                leaders = list(self._workers.items())
            dead = [(wid, wp) for wid, wp in leaders
                    if wp.proc.poll() is not None]
            hung: list[tuple[int, _WorkerProc]] = []
            if self.replicas:
                # a leader that stops answering control pings while its
                # process lives (wedged, SIGSTOPped) is as gone as a dead
                # one — but only failover can help, so only probe leaders
                # that have followers to promote
                for wid, wp in leaders:
                    if wp.proc.poll() is not None:
                        ping_fail.pop(wid, None)
                        continue
                    with self._fleet_lock:
                        has_followers = bool(self._followers.get(wid))
                    if not has_followers:
                        continue
                    try:
                        status, _ = self._control(wp, "/fabric/ping", {},
                                                  timeout=0.5)
                        ok = status == 200
                    except Exception:
                        ok = False
                    if ok:
                        ping_fail[wid] = 0
                    else:
                        ping_fail[wid] = ping_fail.get(wid, 0) + 1
                        if ping_fail[wid] >= hang_ticks:
                            hung.append((wid, wp))
            if not dead and not hung:
                continue
            respawned: list[int] = []
            for wid, old in dead:
                if self._stop_event.is_set():
                    return
                if self.replicas and self._failover(wid, old,
                                                    reason="dead"):
                    ping_fail[wid] = 0
                    continue
                try:
                    # same WAL directory: recovery rebuilds the exact
                    # pre-crash state (the ready line reports the
                    # recovered digest + replay stats)
                    wp = self._spawn(wid)
                except Exception:
                    logger.exception("respawn of worker %d failed", wid)
                    continue
                with self._fleet_lock:
                    self._workers[wid] = wp
                self.respawns += 1
                self.events.append({
                    "event": "respawn", "worker": wid,
                    "old_pid": old.pid, "pid": wp.pid,
                    "recovered_digest": wp.digest,
                    "recovery": wp.recovery,
                    "digest_match": (old.digest is not None
                                     and wp.digest == old.digest)})
                respawned.append(wid)
            for wid, old in hung:
                if self._stop_event.is_set():
                    return
                with self._fleet_lock:
                    current = self._workers.get(wid)
                if current is not old or old.proc.poll() is not None:
                    continue             # already handled above
                if self._failover(wid, old, reason="hung"):
                    ping_fail[wid] = 0
            if not respawned:
                continue
            self._push_tables()
            for wid in respawned:
                with self._fleet_lock:
                    wp = self._workers[wid]
                with contextlib.suppress(Exception):
                    # requeue trials leased through the dead worker
                    # whose leases already lapsed; later expiries are
                    # caught by the normal per-ask sweep
                    self._control(wp, "/fabric/sweep", {}, timeout=5.0)
                if self.replicas:
                    # the old followers stream from a hub that died with
                    # the old process; give the respawn a fresh set
                    self._replace_followers(wid)

    def _failover(self, wid: int, old: _WorkerProc, *,
                  reason: str) -> bool:
        """Promote the most-caught-up follower of ``wid`` to leader.
        Returns False when no follower can take over (the caller falls
        back to a WAL respawn)."""
        with self._fleet_lock:
            candidates = [fp for fp in self._followers.get(wid, ())
                          if fp.proc.poll() is None]
        best: _WorkerProc | None = None
        best_pos = -1
        for fp in candidates:
            try:
                st = self._control_checked(fp, "/fabric/replication")
            except Exception as exc:
                # an unreachable follower just loses the election — but
                # say so, or a fleet that silently elects a stale one
                # looks identical to a healthy failover
                logger.warning("promote(%s): follower worker %s "
                               "unreachable, skipping: %s",
                               reason, fp.wid, exc)
                continue
            pos = int((st.get("client") or {}).get("pos") or 0)
            if pos > best_pos:
                best, best_pos = fp, pos
        if best is None:
            return False
        new_epoch = max(old.epoch, best.epoch) + 1
        try:
            promoted = self._control_checked(best, "/fabric/promote", {
                "epoch": new_epoch, "leader_root": old.root})
        except Exception:
            logger.exception("promotion of a worker-%d follower failed",
                             wid)
            return False
        best.role = "leader"
        best.epoch = new_epoch
        best.digest = promoted.get("digest")
        best.recovery = promoted.get("recovery")
        with self._fleet_lock:
            fols = self._followers.get(wid)
            if fols and best in fols:
                fols.remove(best)
            # the promoted follower keeps the dead leader's ring id —
            # HashRing placement is a pure function of the id set, so
            # no shard moves; only the endpoint behind the id changes
            self._workers[wid] = best
            self._deposed.append(old)
            self.failovers += 1
        self.events.append({
            "event": "failover", "worker": wid, "reason": reason,
            "old_pid": old.pid, "pid": best.pid, "epoch": new_epoch,
            "digest_match": bool(promoted.get("digest_match", True)),
            "recovery": promoted.get("recovery"),
            "reconcile": promoted.get("reconcile")})
        # workers learn the cutover before the router flips to it
        self._push_tables()
        with contextlib.suppress(Exception):
            self._control(best, "/fabric/sweep", {}, timeout=5.0)
        self._replace_followers(wid)
        if old.proc.poll() is None:
            # STONITH-free fencing: keep delivering the new epoch until
            # the deposed process takes it (or finally dies), so a
            # SIGSTOPped ex-leader resuming cannot ack stale writes
            with self._fleet_lock:
                self._fence_pending.append(
                    {"wid": wid, "wp": old, "epoch": new_epoch})
        return True

    def _replace_followers(self, wid: int) -> None:
        """Tear down ``wid``'s remaining followers (their upstream hub
        is gone) and spawn a full fresh set against the current leader."""
        with self._fleet_lock:
            stale = self._followers.pop(wid, [])
        for fp in stale:
            with contextlib.suppress(Exception):
                fp.proc.terminate()
        fresh: list[_WorkerProc] = []
        for _ in range(self.replicas):
            try:
                fresh.append(self._spawn_follower(wid))
            except Exception:
                logger.exception("follower spawn for worker %d failed",
                                 wid)
        with self._fleet_lock:
            self._followers[wid] = fresh
        for fp in stale:
            with contextlib.suppress(Exception):
                fp.proc.wait(timeout=5.0)

    def _reap_followers(self) -> None:
        """Respawn spontaneously-dead followers so the replica count
        holds (leader transitions rebuild their sets wholesale)."""
        if not self.replicas:
            return
        with self._fleet_lock:
            dead = [(wid, fp) for wid, fols in self._followers.items()
                    for fp in list(fols) if fp.proc.poll() is not None]
        for wid, fp in dead:
            with self._fleet_lock:
                fols = self._followers.get(wid)
                if fols and fp in fols:
                    fols.remove(fp)
                leader = self._workers.get(wid)
            if leader is None or leader.proc.poll() is not None:
                continue                 # leader is down: failover first
            try:
                nfp = self._spawn_follower(wid)
            except Exception:
                logger.exception("follower respawn for worker %d failed",
                                 wid)
                continue
            with self._fleet_lock:
                self._followers.setdefault(wid, []).append(nfp)
            self.events.append({"event": "follower_respawn", "worker": wid,
                                "old_pid": fp.pid, "pid": nfp.pid})

    def _deliver_fences(self) -> None:
        with self._fleet_lock:
            pending = list(self._fence_pending)
        for item in pending:
            wp: _WorkerProc = item["wp"]
            done = wp.proc.poll() is not None
            if not done:
                try:
                    status, _ = self._control(
                        wp, "/fabric/fence", {"epoch": item["epoch"]},
                        timeout=0.5)
                    done = status == 200
                except Exception:
                    done = False
                if done:
                    self.events.append({"event": "fence",
                                        "worker": item["wid"],
                                        "pid": wp.pid,
                                        "epoch": item["epoch"]})
            if done:
                with self._fleet_lock:
                    with contextlib.suppress(ValueError):
                        self._fence_pending.remove(item)


if __name__ == "__main__":
    sys.exit(main())
