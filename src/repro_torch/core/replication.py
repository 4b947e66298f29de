"""Shard replication: WAL shipping from a leader to follower workers.

The paper's deployment delegates durability *and* availability to a
managed PostgreSQL instance; the durable storage engine (snapshots +
segmented WAL) rebuilds the durability half, the shard fabric the
horizontal half.  This module closes the gap to the availability
half: every durable fabric worker publishes its WAL stream to a
**replication hub**, and follower workers subscribe with a
**replication client** that continuously replays the stream into
their own journaled store.  When the fabric
monitor declares a leader dead, the most-caught-up follower already
holds a byte-respecting replica and can be promoted in milliseconds
(see ``fabric.ShardFabric``).

Protocol (length-prefixed JSON frames, one TCP connection per follower):

* hub -> ``{"t": "welcome", "session": <nonce>}`` — the session nonce
  identifies one hub *process lifetime*; stream positions are only
  meaningful within a session, so a follower that sees a new nonce
  resets to position 0 and takes a fresh baseline.
* follower -> ``{"t": "hello", "follower": id, "pos": N}`` — resume
  point: the last position this follower applied.
* hub -> ``{"t": "baseline", "pos", "covers", "snapshot",
  "snapshot_sha", "segments": [{"text", "sha"}, ...]}`` — the leader's
  immutable files (snapshot + sealed segments, exactly what compaction
  reads) captured atomically with the stream position ``pos``.  Sent
  when the follower is fresh or has fallen off the in-memory tail.
* hub -> ``{"t": "rec", "pos", "line", "crc"}`` — one WAL record,
  published under the leader's journal lock so stream order equals file
  order.
* follower -> ``{"t": "ack", "pos": N}`` — cumulative; drives both the
  hub's lag accounting and semisync ``wait_ack``.

Everything shipped is verified before it is applied: baselines by
per-artifact SHA-256, records by CRC-32 and position contiguity.  A
payload that fails verification is *never* applied — the follower drops
the connection and reconnects at its last good position, which makes
the hub re-ship the lost range (the retry is the re-request).  The
``torn_ship`` fault-injection point corrupts hub sends in flight to
prove exactly that path.

``recover_dir_state`` and ``reconcile_with`` are the promotion helpers:
read a dead leader's WAL directory without mutating it, then bring the
follower's journaled store to that exact state through journaled
drop/adopt operations (digest-verified).
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import socket
import struct
import threading
import time
import zlib
from collections import deque
from typing import Any

from . import faults
from .aio import open_server_socket
from .durable import _SEG_RE, _SNAP_RE
from .storage import InMemoryStorage, load_journal_file

logger = logging.getLogger("repro_torch.replication")

_HEADER = struct.Struct(">I")
MAX_FRAME = 1 << 30              # a baseline carries whole snapshots
_BATCH = 256                     # records shipped per cv wakeup


class ReplicationError(RuntimeError):
    """Protocol violation on the replication stream."""


class _Rejected(ReplicationError):
    """A shipped payload failed checksum/digest verification — it must
    not be applied; the connection is dropped so the hub re-ships."""


class _Disconnect(Exception):
    """Deliberately sever this connection (fault injection)."""


# ---------------------------------------------------------------------- #
# framing
# ---------------------------------------------------------------------- #
def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    remaining = n
    while remaining:
        chunk = sock.recv(min(65536, remaining))
        if not chunk:
            raise ConnectionError("replication peer closed mid-frame")
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks)


def recv_frame(sock: socket.socket) -> dict[str, Any]:
    (size,) = _HEADER.unpack(_recv_exact(sock, _HEADER.size))
    if size > MAX_FRAME:
        raise ReplicationError(f"oversized replication frame ({size} bytes)")
    return json.loads(_recv_exact(sock, size).decode())


def send_frame(sock: socket.socket, obj: dict[str, Any]) -> None:
    payload = json.dumps(obj, allow_nan=False).encode()
    sock.sendall(_HEADER.pack(len(payload)) + payload)


def _sha(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


class _Follower:
    """Hub-side view of one subscribed follower connection."""

    __slots__ = ("id", "sock", "acked", "alive")

    def __init__(self, follower_id: str, sock: socket.socket):
        self.id = follower_id
        self.sock = sock
        self.acked = 0
        self.alive = True


class ReplicationHub:
    """Leader side: publish the WAL stream, serve baselines, track acks.

    ``publish`` is called by ``DurableStorage._log`` *under the journal
    lock*, so stream position order is exactly file order.  It only
    appends to an in-memory tail and notifies — never blocks on I/O or
    followers.  Per-connection sender threads drain the tail; when a
    follower's resume point has fallen off the tail (or it is fresh),
    the sender ships a baseline captured by
    ``storage.replication_baseline()`` instead.

    ``wait_ack(pos)`` is the semisync hook: true once *any* live
    follower has acknowledged ``pos``.  With no follower connected it
    degrades to async immediately (counted in ``semisync_degraded``) —
    replication must never deadlock a single-process deployment.
    """

    def __init__(self, storage, *, host: str = "127.0.0.1", port: int = 0,
                 tail_records: int = 8192, ack_timeout: float = 2.0):
        self.storage = storage
        self.session = os.urandom(8).hex()
        self.ack_timeout = float(ack_timeout)
        self.tail_records = max(16, int(tail_records))
        self._cv = threading.Condition()
        self._pos = 0
        self._bytes = 0
        # (pos, line, cumulative bytes incl. this record), contiguous
        self._tail: deque[tuple[int, str, int]] = deque()
        self._followers: dict[str, _Follower] = {}
        self._stopped = threading.Event()
        self.baselines_shipped = 0
        self.semisync_degraded = 0
        self._sock = open_server_socket(host, port, blocking=True)
        self.port = self._sock.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="repl-hub-accept")
        self._accept_thread.start()

    # -- publishing (leader write path) ----------------------------------
    def publish(self, line: str) -> int:
        """Append one WAL record to the stream; returns its position.
        Called under the storage's journal lock — O(1), no I/O."""
        with self._cv:
            self._pos += 1
            self._bytes += len(line) + 1
            self._tail.append((self._pos, line, self._bytes))
            while len(self._tail) > self.tail_records:
                self._tail.popleft()
            self._cv.notify_all()
            return self._pos

    def position(self) -> int:
        with self._cv:
            return self._pos

    def wait_ack(self, pos: int, timeout: float | None = None) -> bool:
        """Semisync: block until a live follower acknowledges ``pos``.
        True immediately when no follower is connected (degraded to
        async rather than wedging writes); False on timeout."""
        deadline = time.monotonic() + (self.ack_timeout if timeout is None
                                       else timeout)
        with self._cv:
            while True:
                live = [f for f in self._followers.values() if f.alive]
                if not live:
                    return True
                if any(f.acked >= pos for f in live):
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self.semisync_degraded += 1
                    return False
                self._cv.wait(remaining)

    # -- serving followers ------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                sock, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(sock,), daemon=True,
                             name="repl-hub-serve").start()

    def _ship(self, sock: socket.socket, obj: dict[str, Any]) -> None:
        """Frame + send, routed through the ``torn_ship`` injection point
        for data frames.  The length header is always computed from the
        *original* payload, so a torn mangle leaves the follower short —
        severing the connection afterwards turns that into the partial
        send a real network fault would produce."""
        payload = json.dumps(obj, allow_nan=False).encode()
        wire = payload
        if obj.get("t") in ("baseline", "rec"):
            wire = faults.mangle("torn_ship", payload)
        sock.sendall(_HEADER.pack(len(payload)) + wire)
        if wire != payload:
            raise _Disconnect()

    def _serve(self, sock: socket.socket) -> None:
        fol: _Follower | None = None
        try:
            self._ship(sock, {"t": "welcome", "session": self.session})
            hello = recv_frame(sock)
            if hello.get("t") != "hello":
                raise ReplicationError("expected hello frame")
            fol = _Follower(str(hello.get("follower", "?")), sock)
            with self._cv:
                stale = self._followers.get(fol.id)
                if stale is not None:            # reconnect supersedes
                    stale.alive = False
                    try:
                        stale.sock.close()
                    except OSError:
                        pass
                self._followers[fol.id] = fol
                self._cv.notify_all()
            threading.Thread(target=self._ack_loop, args=(fol,), daemon=True,
                             name=f"repl-hub-ack-{fol.id}").start()
            cursor = int(hello.get("pos", 0))
            shipped_baseline = False
            while not self._stopped.is_set() and fol.alive:
                with self._cv:
                    pos = self._pos
                    tail_start = self._tail[0][0] if self._tail else pos + 1
                if ((cursor == 0 and not shipped_baseline)
                        or (cursor < pos and cursor + 1 < tail_start)):
                    # fresh follower, or its resume point fell off the
                    # tail: ship the leader's immutable files wholesale.
                    # The flag matters on an idle leader: with pos still 0
                    # the baseline leaves cursor at 0, and without it this
                    # branch refires forever, busy-shipping empty baselines
                    base = self.storage.replication_baseline()
                    self._ship(sock, {
                        "t": "baseline", "pos": base["pos"],
                        "covers": base["covers"],
                        "snapshot": base["snapshot"],
                        "snapshot_sha": (None if base["snapshot"] is None
                                         else _sha(base["snapshot"])),
                        "segments": [{"text": s, "sha": _sha(s)}
                                     for s in base["segments"]],
                    })
                    with self._cv:
                        self.baselines_shipped += 1
                    cursor = base["pos"]
                    shipped_baseline = True
                    continue
                batch: list[tuple[int, str]] = []
                with self._cv:
                    while (self._pos <= cursor and fol.alive
                           and not self._stopped.is_set()):
                        self._cv.wait(0.5)
                    if self._stopped.is_set() or not fol.alive:
                        return
                    tail_start = (self._tail[0][0] if self._tail
                                  else self._pos + 1)
                    if cursor + 1 >= tail_start:
                        start = cursor + 1 - tail_start
                        batch = [(p, line) for p, line, _ in
                                 list(self._tail)[start:start + _BATCH]]
                for p, line in batch:
                    self._ship(sock, {"t": "rec", "pos": p, "line": line,
                                      "crc": zlib.crc32(line.encode())})
                    cursor = p
        except (_Disconnect, ReplicationError, ConnectionError, OSError,
                json.JSONDecodeError, struct.error):
            pass
        finally:
            if fol is not None:
                with self._cv:
                    fol.alive = False
                    self._cv.notify_all()
            try:
                sock.close()
            except OSError:
                pass

    def _ack_loop(self, fol: _Follower) -> None:
        try:
            while fol.alive:
                msg = recv_frame(fol.sock)
                if msg.get("t") == "ack":
                    with self._cv:
                        fol.acked = max(fol.acked, int(msg["pos"]))
                        self._cv.notify_all()
        except (ReplicationError, ConnectionError, OSError,
                json.JSONDecodeError, struct.error):
            pass
        finally:
            with self._cv:
                fol.alive = False
                self._cv.notify_all()
            try:
                fol.sock.close()
            except OSError:
                pass

    # -- observability ----------------------------------------------------
    def _bytes_behind_locked(self, acked: int) -> int:
        if acked >= self._pos:
            return 0
        for p, _, cum in self._tail:
            if p == acked:
                return self._bytes - cum
        return self._bytes          # beyond the tail: bound by the total

    def status(self) -> dict[str, Any]:
        with self._cv:
            followers = [
                {"id": f.id, "connected": f.alive, "acked": f.acked,
                 "lag_records": self._pos - f.acked,
                 "lag_bytes": self._bytes_behind_locked(f.acked)}
                for f in self._followers.values()]
            return {"session": self.session, "port": self.port,
                    "pos": self._pos, "bytes": self._bytes,
                    "followers": followers,
                    "baselines_shipped": self.baselines_shipped,
                    "semisync_degraded": self.semisync_degraded}

    def stop(self) -> None:
        self._stopped.set()
        try:
            # close() alone does not wake a thread blocked in accept();
            # shutdown() does, so the listener actually leaves LISTEN and
            # a restarted hub can rebind the port immediately
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=2.0)
        with self._cv:
            fols = list(self._followers.values())
            for f in fols:
                f.alive = False
            self._cv.notify_all()
        for f in fols:
            try:
                f.sock.close()
            except OSError:
                pass


class ReplicationClient:
    """Follower side: subscribe to a leader hub and replay its stream
    into the local (journaled) store via ``storage.apply_replicated``.

    Runs a single daemon thread that reconnects forever with a short
    backoff; every disconnect — network fault, verification failure,
    injected partition — resumes from the last *applied* position, so a
    corrupt shipped payload is simply shipped again.  ``status()``
    exposes position, baseline/reject/resync counters, and the last
    error for the health endpoint.
    """

    def __init__(self, storage, leader: tuple[str, int], *,
                 follower_id: str = "follower-0",
                 retry_interval: float = 0.05):
        self.storage = storage
        self.leader = (leader[0], int(leader[1]))
        self.follower_id = follower_id
        self.retry_interval = float(retry_interval)
        # Session/progress fields below follow a single-writer discipline:
        # only the client thread (_run) mutates them.  status()/position()
        # read them lock-free for observability — GIL-atomic loads whose
        # staleness is bounded by one poll interval, and failover
        # re-verifies actual state by digest before serving.
        self._session: str | None = None  # repro-check: allow(shared-state)
        self._pos = 0  # repro-check: allow(shared-state)
        # threading.Event is internally synchronized and never rebound
        self._connected = threading.Event()  # repro-check: allow(shared-state)
        self._stopped = threading.Event()
        # single-writer; stop() snapshots the reference only to interrupt
        # a blocking recv — a missed swap just waits out the socket timeout
        self._sock: socket.socket | None = None  # repro-check: allow(shared-state)
        self.baselines = 0  # repro-check: allow(shared-state)
        self.rejects = 0  # repro-check: allow(shared-state)
        self.resyncs = 0  # repro-check: allow(shared-state)
        self.records_applied = 0  # repro-check: allow(shared-state)
        self.last_error: str | None = None  # repro-check: allow(shared-state)
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"repl-client-{follower_id}")

    def start(self) -> "ReplicationClient":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stopped.set()
        sock = self._sock
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)

    # -- observability / test hooks --------------------------------------
    def position(self) -> int:
        return self._pos

    def connected(self) -> bool:
        return self._connected.is_set()

    def wait_connected(self, timeout: float = 10.0) -> bool:
        return self._connected.wait(timeout)

    def wait_position(self, pos: int, timeout: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout
        while self._pos < pos and time.monotonic() < deadline:
            time.sleep(0.005)
        return self._pos >= pos

    def status(self) -> dict[str, Any]:
        return {"follower": self.follower_id,
                "connected": self._connected.is_set(),
                "leader": list(self.leader), "pos": self._pos,
                "session": self._session, "baselines": self.baselines,
                "rejects": self.rejects, "resyncs": self.resyncs,
                "records_applied": self.records_applied,
                "last_error": self.last_error}

    # -- sync loop --------------------------------------------------------
    def _run(self) -> None:
        while not self._stopped.is_set():
            try:
                self._sync_once()
            except _Rejected as e:
                self.rejects += 1
                self.last_error = str(e)
            except (ReplicationError, ConnectionError, OSError,
                    json.JSONDecodeError, struct.error) as e:
                self.last_error = f"{type(e).__name__}: {e}"
            finally:
                self._connected.clear()
            self._stopped.wait(self.retry_interval)

    def _sync_once(self) -> None:
        if faults.fire("partition_follower"):
            raise ConnectionError("injected follower partition")
        sock = socket.create_connection(self.leader, timeout=10.0)
        if sock.getsockname() == sock.getpeername():
            # TCP simultaneous-open: reconnecting to a dead leader's
            # ephemeral port can self-connect (source port == destination
            # port), which both wedges this loop and squats the port the
            # restarted hub needs to rebind
            sock.close()
            raise ConnectionError("self-connect (leader not listening)")
        self._sock = sock
        try:
            welcome = recv_frame(sock)
            if welcome.get("t") != "welcome":
                raise ReplicationError("expected welcome frame")
            if welcome.get("session") != self._session:
                # a new hub process: positions from the old session are
                # meaningless, so restart from a fresh baseline
                if self._session is not None:
                    self.resyncs += 1
                self._session = welcome.get("session")
                self._pos = 0
            send_frame(sock, {"t": "hello", "follower": self.follower_id,
                              "pos": self._pos})
            self._connected.set()
            while not self._stopped.is_set():
                frame = recv_frame(sock)
                t = frame.get("t")
                if t == "baseline":
                    self._apply_baseline(frame)
                elif t == "rec":
                    self._apply_rec(frame)
                else:
                    raise ReplicationError(f"unknown frame type {t!r}")
                send_frame(sock, {"t": "ack", "pos": self._pos})
        finally:
            self._sock = None
            try:
                sock.close()
            except OSError:
                pass

    def _apply_baseline(self, frame: dict[str, Any]) -> None:
        """Verify *everything* before touching local state: a baseline
        is adopted whole or not at all."""
        snap = frame.get("snapshot")
        if snap is not None and _sha(snap) != frame.get("snapshot_sha"):
            raise _Rejected("shipped snapshot failed checksum verification")
        segments = frame.get("segments", [])
        for seg in segments:
            if _sha(seg["text"]) != seg.get("sha"):
                raise _Rejected("shipped segment failed checksum verification")
        for key in [s.key for s in self.storage.studies()]:
            self.storage.drop_shard(key)
        if snap is not None:
            for srec in json.loads(snap)["state"]["studies"]:
                self.storage.apply_replicated(
                    {"op": "adopt_shard", "key": srec["key"], "shard": srec})
        for seg in segments:
            for line in seg["text"].splitlines():
                line = line.strip()
                if line:
                    self.storage.apply_replicated(json.loads(line))
        self._pos = int(frame["pos"])
        self.baselines += 1

    def _apply_rec(self, frame: dict[str, Any]) -> None:
        pos = int(frame["pos"])
        line = frame["line"]
        if zlib.crc32(line.encode()) != frame.get("crc"):
            raise _Rejected(f"record {pos} failed crc verification")
        if pos <= self._pos:
            return                   # duplicate after a reconnect race
        if pos != self._pos + 1:
            self.resyncs += 1
            raise ReplicationError(
                f"gap in replication stream: have {self._pos}, got {pos}")
        self.storage.apply_replicated(json.loads(line))
        self._pos = pos
        self.records_applied += 1


# ---------------------------------------------------------------------- #
# promotion helpers
# ---------------------------------------------------------------------- #
def recover_dir_state(root: str) -> tuple[InMemoryStorage, dict[str, Any]]:
    """Read-only recovery of a WAL directory: newest snapshot + segment
    tail replayed into a fresh in-memory store, *without* repairing or
    deleting anything (the directory may belong to a dead process whose
    page cache the kernel is still flushing; promotion only needs to
    *read* the authoritative state, never to own the directory)."""
    t0 = time.perf_counter()
    names = os.listdir(root)
    snaps = sorted(int(m.group(1)) for name in names
                   if (m := _SNAP_RE.fullmatch(name)))
    covers = snaps[-1] if snaps else 0
    store = InMemoryStorage()
    if covers:
        with open(os.path.join(root, f"snapshot-{covers:08d}.json"),
                  "rb") as f:
            store.load_state(json.load(f)["state"])
    segments = sorted(int(m.group(1)) for name in names
                      if (m := _SEG_RE.fullmatch(name)))
    tail = [i for i in segments if i > covers]
    replayed, torn = 0, False
    store._replaying = True
    try:
        for j, index in enumerate(tail):
            n, t = load_journal_file(
                os.path.join(root, f"wal-{index:08d}.jsonl"), store._apply,
                # only the final (active-at-death) segment may be torn
                tolerate_torn_tail=(j == len(tail) - 1), repair=False)
            replayed += n
            torn = torn or t
    finally:
        store._replaying = False
    meta = {"snapshot_covers": covers, "segments_replayed": len(tail),
            "records_replayed": replayed, "torn_tail": torn,
            "seconds": round(time.perf_counter() - t0, 6)}
    return store, meta


def reconcile_with(storage: InMemoryStorage,
                   authority: InMemoryStorage) -> dict[str, Any]:
    """Bring ``storage`` to the exact logical state of ``authority``
    through *journaled* per-shard drop/adopt operations, so the result
    both matches the authority now and recovers to the same state later.
    Shards whose digests already match are left untouched (the common
    case for a caught-up follower).  Returns counters plus the final
    whole-store ``digest_match`` witness."""
    want = {s.key for s in authority.studies()}
    have = {s.key for s in storage.studies()}
    dropped = adopted = 0
    for key in sorted(have - want):
        storage.drop_shard(key)
        dropped += 1
    for key in sorted(want):
        if key in have:
            if storage.shard_digest(key) == authority.shard_digest(key):
                continue
            storage.drop_shard(key)
            dropped += 1
        storage.adopt_shard(authority.shard_record(key))
        adopted += 1
    return {"dropped": dropped, "adopted": adopted,
            "digest_match": storage.state_digest() == authority.state_digest()}
