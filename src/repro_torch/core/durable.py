"""Durable storage engine: snapshots + segmented WAL + group-commit fsync.

The paper's deployment leans on PostgreSQL for *shared persistency to the
multiple instances of the web application backend* (sec. 3).  The
single-file ``JournalStorage`` reproduces the durability role but not its
operational properties: the log grows without bound, recovery replays the
whole lifetime, and nothing is ever fsynced.  ``DurableStorage`` is the
real engine:

* **Segmented WAL** — mutations append to ``wal-<n>.jsonl``; when the
  active segment passes ``segment_bytes`` it is sealed (fsynced, closed)
  and a new one opened.  Sealed segments are immutable.
* **Snapshots** — ``snapshot-<n>.json`` holds the full store state
  (``InMemoryStorage.state_record``) as of the end of segment ``n``.
  Snapshots are written atomically (tmp + rename + dir fsync).
* **Background compaction** — a daemon thread folds sealed segments into
  a fresh snapshot by replaying them into a *shadow* store built from the
  previous snapshot, then deletes the folded files.  Compaction reads
  only immutable files, so it never takes a live shard lock and never
  stalls traffic.
* **Group-commit durability** — three modes:
    - ``always``: the mutation is acknowledged only after an fsync covers
      its record.  Concurrent writers share fsyncs (classic group
      commit): whoever grabs the in-flight slot syncs everything written
      so far and wakes the rest.
    - ``group``: the mutation is acknowledged once written to the OS; a
      flusher thread issues one fsync per ``group_interval`` window, so
      the loss window after a power failure is bounded by the interval
      (and sealing always fsyncs).
    - ``off``: no fsync (crash-consistent against process death, not
      power loss) — the mode for tests and throwaway runs.
* **Recovery** = load the newest snapshot + replay only the segment tail
  past it — O(new work since the last compaction), not O(lifetime).  A
  torn final record (crash mid-append) in the *last* segment is truncated
  with a warning; corruption anywhere else raises
  ``CorruptJournalError``.  Recovered state is index-for-index identical
  to the pre-crash store — ``InMemoryStorage.state_digest`` is the
  equality witness used by the tests.

Layout of ``root``::

    snapshot-00000007.json   state as of the end of segment 7
    wal-00000008.jsonl       sealed, awaiting compaction
    wal-00000009.jsonl       active

Every restart seals the previous active segment (repaired if torn) and
starts a fresh one, so segment files are append-only for their lifetime.
"""
from __future__ import annotations

import enum
import json
import logging
import os
import re
import socket
import threading
import time
from typing import Any

from . import faults
from .storage import (CorruptJournalError, InMemoryStorage,
                      load_journal_file)

try:                                    # POSIX only; see _acquire_dir_lock
    import fcntl
except ImportError:                     # pragma: no cover - non-POSIX
    fcntl = None

logger = logging.getLogger("repro_torch.storage")


class WalDirectoryLockedError(RuntimeError):
    """Another live process already owns this WAL directory.  Two writers
    appending to the same segment stream would interleave records and
    corrupt the log, so the second opener is refused outright."""

_SNAP_RE = re.compile(r"snapshot-(\d{8})\.json$")
_SEG_RE = re.compile(r"wal-(\d{8})\.jsonl$")


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except (PermissionError, OSError):
        return True
    return True


def _describe_lock_meta(meta_path: str) -> str:
    """Human-readable holder description from a ``LOCK.meta`` file, with
    an explicit staleness verdict: a meta whose pid is dead describes a
    *previous* holder, not whoever owns the flock now."""
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return ""
    pid = meta.get("pid")
    host = meta.get("host", "?")
    started = meta.get("started_at")
    when = (time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime(started))
            if isinstance(started, (int, float)) else "?")
    state = ("live" if isinstance(pid, int) and _pid_alive(pid)
             else "stale: meta pid is dead")
    return (f"; holder meta: pid {pid} on {host} since {when} ({state})")


class FsyncMode(str, enum.Enum):
    ALWAYS = "always"       # ack after fsync (batched across writers)
    GROUP = "group"         # ack after write; fsync per commit window
    OFF = "off"             # never fsync (tests / throwaway runs)


class DurableStorage(InMemoryStorage):
    """Snapshot + segmented-WAL storage engine (see module docstring)."""

    # replication hooks (see attach_replicator): inert by default so a
    # plain DurableStorage behaves exactly as before
    _replicator = None
    _semisync = False

    def __init__(self, root: str, *, fsync: str | FsyncMode = FsyncMode.GROUP,
                 segment_bytes: int = 4 * 1024 * 1024,
                 group_interval: float = 0.005,
                 auto_compact: bool = True, compact_min_segments: int = 1):
        self._journal_lock = threading.Lock()
        super().__init__()
        self.root = root
        self.fsync_mode = FsyncMode(fsync)
        self.segment_bytes = max(1, int(segment_bytes))
        self.group_interval = float(group_interval)
        self.auto_compact = bool(auto_compact)
        self.compact_min_segments = max(1, int(compact_min_segments))
        # append bookkeeping (under _journal_lock)
        self._seq = 0                    # records appended this process
        # monotone high-water mark: advanced only under _journal_lock;
        # sampled under _durable_cv by the fsync protocol, where a stale
        # read merely shrinks one group-commit batch
        self._written_seq = 0  # repro-check: allow(shared-state)
        self._records = 0
        self._bytes = 0
        self._rotations = 0
        self._closed = False
        # fsync protocol (under _durable_cv)
        self._durable_cv = threading.Condition()
        # monotone; the flusher's lock-free peek can only skip an fsync
        # that another writer already covered
        self._durable_seq = 0  # repro-check: allow(shared-state)
        self._fsync_inflight = False
        self._fsync_count = 0
        self._commits = 0                # fsync batches (group commits)
        # compaction
        self._compact_lock = threading.Lock()
        # threading.Event is internally synchronized and never rebound
        self._compact_event = threading.Event()  # repro-check: allow(shared-state)
        # stats below are written by the compactor under _compact_lock;
        # storage_stats() snapshots them lock-free for observability
        self._compactions = 0  # repro-check: allow(shared-state)
        self._last_compaction: dict[str, Any] | None = None  # repro-check: allow(shared-state)
        self._covers = 0  # repro-check: allow(shared-state) -- last segment folded into a snapshot
        # threads (started lazily)
        self._stop = threading.Event()
        # write-once thread handles: every spawn site holds _journal_lock
        # (or runs before the instance is published); close() only joins
        self._flusher: threading.Thread | None = None  # repro-check: allow(shared-state)
        self._compactor: threading.Thread | None = None  # repro-check: allow(shared-state)

        os.makedirs(root, exist_ok=True)
        self._lock_file = self._acquire_dir_lock()
        self._recover()
        # always start a fresh segment: repaired/previous files stay sealed
        existing = self._segment_indexes()
        self._active_index = max(existing + [self._covers]) + 1
        # swapped only by _rotate_locked while holding both _journal_lock
        # and the fsync-inflight slot; the fsyncing thread samples it with
        # that same slot held, so writer and syncer can never interleave
        self._active_file = open(  # repro-check: allow(shared-state)
            self._segment_path(self._active_index), "ab")
        self._active_size = 0
        if self.auto_compact and any(i < self._active_index for i in existing):
            self._start_compactor()
            self._compact_event.set()

    # ------------------------------------------------------------------ #
    # directory ownership
    # ------------------------------------------------------------------ #
    def _acquire_dir_lock(self):
        """Take an exclusive advisory lock on ``root/.lock`` so two live
        processes can never append to the same segment stream.  The lock
        dies with the process (kernel-released on crash), so a killed
        worker never wedges its directory.  On platforms without fcntl
        the guard is skipped."""
        if fcntl is None:               # pragma: no cover - non-POSIX
            return None
        lock_path = os.path.join(self.root, ".lock")
        meta_path = os.path.join(self.root, "LOCK.meta")
        f = open(lock_path, "a+")
        try:
            fcntl.flock(f.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            holder = ""
            try:
                f.seek(0)
                holder = f.read(64).strip()
            except OSError:
                pass
            f.close()
            raise WalDirectoryLockedError(
                f"WAL directory {self.root!r} is locked by another live "
                f"process{f' (pid {holder})' if holder else ''}"
                f"{_describe_lock_meta(meta_path)}; two "
                f"writers on one segment stream would corrupt the log")
        f.seek(0)
        f.truncate()
        f.write(f"{os.getpid()}\n")
        f.flush()
        try:        # holder metadata for the refusal message above
            with open(meta_path, "w") as mf:
                json.dump({"pid": os.getpid(),
                           "host": socket.gethostname(),
                           "started_at": time.time()}, mf)
        except OSError:                 # pragma: no cover - best effort
            pass
        return f

    def _release_dir_lock(self) -> None:
        f = getattr(self, "_lock_file", None)
        if f is None:
            return
        self._lock_file = None
        try:
            if fcntl is not None:
                fcntl.flock(f.fileno(), fcntl.LOCK_UN)
        except OSError:                 # pragma: no cover
            pass
        f.close()
        try:
            os.remove(os.path.join(self.root, "LOCK.meta"))
        except OSError:
            pass

    # ------------------------------------------------------------------ #
    # paths
    # ------------------------------------------------------------------ #
    def _segment_path(self, index: int) -> str:
        return os.path.join(self.root, f"wal-{index:08d}.jsonl")

    def _snapshot_path(self, covers: int) -> str:
        return os.path.join(self.root, f"snapshot-{covers:08d}.json")

    def _segment_indexes(self) -> list[int]:
        out = []
        for name in os.listdir(self.root):
            m = _SEG_RE.fullmatch(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _snapshot_indexes(self) -> list[int]:
        out = []
        for name in os.listdir(self.root):
            m = _SNAP_RE.fullmatch(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _fsync_dir(self) -> None:
        try:
            fd = os.open(self.root, os.O_RDONLY)
        except OSError:              # platform without directory fds
            return
        try:
            os.fsync(fd)
        except OSError:
            pass
        finally:
            os.close(fd)

    # ------------------------------------------------------------------ #
    # recovery: latest snapshot + segment-tail replay
    # ------------------------------------------------------------------ #
    def _recover(self) -> None:
        t0 = time.perf_counter()
        for name in os.listdir(self.root):     # crash mid-snapshot-write
            if name.endswith(".tmp"):
                os.remove(os.path.join(self.root, name))
        snaps = self._snapshot_indexes()
        covers = snaps[-1] if snaps else 0
        snapshot_trials = 0
        if covers:
            with open(self._snapshot_path(covers), "rb") as f:
                try:
                    snap = json.load(f)
                except json.JSONDecodeError as e:
                    raise CorruptJournalError(
                        f"unreadable snapshot {self._snapshot_path(covers)}: "
                        f"{e.msg}") from e
            self.load_state(snap["state"])
            # the lease record may sit in a folded segment: the snapshot
            # carries the epoch (absent in snapshots from before it did)
            self.lease_epoch = int(snap.get("lease_epoch", 0))
            snapshot_trials = sum(len(s["study"]["trials"])
                                  for s in snap["state"]["studies"])
        for stale in snaps[:-1]:               # superseded snapshots
            os.remove(self._snapshot_path(stale))
        segments = self._segment_indexes()
        for folded in [i for i in segments if i <= covers]:
            # folded into the snapshot; the pre-crash compactor died
            # between the rename and the delete
            os.remove(self._segment_path(folded))
        tail = [i for i in segments if i > covers]
        replayed, torn = 0, False
        self._replaying = True
        try:
            for j, index in enumerate(tail):
                n, t = load_journal_file(
                    self._segment_path(index), self._apply,
                    # only the newest segment can have a torn tail: older
                    # ones were sealed with an fsync before rotation
                    tolerate_torn_tail=(j == len(tail) - 1), repair=True)
                torn = torn or t
                replayed += n
        finally:
            self._replaying = False
        self._covers = covers
        self.last_recovery = {
            "snapshot_covers": covers,
            "snapshot_trials": snapshot_trials,
            "segments_replayed": len(tail),
            "records_replayed": replayed,
            "torn_tail": torn,
            "seconds": round(time.perf_counter() - t0, 6),
        }

    # ------------------------------------------------------------------ #
    # WAL append + group-commit fsync
    # ------------------------------------------------------------------ #
    # repro-check: allow(blocking-under-lock) -- the durability contract:
    # a mutation is acknowledged only after its WAL record is fsynced
    # (and, in semi-sync, follower-acked).  Callers hold the shard lock
    # across _log by design; group commit amortizes the stall.
    def _log(self, record: dict[str, Any]) -> None:
        if self._replaying:
            return
        # strict JSON: NaN/Infinity would make the segment unreadable
        text = json.dumps(record, allow_nan=False)
        line = (text + "\n").encode()
        pub = 0
        # sampled under the journal lock: attach_replicator can swap the
        # hub concurrently (promotion), and the ack wait below must go to
        # the hub that assigned ``pub``, not whichever is current by then
        rep = None
        semi = False
        with self._journal_lock:
            if self._closed:
                return
            f = self._active_file
            f.write(line)
            f.flush()                   # in the OS before we advance seq
            self._seq += 1
            seq = self._seq
            self._written_seq = seq
            self._active_size += len(line)
            self._records += 1
            self._bytes += len(line)
            rep = self._replicator
            semi = self._semisync
            if rep is not None:
                # under the journal lock: stream position order is
                # exactly file order (publish is O(1), no I/O)
                pub = rep.publish(text)
            if self._active_size >= self.segment_bytes:
                self._rotate_locked()
            if self.fsync_mode is FsyncMode.GROUP:
                self._start_flusher()
        if self.fsync_mode is FsyncMode.ALWAYS:
            self._ensure_durable(seq)
        if pub and semi:
            # the ack is only as strong as the weakest link: locally
            # durable (above) AND held by a live follower (here)
            rep.wait_ack(pub)

    def _ensure_durable(self, seq: int) -> None:
        """Block until an fsync covers ``seq`` — the group-commit core.
        One thread grabs the in-flight slot and syncs everything written
        so far; the rest ride on its notify."""
        while True:
            with self._durable_cv:
                if self._durable_seq >= seq:
                    return
                if self._fsync_inflight:
                    self._durable_cv.wait(timeout=1.0)
                    continue
                self._fsync_inflight = True
                target = self._written_seq
                f = self._active_file
            synced = False
            try:
                faults.crash("crash_before_fsync")
                os.fsync(f.fileno())
                faults.crash("crash_after_fsync")
                synced = True
            finally:
                with self._durable_cv:
                    self._fsync_inflight = False
                    if synced:
                        self._durable_seq = max(self._durable_seq, target)
                        self._fsync_count += 1
                        self._commits += 1
                    self._durable_cv.notify_all()

    # repro-check: allow(blocking-under-lock) -- sealing fsyncs the old
    # segment under the journal lock on purpose: the swap of the active
    # file handle must be atomic with respect to appenders.
    def _rotate_locked(self) -> None:
        """Seal the active segment and open the next (caller holds the
        journal lock).  Takes the fsync slot so no concurrent fsync can
        race the file handle being closed."""
        with self._durable_cv:
            while self._fsync_inflight:
                self._durable_cv.wait()
            self._fsync_inflight = True
        sealed_seq = self._written_seq
        try:
            f = self._active_file
            f.flush()
            if self.fsync_mode is not FsyncMode.OFF:
                os.fsync(f.fileno())
            f.close()
            self._active_index += 1
            self._active_file = open(
                self._segment_path(self._active_index), "ab")
            self._active_size = 0
            self._rotations += 1
        finally:
            with self._durable_cv:
                self._fsync_inflight = False
                if self.fsync_mode is not FsyncMode.OFF:
                    self._durable_seq = max(self._durable_seq, sealed_seq)
                    self._fsync_count += 1
                self._durable_cv.notify_all()
        if self.auto_compact:
            self._start_compactor()
            self._compact_event.set()

    # ------------------------------------------------------------------ #
    # replication hooks
    # ------------------------------------------------------------------ #
    def attach_replicator(self, hub, *, semisync: bool = False) -> None:
        """Publish every subsequent WAL append to ``hub`` (under the
        journal lock, so stream order equals file order).  With
        ``semisync`` each write additionally blocks until a live
        follower acknowledges the record, degrading to async when no
        follower is connected (``ReplicationHub.wait_ack``)."""
        with self._journal_lock:
            self._replicator = hub
            self._semisync = bool(semisync)

    def replication_baseline(self) -> dict[str, Any]:
        """Capture (stream position, immutable files) atomically: seal
        the active segment so every record published so far lives in a
        sealed file, pin the hub position under the journal lock, then
        read the files under the compaction lock (same order as
        ``compact``, so a concurrent fold cannot delete a segment
        mid-read)."""
        with self._compact_lock:
            with self._journal_lock:
                if not self._closed and self._active_size:
                    self._rotate_locked()
                active = self._active_index
                pos = (self._replicator.position()
                       if self._replicator is not None else 0)
            covers = self._covers
            snapshot = None
            if covers:
                with open(self._snapshot_path(covers), "r") as f:
                    snapshot = f.read()
            segments = []
            for index in self._segment_indexes():
                if covers < index < active:
                    with open(self._segment_path(index), "r") as f:
                        segments.append(f.read())
            return {"pos": pos, "covers": covers, "snapshot": snapshot,
                    "segments": segments}

    # ------------------------------------------------------------------ #
    # segment shipping (the fabric shard-handoff unit)
    # ------------------------------------------------------------------ #
    def seal_active(self) -> int:
        """Seal the active segment (fsync + close) and open the next.
        After this returns, every record appended so far lives in an
        immutable file — the precondition for ``read_immutable_files``.
        Returns the index of the newly opened active segment."""
        with self._journal_lock:
            if not self._closed:
                self._rotate_locked()
            return self._active_index

    def read_immutable_files(self) -> dict[str, Any]:
        """The current snapshot + every sealed segment, as shippable
        payloads.  Reads only immutable files (same rule as compaction),
        under the compaction lock so a concurrent fold cannot delete a
        segment mid-read.  Callers that need the payload to cover *all*
        acknowledged mutations must call ``seal_active`` first."""
        with self._compact_lock:
            with self._journal_lock:
                active = self._active_index
            covers = self._covers
            snapshot = None
            if covers:
                with open(self._snapshot_path(covers), "r") as f:
                    snapshot = f.read()
            segments = []
            for index in self._segment_indexes():
                if covers < index < active:
                    with open(self._segment_path(index), "r") as f:
                        segments.append(f.read())
            return {"covers": covers, "snapshot": snapshot,
                    "segments": segments}

    # ------------------------------------------------------------------ #
    # background threads
    # ------------------------------------------------------------------ #
    def _start_flusher(self) -> None:
        if self._flusher is None:
            self._flusher = threading.Thread(
                target=self._flusher_loop, daemon=True,
                name="durable-flusher")
            self._flusher.start()

    def _flusher_loop(self) -> None:
        while not self._stop.wait(self.group_interval):
            with self._journal_lock:
                if self._closed:
                    return
                seq = self._written_seq
            if seq > self._durable_seq:
                self._ensure_durable(seq)

    def _start_compactor(self) -> None:
        if self._compactor is None:
            self._compactor = threading.Thread(
                target=self._compactor_loop, daemon=True,
                name="durable-compactor")
            self._compactor.start()

    def _compactor_loop(self) -> None:
        while True:
            self._compact_event.wait()
            self._compact_event.clear()
            if self._stop.is_set():
                return
            try:
                self.compact()
            except Exception:
                logger.exception("background compaction failed")

    # ------------------------------------------------------------------ #
    # compaction
    # ------------------------------------------------------------------ #
    # repro-check: allow(blocking-under-lock) -- the compaction lock
    # serializes compaction against segment shipping only; appenders
    # and the request path never take it, so fsyncing under it is free.
    def compact(self, min_segments: int | None = None) -> int:
        """Fold sealed segments into a fresh snapshot; delete the folded
        files.  Returns the number of segments folded (0 = nothing to do).

        The snapshot is built by replaying the sealed segments into a
        *shadow* store seeded from the previous snapshot — only immutable
        files are read, so compaction never touches a live shard lock and
        the result is exactly the state a recovery of those files would
        produce.  The new snapshot lands atomically (tmp + rename); only
        then are the old snapshot and folded segments deleted, so a crash
        at any point leaves a recoverable directory.
        """
        with self._compact_lock:
            if self._stop.is_set():
                # a straggler compaction after close() would delete files
                # under a DurableStorage re-opened on the same directory
                return 0
            with self._journal_lock:
                active = self._active_index
            covers = self._covers
            sealed = [i for i in self._segment_indexes()
                      if covers < i < active]
            need = (self.compact_min_segments if min_segments is None
                    else max(1, int(min_segments)))
            if len(sealed) < need:
                return 0
            shadow = InMemoryStorage()
            if covers:
                with open(self._snapshot_path(covers), "rb") as f:
                    snap = json.load(f)
                shadow.load_state(snap["state"])
                shadow.lease_epoch = int(snap.get("lease_epoch", 0))
            replayed = 0
            for index in sealed:
                n, _ = load_journal_file(
                    self._segment_path(index), shadow._apply,
                    tolerate_torn_tail=False, repair=False)
                replayed += n
            new_covers = sealed[-1]
            # the lease epoch rides beside the state: folding the segment
            # that journaled it must not reset a recovered store to 0
            blob = json.dumps({"covers": new_covers,
                               "lease_epoch": shadow.lease_epoch,
                               "state": shadow.state_record()},
                              allow_nan=False).encode()
            tmp = self._snapshot_path(new_covers) + ".tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._snapshot_path(new_covers))
            self._fsync_dir()
            if covers and os.path.exists(self._snapshot_path(covers)):
                os.remove(self._snapshot_path(covers))
            for index in sealed:
                os.remove(self._segment_path(index))
            self._covers = new_covers
            self._compactions += 1
            self._last_compaction = {"folded_segments": len(sealed),
                                     "records": replayed,
                                     "covers": new_covers}
            return len(sealed)

    # ------------------------------------------------------------------ #
    # durability hooks + stats
    # ------------------------------------------------------------------ #
    def flush(self) -> None:
        """Force everything acknowledged so far to disk (any mode)."""
        with self._journal_lock:
            if self._closed:
                return
            self._active_file.flush()
            seq = self._written_seq
        if seq:
            self._ensure_durable(seq)

    # repro-check: allow(blocking-under-lock) -- shutdown: the final
    # fsync + file close must be atomic with setting _closed, or a
    # racing appender could write into a closed segment.
    def close(self) -> None:
        """Flush, fsync, stop the background threads.  Idempotent."""
        with self._journal_lock:
            if self._closed:
                return
            self._closed = True
            with self._durable_cv:
                while self._fsync_inflight:
                    self._durable_cv.wait()
                self._fsync_inflight = True
            try:
                f = self._active_file
                f.flush()
                os.fsync(f.fileno())
                f.close()
            finally:
                with self._durable_cv:
                    self._fsync_inflight = False
                    self._durable_seq = self._written_seq
                    self._fsync_count += 1
                    self._durable_cv.notify_all()
        self._stop.set()
        self._compact_event.set()          # wake the compactor to exit
        # fence: wait out any in-flight compaction so the directory is
        # safe to re-open the moment close() returns
        with self._compact_lock:
            pass
        for t in (self._flusher, self._compactor):
            if t is not None:
                t.join(timeout=5.0)
        self._release_dir_lock()

    def storage_stats(self) -> dict[str, Any]:
        stats = super().storage_stats()
        with self._journal_lock:
            active = self._active_index
            active_bytes = self._active_size
            records, wal_bytes = self._records, self._bytes
            rotations = self._rotations
        with self._durable_cv:
            fsyncs, commits = self._fsync_count, self._commits
        stats.update({
            "backend": "durable",
            "root": self.root,
            "fsync": self.fsync_mode.value,
            "segment_bytes": self.segment_bytes,
            "snapshot_covers": self._covers,
            "active_segment": active,
            "active_segment_bytes": active_bytes,
            "sealed_segments": sum(
                1 for i in self._segment_indexes() if i < active),
            "wal_records": records,
            "wal_bytes": wal_bytes,
            "fsyncs": fsyncs,
            "group_commits": commits,
            "rotations": rotations,
            "compactions": self._compactions,
            "last_compaction": self._last_compaction,
            "last_recovery": self.last_recovery,
        })
        # lock-free stats snapshot: both fields are rebound atomically by
        # attach_replicator, and a torn mode/hub pairing here only skews
        # one observability read (the durability path samples them under
        # _journal_lock in _log)
        rep = self._replicator  # repro-check: allow(shared-state)
        if rep is not None:
            stats["replication"] = {
                "mode": "semisync" if self._semisync else "async",  # repro-check: allow(shared-state)
                **rep.status()}
        return stats
