"""Shared persistency layer, sharded per study.

The paper's reference implementation uses a PostgreSQL instance to give
*shared persistency to the multiple instances of the web application
backend* (sec. 3).  Here the same role is played by a storage object that
multiple ``HopaasServer`` workers share.  Internally the store is split
into per-study shards (``_StudyShard``): each shard owns its own lock,
an O(1) ``uid -> Trial`` index, per-state uid buckets, a min-heap of
lease deadlines, and the requeue queue.  Requests touching different
studies therefore never contend on a common lock; only study *creation*
takes the (short) registry lock.

Lease bookkeeping is heap-based: every ``add_trial``/lease renewal pushes
a ``(deadline, uid)`` entry, and ``pop_expired`` pops only entries whose
deadline has lapsed, discarding stale entries lazily (a renewal leaves the
superseded entry in the heap; it is dropped when popped because the
trial's *current* deadline is newer).  Sweeps are O(expired · log n)
instead of a full scan of every trial of every study.

Read-side acceleration: every shard carries a mutation ``version``
counter, an append-only ``completed_log`` of trials that became
observations (consumed incrementally by per-study ``ObservationCache``s
so `ask` never rescans the history), and an incrementally raced
incumbent (``best_trial`` is O(1), no scan).  Intermediate reports feed
the study's per-step / per-rung indices (see ``types.Study``) so pruner
heartbeats aggregate without walking the trial list.

An optional append-only JSONL write-ahead journal (``JournalStorage``)
provides crash-restart recovery: every mutation is journaled under the
owning shard's lock (so per-study order is preserved) before being
acknowledged, and ``replay`` reconstructs the full state — including the
indices, lease heap, completion log, and incumbent — from the log.
Replay tolerates exactly one torn (incomplete) final record — the
signature of a crash mid-append — by truncating it with a warning;
corruption anywhere else raises ``CorruptJournalError``.

``repro_torch.core.durable.DurableStorage`` builds the full storage engine on
these primitives: point-in-time snapshots (``state_record`` /
``load_state``), a segmented WAL with group-commit fsync, and background
compaction.  ``state_digest`` is the shared equality witness: two stores
with the same digest hold index-for-index identical state (trials,
lease deadlines, completion log, incumbent, waiting queue, version
counters).
"""
from __future__ import annotations

import hashlib
import heapq
import json
import logging
import math
import os
import threading
from collections import deque
from typing import Any, Callable

from .types import Direction, Study, StudyConfig, Trial, TrialState

logger = logging.getLogger("repro_torch.storage")


class CorruptJournalError(RuntimeError):
    """A journal/segment holds an unreadable record somewhere other than
    the torn tail of the final append — replay cannot proceed safely."""


def load_journal_file(path: str, apply: Callable[[dict[str, Any]], None], *,
                      tolerate_torn_tail: bool = True,
                      repair: bool = True) -> tuple[int, bool]:
    """Stream one JSONL journal file through ``apply``, one record at a
    time (memory stays O(longest line), never O(file) — legacy journals
    grow without bound).  Returns ``(n_records_applied, torn_tail_found)``.

    A *torn tail* is an unparseable final line with no trailing newline —
    exactly what a crash mid-``write`` leaves behind (records are written
    as single ``line + "\\n"`` appends, so a partial write can never
    contain the newline).  With ``repair`` the torn bytes are truncated
    from the file so the next append starts on a clean boundary; a
    parseable-but-unterminated final record is kept and newline-
    terminated.  An unparseable line anywhere else (or a newline-
    terminated garbage tail) is corruption, not a torn append, and
    raises ``CorruptJournalError``.
    """
    n = 0
    clean = 0            # byte offset of the last good record boundary
    pos = 0
    last_raw = b""
    bad: tuple[int, bytes, str] | None = None    # (offset, line, json msg)
    with open(path, "rb") as f:
        for raw in f:
            if bad is not None:
                # anything after the failed line (even a blank) proves it
                # was newline-terminated — corruption, not a torn append
                raise CorruptJournalError(
                    f"corrupt journal record in {path} at byte "
                    f"{bad[0]}: {bad[2]}")
            line = raw.strip()
            if line:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError as e:
                    bad = (pos, raw, e.msg)
                    pos += len(raw)
                    continue
                apply(rec)
                n += 1
            pos += len(raw)
            last_raw = raw
            clean = pos
    torn = False
    if bad is not None:
        offset, raw, msg = bad
        if not (tolerate_torn_tail and not raw.endswith(b"\n")):
            raise CorruptJournalError(
                f"corrupt journal record in {path} at byte {offset}: {msg}")
        torn = True
        logger.warning(
            "torn tail in journal %s: truncating %d bytes of incomplete "
            "final record %r", path, len(raw),
            raw.strip()[:60].decode(errors="replace"))
        if repair:
            with open(path, "rb+") as f:
                f.truncate(clean)
    elif repair and last_raw and not last_raw.endswith(b"\n"):
        # complete final record that lost only its newline: terminate it
        # so the next append does not merge into it
        with open(path, "ab") as f:
            f.write(b"\n")
    return n, torn


def record_study_key(rec: dict[str, Any]) -> str | None:
    """The study key a WAL record belongs to, or None for records that
    cannot be attributed (unknown ops).  This is the filter used when a
    shard migrates between fabric workers: the importer replays only the
    records of the moving study out of the exporter's shipped snapshot +
    sealed segments."""
    op = rec.get("op")
    if op == "create_study":
        return StudyConfig.from_record(rec["config"]).key()
    if op == "add_trial":
        return rec["trial"]["study_key"]
    if op == "update_trial":
        return rec["uid"].partition(":")[0]
    if op in ("enqueue", "pop_waiting"):
        return rec["study_key"]
    if op in ("adopt_shard", "drop_shard"):
        return rec["key"]
    if op == "idem":
        return rec["study_key"]
    # "lease" is store-wide (leader epoch), deliberately unattributable:
    # it must not travel with any single study on migration
    return None


# bounded per-shard idempotency window: large enough to cover every
# plausible in-flight retry, small enough to stay O(1) per shard.  FIFO
# eviction is deterministic, so live state and WAL replay agree.
_DEDUP_WINDOW = 512


class _StudyShard:
    """Everything the storage tracks for one study, under one lock."""

    __slots__ = ("study", "lock", "by_uid", "state_uids", "lease_heap",
                 "waiting", "version", "completed_log", "best_uid", "dedup")

    def __init__(self, study: Study):
        self.study = study
        self.lock = threading.RLock()
        self.by_uid: dict[str, Trial] = {}
        self.state_uids: dict[TrialState, set[str]] = {
            s: set() for s in TrialState}
        # (deadline, uid) entries; renewals push fresh entries and stale
        # ones are dropped lazily on pop
        self.lease_heap: list[tuple[float, str]] = []
        self.waiting: deque[dict[str, Any]] = deque()
        # monotonically increasing mutation counter: bumped on every shard
        # mutation, so read-side caches can detect staleness with one int
        # compare instead of scanning
        self.version = 0
        # append-only log of trial uids in the order they became
        # observations (COMPLETED with a value) — consumed incrementally
        # by per-study ObservationCaches
        self.completed_log: list[str] = []
        # incumbent: uid of the best completed trial (strictly-better
        # replacement, so ties keep the earliest completion)
        self.best_uid: str | None = None
        # bounded idempotency-key -> tell-result window (insertion order
        # = FIFO eviction order), journaled so retries stay exactly-once
        # across crash recovery and replication
        self.dedup: dict[str, dict[str, Any]] = {}


class InMemoryStorage:
    """Thread-safe sharded study/trial store (the PostgreSQL stand-in)."""

    def __init__(self):
        self._shards: dict[str, _StudyShard] = {}
        self._registry_lock = threading.RLock()
        # read-path instrumentation: number of full trial-list walks done
        # by storage read helpers.  The indexed monitoring endpoints must
        # keep this at 0 (asserted in tests) — any growth means a read
        # path regressed to scanning.  Lock-free monotonic counter: a
        # dropped concurrent increment only undercounts instrumentation.
        self.trial_scans = 0  # repro-check: allow(shared-state)

    # -- studies --------------------------------------------------------
    def get_or_create_study(self, config: StudyConfig) -> tuple[Study, bool]:
        key = config.key()
        with self._registry_lock:
            shard = self._shards.get(key)
            if shard is not None:
                return shard.study, False
            study = Study(config=config)
            study._managed = True       # mutations route through this store
            # write-ahead: the record is serialized (and, depending on the
            # fsync mode, made durable) *before* the shard is published —
            # a journaling failure never leaves a half-created study
            self._log({"op": "create_study", "config": config.to_record(),
                       "created_at": study.created_at})
            self._shards[key] = _StudyShard(study)
            return study, True

    def get_study(self, key: str) -> Study | None:
        with self._registry_lock:
            shard = self._shards.get(key)
            return None if shard is None else shard.study

    def studies(self) -> list[Study]:
        with self._registry_lock:
            return [s.study for s in self._shards.values()]

    def study_lock(self, key: str) -> threading.RLock:
        """The per-study shard lock — servers serialize per-study request
        handling on this, so different studies never contend."""
        with self._registry_lock:
            return self._shards[key].lock

    # -- trials ---------------------------------------------------------
    def _shard(self, study_key: str) -> _StudyShard | None:
        with self._registry_lock:
            return self._shards.get(study_key)

    def _index_trial(self, shard: _StudyShard, trial: Trial) -> None:
        """Append ``trial`` to the shard and maintain every index."""
        shard.study.trials.append(trial)
        shard.study.note_trial_added()
        shard.by_uid[trial.uid] = trial
        shard.state_uids[trial.state].add(trial.uid)
        if trial.state == TrialState.RUNNING and trial.lease_deadline is not None:
            heapq.heappush(shard.lease_heap, (trial.lease_deadline, trial.uid))
        shard.version += 1
        if trial.state == TrialState.COMPLETED and trial.value is not None:
            self._note_observation(shard, trial)

    @staticmethod
    def _note_observation(shard: _StudyShard, trial: Trial) -> None:
        """A trial just became an observation: log it and race the incumbent.
        Tie-break on equal values by lowest trial_id, matching the
        ``Study.best_trial()`` scan exactly."""
        if not math.isfinite(trial.value):
            # a NaN/inf objective is not a usable observation: it would
            # poison both the incumbent comparison (NaN compares false
            # against everything) and the sampler's observation matrices.
            # The API boundary rejects these with a 422; this guard keeps
            # direct storage writes from corrupting the indices.
            return
        shard.completed_log.append(trial.uid)
        sign = (1.0 if shard.study.config.direction == Direction.MINIMIZE
                else -1.0)
        best = (shard.by_uid.get(shard.best_uid)
                if shard.best_uid is not None else None)
        if (best is None or best.value is None
                or sign * trial.value < sign * best.value
                or (sign * trial.value == sign * best.value
                    and trial.trial_id < best.trial_id)):
            shard.best_uid = trial.uid

    def add_trial(self, study_key: str, params: dict[str, Any],
                  worker_id: str | None, lease_deadline: float | None,
                  retries: int = 0) -> Trial:
        shard = self._shard(study_key)
        if shard is None:
            raise KeyError(study_key)
        with shard.lock:
            tid = len(shard.study.trials)
            trial = Trial(trial_id=tid, uid=f"{study_key}:{tid}",
                          study_key=study_key, params=params,
                          worker_id=worker_id, lease_deadline=lease_deadline,
                          retries=retries)
            # write-ahead: log before indexing, so a serialization failure
            # (e.g. a non-finite param slipping past the boundary) cannot
            # leave live state diverged from what a recovery will rebuild
            self._log({"op": "add_trial", "trial": trial.to_record()})
            self._index_trial(shard, trial)
            return trial

    def get_trial(self, uid: str) -> Trial | None:
        study_key, _, _ = uid.partition(":")
        shard = self._shard(study_key)
        if shard is None:
            return None
        with shard.lock:
            return shard.by_uid.get(uid)

    def update_trial(self, uid: str, *,
                     idem: tuple[str, dict[str, Any]] | list | None = None,
                     **fields: Any) -> Trial:
        shard = self._shard(uid.partition(":")[0])
        if shard is None:
            raise KeyError(uid)
        with shard.lock:
            trial = shard.by_uid.get(uid)
            if trial is None:
                raise KeyError(uid)
            was_observation = (trial.state == TrialState.COMPLETED
                               and trial.value is not None)
            # write-ahead: a record that cannot be journaled (strict JSON
            # rejects NaN/inf) must fail *before* the in-memory apply, or
            # live state would silently diverge from the recovered one
            rec: dict[str, Any] = {
                "op": "update_trial", "uid": uid,
                "fields": {k: (list(v) if k == "intermediate" else
                               (v.value if isinstance(v, TrialState) else v))
                           for k, v in fields.items()}}
            if idem is not None:
                # a finalize and its idempotency-window note must be ONE
                # WAL record: shipped separately, a leader dying between
                # them leaves a replica where the trial is finalized but
                # the retried tell is unrecognizable (bogus 409)
                rec["idem"] = [idem[0], idem[1]]
            self._log(rec)
            for k, v in fields.items():
                if k == "intermediate":            # (step, value) append
                    step, value = v
                    trial.intermediates[int(step)] = float(value)
                    shard.study.record_report(uid, int(step), float(value))
                elif k == "state":
                    if v != trial.state:
                        shard.state_uids[trial.state].discard(uid)
                        shard.state_uids[v].add(uid)
                    trial.state = v
                elif k == "lease_deadline":
                    trial.lease_deadline = v
                    if v is not None and trial.state == TrialState.RUNNING:
                        heapq.heappush(shard.lease_heap, (float(v), uid))
                else:
                    setattr(trial, k, v)
            shard.version += 1
            if (not was_observation and trial.state == TrialState.COMPLETED
                    and trial.value is not None):
                self._note_observation(shard, trial)
            if idem is not None:
                self._remember_idem(shard, idem[0], dict(idem[1]))
            return trial

    # -- indexed views ---------------------------------------------------
    def counts(self, study_key: str) -> dict[TrialState, int]:
        """Per-state trial counts from the shard index (no trial scan)."""
        shard = self._shard(study_key)
        if shard is None:
            return {s: 0 for s in TrialState}
        with shard.lock:
            return {s: len(uids) for s, uids in shard.state_uids.items()}

    def trials_in_state(self, study_key: str, state: TrialState) -> list[Trial]:
        shard = self._shard(study_key)
        if shard is None:
            return []
        with shard.lock:
            return [shard.by_uid[u] for u in shard.state_uids[state]]

    def data_version(self, study_key: str) -> int:
        """Shard mutation counter — equal versions mean nothing changed."""
        shard = self._shard(study_key)
        if shard is None:
            return -1
        with shard.lock:
            return shard.version

    def completed_since(self, study_key: str, position: int) -> list[Trial]:
        """Observations (COMPLETED trials with a value) appended to the
        shard's completion log at index >= ``position``, in completion
        order.  O(new) — the incremental feed for ObservationCache."""
        shard = self._shard(study_key)
        if shard is None:
            return []
        with shard.lock:
            return [shard.by_uid[u]
                    for u in shard.completed_log[position:]]

    def _scan_trials(self, shard: _StudyShard) -> list[Trial]:
        """Full walk of a shard's trial list — the instrumented slow path.
        No serving read uses it today (every endpoint answers from an
        index); any future read that cannot must go through here so
        ``trial_scans`` stays honest."""
        self.trial_scans += 1
        return list(shard.study.trials)

    def trials_page(self, study_key: str, *, state: TrialState | None = None,
                    cursor: int | None = None, limit: int = 100
                    ) -> tuple[list[Trial], int | None] | None:
        """One page of a study's trials in ``trial_id`` order.

        ``cursor`` is the last ``trial_id`` of the previous page (None =
        start).  Returns ``(trials, next_cursor)`` where ``next_cursor``
        is None once the page is not full, or None if the study is
        unknown.  Unfiltered pages slice the trial list directly (ids are
        list indices, O(limit)); state-filtered pages are served from the
        per-state uid buckets — O(bucket) worst case, never a walk of the
        full trial list.
        """
        shard = self._shard(study_key)
        if shard is None:
            return None
        start = 0 if cursor is None else int(cursor) + 1
        limit = max(1, int(limit))
        with shard.lock:
            if state is None:
                trials = list(shard.study.trials[start:start + limit])
            else:
                bucket = shard.state_uids[state]
                ids = sorted(
                    tid for tid in (shard.by_uid[u].trial_id
                                    for u in bucket) if tid >= start)
                trials = [shard.by_uid[f"{study_key}:{tid}"]
                          for tid in ids[:limit]]
            next_cursor = (trials[-1].trial_id
                           if len(trials) == limit else None)
            return trials, next_cursor

    def n_trials(self, study_key: str) -> int:
        shard = self._shard(study_key)
        if shard is None:
            return 0
        with shard.lock:
            return len(shard.study.trials)

    def best_trial(self, study_key: str) -> Trial | None:
        """The incumbent, maintained incrementally on completion — O(1),
        no trial scan (ties keep the earliest completion)."""
        shard = self._shard(study_key)
        if shard is None:
            return None
        with shard.lock:
            return (None if shard.best_uid is None
                    else shard.by_uid.get(shard.best_uid))

    # -- lease heap ------------------------------------------------------
    def pop_expired(self, study_key: str, now: float) -> list[Trial]:
        """Pop trials whose lease lapsed, in deadline order.

        Touches only expired heap entries (plus stale ones superseded by a
        renewal, which are discarded).  The caller is expected to finalize
        the returned trials — they are *not* mutated here.
        """
        shard = self._shard(study_key)
        if shard is None:
            return []
        expired: list[Trial] = []
        seen: set[str] = set()
        with shard.lock:
            heap = shard.lease_heap
            while heap and heap[0][0] <= now:
                deadline, uid = heapq.heappop(heap)
                trial = shard.by_uid.get(uid)
                if trial is None or trial.state != TrialState.RUNNING:
                    continue                     # already finalized
                if trial.lease_deadline is None or trial.lease_deadline > now:
                    continue                     # renewed: stale entry
                if trial.lease_deadline != deadline or uid in seen:
                    continue                     # superseded / duplicate entry
                seen.add(uid)
                expired.append(trial)
        return expired

    def lease_heap_size(self, study_key: str) -> int:
        shard = self._shard(study_key)
        if shard is None:
            return 0
        with shard.lock:
            return len(shard.lease_heap)

    # -- fault tolerance: requeue params of expired/failed trials --------
    def enqueue_params(self, study_key: str, params: dict[str, Any],
                       retries: int) -> None:
        shard = self._shard(study_key)
        if shard is None:
            raise KeyError(study_key)
        with shard.lock:
            self._log({"op": "enqueue", "study_key": study_key,
                       "params": params, "retries": retries})
            shard.waiting.append({"params": params, "retries": retries})
            shard.version += 1

    def pop_waiting(self, study_key: str) -> dict[str, Any] | None:
        shard = self._shard(study_key)
        if shard is None:
            return None
        with shard.lock:
            if shard.waiting:
                self._log({"op": "pop_waiting", "study_key": study_key})
                item = shard.waiting.popleft()
                shard.version += 1
                return item
            return None

    # -- exactly-once tells (idempotency window) --------------------------
    def idempotent_result(self, study_key: str, key: str
                          ) -> dict[str, Any] | None:
        """The recorded result of a previously applied tell carrying
        idempotency key ``key``, or None if unseen (or evicted)."""
        shard = self._shard(study_key)
        if shard is None:
            return None
        with shard.lock:
            return shard.dedup.get(key)

    def note_idempotency(self, study_key: str, key: str,
                         result: dict[str, Any]) -> None:
        """Record a tell's result under its idempotency key (journaled,
        bounded FIFO window) so a retried request replays the original
        outcome instead of double-applying."""
        shard = self._shard(study_key)
        if shard is None:
            raise KeyError(study_key)
        with shard.lock:
            self._log({"op": "idem", "study_key": study_key,
                       "key": key, "result": result})
            self._remember_idem(shard, key, result)

    @staticmethod
    def _remember_idem(shard: _StudyShard, key: str,
                       result: dict[str, Any]) -> None:
        shard.dedup[key] = result
        while len(shard.dedup) > _DEDUP_WINDOW:
            shard.dedup.pop(next(iter(shard.dedup)))
        shard.version += 1

    # -- leader leases -----------------------------------------------------
    # Store-wide leadership epoch (replication): 0 = never replicated.
    # Persisted in the WAL on *change only*, so unreplicated deployments
    # write no lease records at all.  GIL-atomic int: fencing reads
    # tolerate staleness because every write is re-checked against the
    # journaled epoch, and replay-path stores happen on a single thread.
    lease_epoch = 0  # repro-check: allow(shared-state)

    def note_lease(self, epoch: int) -> int:
        """Persist an epoch-numbered leadership lease.  A restarted
        leader replays its WAL and sees the highest epoch it ever held —
        if the fabric has moved on to a higher epoch, its writes stay
        fenced (stale-epoch 409)."""
        epoch = int(epoch)
        with self._registry_lock:
            if epoch != self.lease_epoch:
                self._log({"op": "lease", "epoch": epoch})
                self.lease_epoch = epoch
            return self.lease_epoch

    # -- WAL record replay ------------------------------------------------
    # Shared by JournalStorage, the DurableStorage recovery path, and the
    # compactor's shadow replayer (a plain InMemoryStorage that records
    # are folded into).  ``_replaying`` suppresses re-journaling while a
    # journaled subclass applies its own log.  Toggled only by the single
    # WAL-applier thread (recovery or the replication client) on stores
    # that take no concurrent foreground writes.
    _replaying = False  # repro-check: allow(shared-state)

    def _insert_trial(self, trial: Trial) -> None:
        """Replay path: insert preserving ``trial_id``, padding journal gaps
        with explicit failed tombstones so uid->trial lookups stay aligned."""
        shard = self._shard(trial.study_key)
        if shard is None:
            raise KeyError(trial.study_key)
        with shard.lock:
            while len(shard.study.trials) < trial.trial_id:
                self._index_trial(shard, Trial.tombstone(
                    trial.study_key, len(shard.study.trials)))
            self._index_trial(shard, trial)

    def _apply(self, rec: dict[str, Any]) -> None:
        """Apply one WAL record to this store (replay/compaction path)."""
        op = rec["op"]
        if op == "create_study":
            study, created = self.get_or_create_study(
                StudyConfig.from_record(rec["config"]))
            if created and "created_at" in rec:
                study.created_at = rec["created_at"]
        elif op == "add_trial":
            self._insert_trial(Trial.from_record(rec["trial"]))
        elif op == "update_trial":
            fields = dict(rec["fields"])
            if "state" in fields:
                fields["state"] = TrialState(fields["state"])
            if "intermediate" in fields:
                fields["intermediate"] = tuple(fields["intermediate"])
            self.update_trial(rec["uid"], idem=rec.get("idem"), **fields)
        elif op == "enqueue":
            self.enqueue_params(rec["study_key"], rec["params"], rec["retries"])
        elif op == "pop_waiting":
            self.pop_waiting(rec["study_key"])
        elif op == "adopt_shard":
            self._restore_shard(rec["shard"])
        elif op == "drop_shard":
            with self._registry_lock:
                self._shards.pop(rec["key"], None)
        elif op == "idem":
            shard = self._shard(rec["study_key"])
            if shard is not None:
                with shard.lock:
                    self._remember_idem(shard, rec["key"], rec["result"])
        elif op == "lease":
            self.lease_epoch = int(rec["epoch"])

    def apply_replicated(self, rec: dict[str, Any]) -> None:
        """Apply one record arriving over the replication stream: journal
        it verbatim first (write-ahead, exactly like a locally originated
        mutation), then apply with re-journaling suppressed —
        ``_apply``'s branches journal inconsistently on their own
        (``add_trial`` replay does not log, ``update_trial`` replay
        would double-log), so replication always persists the original
        record and replays it."""
        self._log(rec)
        prev = self._replaying
        self._replaying = True
        try:
            self._apply(rec)
        finally:
            self._replaying = prev

    # -- snapshots + state digest -----------------------------------------
    @staticmethod
    def _shard_state_locked(shard: _StudyShard) -> dict[str, Any]:
        """Serialize one shard (caller holds the shard lock)."""
        return {
            "key": shard.study.key,
            "study": shard.study.to_record(),
            "waiting": [dict(w) for w in shard.waiting],
            "completed_log": list(shard.completed_log),
            "best_uid": shard.best_uid,
            "version": shard.version,
            "dedup": dict(shard.dedup),
        }

    def state_record(self) -> dict[str, Any]:
        """Point-in-time serialization of the full store: per shard, the
        study (config, trials — see ``types.Study.to_record``), waiting
        queue, completion log, incumbent, and version counter.  The
        derived indices (uid map, state buckets, lease heap) are rebuilt
        on ``load_state``.  Each shard is serialized under its own lock;
        callers needing a cross-shard-atomic cut must quiesce writers
        (the compactor reads only sealed, immutable files instead)."""
        with self._registry_lock:
            shards = list(self._shards.values())
        studies = []
        for shard in shards:
            with shard.lock:
                studies.append(self._shard_state_locked(shard))
        return {"studies": studies}

    def shard_record(self, study_key: str) -> dict[str, Any] | None:
        """Point-in-time serialization of one shard (the handoff unit for
        fabric shard migration), or None if the study is unknown."""
        shard = self._shard(study_key)
        if shard is None:
            return None
        with shard.lock:
            return self._shard_state_locked(shard)

    def _restore_shard(self, rec: dict[str, Any]) -> None:
        """Rebuild one shard (and every derived index) from its snapshot
        record.  The completion log and incumbent are restored verbatim —
        they carry *completion order*, which trial order cannot recover.

        The shard is assembled fully in private and published into the
        registry as the last step: no thread can observe (or lock) a
        half-restored shard, and the registry lock never nests a shard
        lock — the request path nests them the other way around."""
        study = Study.from_record(rec["study"])
        study._managed = True
        key = study.key
        shard = _StudyShard(study)
        for t in study.trials:
            shard.by_uid[t.uid] = t
            shard.state_uids[t.state].add(t.uid)
            if (t.state == TrialState.RUNNING
                    and t.lease_deadline is not None):
                heapq.heappush(shard.lease_heap,
                               (t.lease_deadline, t.uid))
        shard.waiting = deque(rec["waiting"])
        shard.completed_log = list(rec["completed_log"])
        shard.best_uid = rec["best_uid"]
        shard.version = rec["version"]
        # absent in pre-replication snapshots
        shard.dedup = dict(rec.get("dedup", {}))
        with self._registry_lock:
            if key in self._shards:
                raise ValueError(f"shard {key!r} already loaded")
            self._shards[key] = shard

    def load_state(self, record: dict[str, Any]) -> None:
        """Restore a ``state_record`` snapshot into this (empty) store."""
        for shard_rec in record["studies"]:
            self._restore_shard(shard_rec)

    @staticmethod
    def _digest_shard_rec(srec: dict[str, Any]) -> dict[str, Any]:
        """Augment one serialized shard with an explicit lease view (uid ->
        deadline of RUNNING trials — the information the lease heap is
        built from) so the digest also witnesses future expiries."""
        out = dict(srec)
        out["leases"] = {
            t["uid"]: t["lease_deadline"]
            for t in srec["study"]["trials"]
            if t["state"] == TrialState.RUNNING.value
            and t["lease_deadline"] is not None}
        return out

    def state_digest(self) -> str:
        """Order-independent content hash of the full logical state.

        Covers everything ``state_record`` covers plus an explicit view
        of the live leases, so digest equality proves a recovered store
        is index-for-index identical to the original: same trials, same
        incumbent, same completion order, same waiting queue, same
        future expiries."""
        record = self.state_record()
        record["studies"] = [self._digest_shard_rec(s)
                             for s in record["studies"]]
        record["studies"].sort(key=lambda s: s["key"])
        blob = json.dumps(record, sort_keys=True, allow_nan=False)
        return hashlib.sha256(blob.encode()).hexdigest()

    def shard_digest(self, study_key: str) -> str | None:
        """Content hash of one shard's logical state (same coverage as
        ``state_digest`` restricted to the shard).  Equality across two
        stores proves the migrated shard is index-for-index identical —
        the pre-cutover witness for fabric shard handoff."""
        srec = self.shard_record(study_key)
        if srec is None:
            return None
        blob = json.dumps(self._digest_shard_rec(srec), sort_keys=True,
                          allow_nan=False)
        return hashlib.sha256(blob.encode()).hexdigest()

    # -- shard ownership (fabric handoff) ---------------------------------
    def adopt_shard(self, record: dict[str, Any]) -> None:
        """Take ownership of a migrated shard: journal the adoption (the
        full shard record is the WAL payload, so recovery replays it) and
        rebuild the shard + indices.  Raises ValueError if a shard with
        the same key is already loaded."""
        key = record["key"]
        with self._registry_lock:
            if key in self._shards:
                raise ValueError(f"shard {key!r} already loaded")
            self._log({"op": "adopt_shard", "key": key, "shard": record})
            self._restore_shard(record)

    def drop_shard(self, study_key: str) -> bool:
        """Release ownership of a shard after it migrated away.  The drop
        is journaled, so recovery of this store does not resurrect the
        moved study.  Returns False if the study is unknown."""
        with self._registry_lock:
            if study_key not in self._shards:
                return False
            self._log({"op": "drop_shard", "key": study_key})
            del self._shards[study_key]
            return True

    # -- durability hooks --------------------------------------------------
    def flush(self) -> None:
        """Make every acknowledged mutation durable (no-op in memory)."""

    def close(self) -> None:
        """Flush and release any backing files (no-op in memory)."""

    def storage_stats(self) -> dict[str, Any]:
        """Backend + durability statistics (exposed on /api/v2/version)."""
        with self._registry_lock:
            n_studies = len(self._shards)
        return {"backend": "memory", "n_studies": n_studies,
                "trial_scans": self.trial_scans}

    # -- journal hook -----------------------------------------------------
    def _log(self, record: dict[str, Any]) -> None:  # overridden by JournalStorage
        pass

    def atomically(self, fn: Callable[[], Any]) -> Any:
        """Run ``fn`` under the registry lock (cross-study invariants only;
        per-study work should use ``study_lock`` instead)."""
        with self._registry_lock:
            return fn()


def _plain(obj: Any) -> Any:
    """JSON fallback for numpy scalars and arrays."""
    if hasattr(obj, "tolist"):
        return obj.tolist()
    raise TypeError(f"{type(obj).__name__} is not JSON serializable")


def from_reference_record(record: dict[str, Any]) -> InMemoryStorage:
    """A store holding the state of another store's ``state_record()``
    (the reference package's included: the record format is shared).
    The record is deep-copied through JSON first, numpy values as plain
    numbers, so the new store shares nothing with its source."""
    storage = InMemoryStorage()
    storage.load_state(json.loads(json.dumps(record, default=_plain)))
    return storage


class JournalStorage(InMemoryStorage):
    """InMemoryStorage + append-only JSONL journal with replay.

    Every mutation is journaled before being acknowledged; a freshly
    constructed ``JournalStorage`` pointed at an existing journal replays it
    to reconstruct the full service state (crash-restart of the service,
    paper sec. 3 'shared persistency').  Journal appends are serialized on
    a dedicated lock because shards write concurrently.  Replay tolerates
    a torn final record (crash mid-append) by truncating it with a
    warning; see ``DurableStorage`` for the segmented engine with
    snapshots, group-commit fsync, and compaction.
    """

    def __init__(self, path: str):
        self._journal_lock = threading.Lock()
        # serializes fsync/close against each other only — appenders
        # contend on _journal_lock alone and never wait for the disk
        self._fsync_lock = threading.Lock()
        super().__init__()
        self._path = path
        self._file = None
        if os.path.exists(path):
            self.replay(path)
        self._file = open(path, "a", buffering=1)

    def _log(self, record: dict[str, Any]) -> None:
        if self._file is not None and not self._replaying:
            # strict JSON: NaN/Infinity are not valid JSON and would make
            # the journal unreadable by a strict parser on replay
            line = json.dumps(record, allow_nan=False) + "\n"
            with self._journal_lock:
                self._file.write(line)

    def replay(self, path: str) -> int:
        """Reconstruct state from the journal.  Returns #records applied.
        A torn final record (crash mid-append) is truncated with a
        warning; corruption elsewhere raises ``CorruptJournalError``."""
        self._replaying = True
        try:
            n, _ = load_journal_file(path, self._apply,
                                     tolerate_torn_tail=True, repair=True)
        finally:
            self._replaying = False
        return n

    def flush(self) -> None:
        """Force journaled records to disk.  The buffer flush happens
        under the append lock; the fsync happens on a dedicated lock so
        concurrent appends are never stalled behind the disk."""
        with self._journal_lock:
            f = self._file
            if f is None:
                return
            f.flush()
        with self._fsync_lock:
            if self._file is not None:
                # repro-check: allow(blocking-under-lock) -- _fsync_lock
                # exists to serialize fsyncers; appenders never take it
                os.fsync(f.fileno())

    def storage_stats(self) -> dict[str, Any]:
        stats = super().storage_stats()
        stats.update({"backend": "journal", "path": self._path})
        return stats

    def close(self) -> None:
        with self._journal_lock:
            f, self._file = self._file, None
            if f is None:
                return
            f.flush()
        with self._fsync_lock:
            # repro-check: allow(blocking-under-lock) -- final fsync on
            # the fsync-serialization lock; no appender can contend
            os.fsync(f.fileno())
            f.close()
