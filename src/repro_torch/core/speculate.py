"""Off-lock speculative proposal precompute — the ask-dequeue pipeline.

At high parallelism the sampler itself becomes the ask bottleneck:
every proposal runs under the study's shard lock, so N contended
workers serialize on KDE/GP compute and (being blind to each other)
get near-identical points.  The constant-liar pending view in
``ObservationCache`` fixes the blindness; this module takes the compute
off the hot path:

* ``SpeculativeQueue`` — per-study buffers of precomputed proposals,
  each tagged with the storage ``version`` it was computed against.
  There is a single background writer per server (CAS-publish: an
  older compute can never land above a newer buffer; same-age rounds
  merge, newer rounds stack on top of the previous round's leftovers)
  and many foreground drainers (``op_ask`` under the shard lock).
  Draining serves newest-first under a staleness policy: an
  exact-version proposal is a *hit* (zero sampler compute on the ask
  path), one within the staleness bound is a *stale hit* (acceptable —
  the liar rows already anticipated the in-flight trials that bumped
  the version), and anything older is dropped and counted as a *miss*
  (the ask falls back to inline sampling; it never blocks on the
  precompute thread).

* ``SpeculativeWorker`` — one daemon thread per server that owns the
  precompute loop.  Request handlers mark studies dirty via
  ``notify()`` (after a tell/prune/drain bumped the version); the
  worker snapshots the study's cache *under* the shard lock (cheap:
  copies of memoized buffers), releases it, runs the sampler's batched
  constant-liar proposal against the frozen snapshot entirely off-lock,
  and CAS-publishes the result.

Correctness: the queue holds only *parameter dicts* — draining one
registers it through the exact same journaled ``add_trial`` as an
inline proposal, so no study state is ever mutated off-WAL and
``state_digest()`` is identical across a crash/recovery mid-speculation
(the queue is a cache; it simply restarts empty).

Locking: the queue has its own mutex, only ever taken *after* the shard
lock (drain path) or with no other lock held (publish path); the worker
takes the shard lock only for the snapshot and never while holding its
own condition — the lock graph stays acyclic.
"""
from __future__ import annotations

import logging
import threading
from typing import Any, Callable

logger = logging.getLogger(__name__)


class _Buffer:
    __slots__ = ("version", "proposals")

    def __init__(self, version: int, proposals: list[dict[str, Any]]):
        self.version = version
        self.proposals = proposals


class SpeculativeQueue:
    """Version-tagged proposal buffers for one study on one server.

    Buffers are kept oldest-first; a publish *appends* rather than
    replacing, so the leftovers of the previous round stay drainable
    until they age past the staleness bound (under a contended fleet
    the request path consumes proposals while the next round is still
    computing — clobbering the remainder would waste most of the
    supply).  ``take`` serves from the newest acceptable buffer and
    lazily evicts anything older than the bound."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._bufs: list[_Buffer] = []       # version-ascending
        self.hits = 0          # drained at the exact computed version
        self.stale_hits = 0    # drained within the staleness bound
        self.misses = 0        # empty / too stale -> inline fallback
        self.published = 0     # buffers the precompute worker landed
        self.rejected = 0      # CAS losses (stale compute vs newer buffer)
        self.discarded = 0     # proposals dropped as too stale

    def publish(self, version: int,
                proposals: list[dict[str, Any]]) -> bool:
        """CAS-publish a freshly computed buffer.  Returns False (and
        keeps the current buffers) when a newer compute already landed —
        the precompute races the request path for the version counter,
        never the other way around.  Same-version publishes merge."""
        version = int(version)
        with self._lock:
            if self._bufs and self._bufs[-1].version > version:
                self.rejected += 1
                return False
            if self._bufs and self._bufs[-1].version == version:
                self._bufs[-1].proposals.extend(proposals)
            else:
                self._bufs.append(_Buffer(version, list(proposals)))
            self.published += 1
            return True

    def take(self, current_version: int,
             max_staleness: int) -> dict[str, Any] | None:
        """Pop one proposal under the staleness policy, or None (miss).
        Caller holds the shard lock, so ``current_version`` is stable
        for the duration of its ask."""
        with self._lock:
            while self._bufs:
                buf = self._bufs[-1]
                age = current_version - buf.version
                if age < 0 or not buf.proposals:
                    # future-versioned (rolled-back storage) or drained
                    self.discarded += len(buf.proposals)
                    self._bufs.pop()
                    continue
                if age > max_staleness:
                    # newest is already too old -> everything below is
                    for b in self._bufs:
                        self.discarded += len(b.proposals)
                    self._bufs.clear()
                    break
                params = buf.proposals.pop()
                if not buf.proposals:
                    self._bufs.pop()
                if age == 0:
                    self.hits += 1
                else:
                    self.stale_hits += 1
                return params
            self.misses += 1
            return None

    def depth(self) -> int:
        with self._lock:
            return sum(len(b.proposals) for b in self._bufs)

    def stats(self) -> dict[str, int]:
        with self._lock:
            queued = sum(len(b.proposals) for b in self._bufs)
            return {"hits": self.hits, "stale_hits": self.stale_hits,
                    "misses": self.misses, "published": self.published,
                    "rejected": self.rejected,
                    "discarded": self.discarded, "queued": queued}


class SpeculativeWorker:
    """Background precompute loop: one daemon thread per server.

    Not a ``threading.Thread`` subclass on purpose — the thread object
    is an implementation detail, and the public surface (``notify`` /
    ``stop`` / ``stats``) is what request handlers touch.  All shared
    fields are guarded by the condition's lock.
    """

    def __init__(self, precompute: Callable[[str], None],
                 name: str = "speculate") -> None:
        self._precompute = precompute
        self._cond = threading.Condition()
        self._dirty: set[str] = set()
        self._stopped = False
        self._rounds = 0
        self._errors = 0
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def notify(self, study_key: str) -> None:
        """Mark a study's proposal buffer stale (tell/prune/drain landed).
        Cheap and idempotent — the dirty set dedups bursts."""
        with self._cond:
            self._dirty.add(study_key)
            self._cond.notify()

    def stop(self, timeout: float = 5.0) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify()
        self._thread.join(timeout=timeout)

    def stats(self) -> dict[str, int]:
        with self._cond:
            return {"rounds": self._rounds, "errors": self._errors,
                    "dirty": len(self._dirty)}

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._dirty and not self._stopped:
                    self._cond.wait()
                if self._stopped:
                    return
                key = self._dirty.pop()
            # compute outside the condition: notify() must never block
            # behind a sampler evaluation
            try:
                self._precompute(key)
            except Exception:
                logger.exception("speculative precompute failed for "
                                 "study %s", key)
                with self._cond:
                    self._errors += 1
                continue
            with self._cond:
                self._rounds += 1
