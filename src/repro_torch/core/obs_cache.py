"""Incremental observation cache — the ask-hot-path accelerator.

Before this cache, every ``ask`` re-featurized the *entire* trial history
(per-trial ``space.to_unit_vector`` in a Python loop, per-dim ``math.log``)
to rebuild the ``(X, y)`` observation matrix the numeric samplers (TPE /
GP / CMA-ES) consume, making ask cost O(n_trials * dim) in pure Python.
The cache instead appends one featurized row per *completion event*:

  * the storage shard keeps an append-only ``completed_log`` of trials
    that became observations (COMPLETED with a value) plus a mutation
    ``version`` counter;
  * ``sync`` compares one integer, consumes only log entries it has not
    seen, and featurizes them with the vectorized space codec — O(new),
    O(1) for the common ask-after-ask case;
  * rows live in amortized-doubling buffers kept at power-of-two capacity
    so the padded views handed to the device kernels keep a stable
    shape across history growth (one new shape per doubling, not per
    trial count).

Row order: internally rows sit in completion order; ``observations()``
returns them sorted by ``trial_id`` through a lazily-maintained
permutation so the result is bit-identical to the from-scratch
``Sampler.observations`` scan (which walks ``study.trials`` in id order).
That keeps sampler proposals byte-for-byte reproducible whether or not
the cache is used, including across journal replay.

Pending view (constant liar): when constructed with ``liar != "none"``
the cache additionally tracks the study's RUNNING (leased) trials and
exposes ``augmented()`` — the observed rows followed by one fantasy row
per in-flight trial whose objective is imputed from the observed values
(``min`` = optimistic, ``mean`` = neutral, ``max`` = pessimistic, all in
minimization sign).  Pending-aware samplers consume this view so their
acquisition repels points other workers are already evaluating instead
of handing N concurrent asks near-identical proposals.  Pending rows are
rebuilt wholesale from the shard's RUNNING index on sync (sorted by
trial id, one vectorized featurization) — the same construction a
from-scratch scan or a WAL replay produces, so augmented buffers stay
bit-identical across recovery too.

Thread-safety: sync/reads are performed under the owning study's shard
lock (the server serializes per-study request handling on it).
``snapshot()`` captures an immutable read view that is safe to hand to
a sampler *off* the lock (the speculative precompute path): every array
it exposes is either a fancy-index copy or a fresh concatenation, never
one of the live append buffers.
"""
from __future__ import annotations

import numpy as np

from .space import SearchSpace
from .types import Direction, Trial, TrialState

_MIN_CAPACITY = 8

#: accepted constant-liar imputation modes ("none" disables the pending
#: view entirely — the cache behaves exactly like the pre-liar version)
LIAR_MODES = ("none", "min", "mean", "max")


def check_liar(mode: str) -> str:
    if mode not in LIAR_MODES:
        raise ValueError(f"unknown liar mode {mode!r}; "
                         f"expected one of {LIAR_MODES}")
    return mode


def liar_value(y: np.ndarray, mode: str) -> float:
    """Imputed objective for in-flight trials (minimization sign).

    One definition shared by the cache and the from-scratch sampler path
    so both produce bit-identical fantasy rows (``mean`` is computed as
    sum/n over the trial-id-ordered values on purpose — a different
    summation order would differ in the last ulp).
    """
    if mode == "min":
        return float(np.min(y))
    if mode == "max":
        return float(np.max(y))
    return float(np.sum(y) / len(y))


def pad_pow2(n: int, lo: int = _MIN_CAPACITY) -> int:
    """Smallest power of two >= n (floor ``lo``) — the shared padding
    width for cache capacity and the samplers' shape-stable buffers.  One
    definition: cached and from-scratch paths must agree on shapes."""
    return max(lo, 1 << max(n - 1, 0).bit_length())


class ObservationCache:
    """Incrementally maintained ``(X, y)`` of a study's observations."""

    def __init__(self, space: SearchSpace, direction: Direction,
                 liar: str = "none"):
        self._space = space
        self._sign = 1.0 if direction == Direction.MINIMIZE else -1.0
        self._liar = check_liar(liar)
        cap = _MIN_CAPACITY
        self._X = np.zeros((cap, space.dim), dtype=np.float64)
        self._y = np.zeros(cap, dtype=np.float64)
        self._ids = np.zeros(cap, dtype=np.int64)
        self._n = 0
        self._log_position = 0        # consumed prefix of the completion log
        self._version = -2            # last storage version seen (fast no-op)
        self._ordered: tuple[np.ndarray, np.ndarray] | None = None
        self._padded: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None
        # pending (RUNNING) trials, sorted by trial_id: fantasy rows for
        # the constant-liar view.  _pending_fp bumps only when the
        # pending *set* changes, so sampler memos keyed on `token` stay
        # valid across syncs that only renewed leases.
        self._pending_ids: list[int] = []
        self._pending_X = np.zeros((0, space.dim), dtype=np.float64)
        self._pending_fp = 0
        self._aug: tuple[np.ndarray, np.ndarray] | None = None
        self._aug_padded: tuple[np.ndarray, np.ndarray,
                                np.ndarray] | None = None

    # -- properties ------------------------------------------------------
    @property
    def count(self) -> int:
        return self._n

    @property
    def capacity(self) -> int:
        return len(self._y)

    @property
    def liar(self) -> str:
        return self._liar

    @property
    def pending_count(self) -> int:
        return len(self._pending_ids)

    @property
    def pending_ids(self) -> tuple[int, ...]:
        return tuple(self._pending_ids)

    @property
    def version(self) -> int:
        """Storage mutation version the cache was last synced at."""
        return self._version

    @property
    def token(self) -> tuple[int, int]:
        """Cheap identity of the cache *contents* — changes iff the
        observed rows or the pending set changed.  Sampler memo key."""
        return (self._n, self._pending_fp)

    # -- ingestion -------------------------------------------------------
    def sync(self, storage, study_key: str) -> "ObservationCache":
        """Pull completion events the cache has not seen.  Call under the
        study's shard lock.  One int compare when nothing changed."""
        version = storage.data_version(study_key)
        if version == self._version:
            return self
        new = storage.completed_since(study_key, self._log_position)
        if new:
            self._append(new)
            self._log_position += len(new)
        if self._liar != "none":
            self._sync_pending(storage, study_key)
        self._version = version
        return self

    def _sync_pending(self, storage, study_key: str) -> None:
        """Rebuild the fantasy rows from the shard's RUNNING index.

        Wholesale rebuild (not incremental): pending sets are small and
        churn on every ask/tell, and building from the sorted RUNNING
        list in one vectorized featurization is exactly what a replayed
        shard produces — bit-identical buffers across recovery."""
        running = storage.trials_in_state(study_key, TrialState.RUNNING)
        running.sort(key=lambda t: t.trial_id)
        ids = [t.trial_id for t in running]
        if ids == self._pending_ids:
            return
        self._pending_ids = ids
        self._pending_X = (
            self._space.to_unit_matrix([t.params for t in running])
            if running else np.zeros((0, self._space.dim), dtype=np.float64))
        self._pending_fp += 1
        self._aug = None
        self._aug_padded = None

    def _append(self, trials: list[Trial]) -> None:
        k = len(trials)
        need = self._n + k
        if need > self.capacity:
            cap = pad_pow2(need)
            X = np.zeros((cap, self._space.dim), dtype=np.float64)
            y = np.zeros(cap, dtype=np.float64)
            ids = np.zeros(cap, dtype=np.int64)
            X[: self._n] = self._X[: self._n]
            y[: self._n] = self._y[: self._n]
            ids[: self._n] = self._ids[: self._n]
            self._X, self._y, self._ids = X, y, ids
        rows = self._space.to_unit_matrix([t.params for t in trials])
        self._X[self._n: need] = rows
        self._y[self._n: need] = [self._sign * t.value for t in trials]
        self._ids[self._n: need] = [t.trial_id for t in trials]
        self._n = need
        self._ordered = None
        self._padded = None
        self._aug = None          # liar value depends on the observed set
        self._aug_padded = None

    # -- read views ------------------------------------------------------
    def observations(self) -> tuple[np.ndarray, np.ndarray]:
        """(X, y) in trial-id order — bit-identical to the from-scratch
        ``Sampler.observations`` scan.  Cached until the next append."""
        if self._ordered is None:
            n = self._n
            order = np.argsort(self._ids[:n], kind="stable")
            self._ordered = (self._X[:n][order], self._y[:n][order])
        return self._ordered

    def padded(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(X, y, mask) zero-padded to the pow-2 capacity, trial-id order.
        Stable shapes across asks."""
        if self._padded is None:
            cap = pad_pow2(self._n)
            X = np.zeros((cap, self._space.dim), dtype=np.float64)
            y = np.zeros(cap, dtype=np.float64)
            mask = np.zeros(cap, dtype=np.float64)
            Xs, ys = self.observations()
            X[: self._n], y[: self._n], mask[: self._n] = Xs, ys, 1.0
            self._padded = (X, y, mask)
        return self._padded

    # -- pending (constant-liar) views -----------------------------------
    def liar_value(self) -> float | None:
        """Imputed objective for fantasy rows, or None when the liar is
        off or there is nothing observed to impute from."""
        if self._liar == "none" or self._n == 0:
            return None
        return liar_value(self.observations()[1], self._liar)

    def augmented(self) -> tuple[np.ndarray, np.ndarray]:
        """(X, y) of observed rows followed by one liar-imputed row per
        RUNNING trial (trial-id order within each group).  Falls back to
        ``observations()`` when the liar is off, nothing is pending, or
        nothing has been observed yet."""
        lv = self.liar_value()
        if lv is None or not self._pending_ids:
            return self.observations()
        if self._aug is None:
            Xo, yo = self.observations()
            k = len(self._pending_ids)
            self._aug = (np.concatenate([Xo, self._pending_X]),
                         np.concatenate([yo, np.full(k, lv)]))
        return self._aug

    def padded_augmented(self) -> tuple[np.ndarray, np.ndarray,
                                        np.ndarray]:
        """``augmented()`` zero-padded to pow-2 with a validity mask —
        the pending-aware analogue of ``padded()``."""
        if self._aug_padded is None:
            Xa, ya = self.augmented()
            n = len(ya)
            cap = pad_pow2(n)
            X = np.zeros((cap, self._space.dim), dtype=np.float64)
            y = np.zeros(cap, dtype=np.float64)
            mask = np.zeros(cap, dtype=np.float64)
            X[:n], y[:n], mask[:n] = Xa, ya, 1.0
            self._aug_padded = (X, y, mask)
        return self._aug_padded

    def snapshot(self) -> "CacheSnapshot":
        """Frozen read view for off-lock sampler compute.  Take it under
        the shard lock; use it anywhere."""
        return CacheSnapshot(self)


class CacheSnapshot:
    """Immutable point-in-time view of an ``ObservationCache``.

    Exposes the same read surface the samplers consume (``count``,
    ``observations``/``augmented``/``padded``/``padded_augmented``,
    ``liar_value``, ``token``) plus the storage ``version`` the cache
    was synced at — the tag a speculative proposal buffer is published
    under.  The underlying arrays are the cache's memoized copies
    (fancy-index copies / fresh concatenations, never the live append
    buffers), so reading them off the shard lock is safe; the padded
    views are materialized eagerly for the same reason.
    """

    __slots__ = ("version", "count", "pending_count", "token", "liar",
                 "_obs", "_aug", "_padded", "_aug_padded", "_lv")

    def __init__(self, cache: ObservationCache):
        self.version = cache.version
        self.count = cache.count
        self.pending_count = cache.pending_count
        self.token = cache.token
        self.liar = cache.liar
        self._obs = cache.observations()
        self._aug = cache.augmented()
        self._padded = cache.padded()
        self._aug_padded = cache.padded_augmented()
        self._lv = cache.liar_value()

    def observations(self) -> tuple[np.ndarray, np.ndarray]:
        return self._obs

    def augmented(self) -> tuple[np.ndarray, np.ndarray]:
        return self._aug

    def padded(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self._padded

    def padded_augmented(self) -> tuple[np.ndarray, np.ndarray,
                                        np.ndarray]:
        return self._aug_padded

    def liar_value(self) -> float | None:
        return self._lv

    def with_fantasies(self, X_unit: np.ndarray) -> "CacheSnapshot":
        """A new snapshot with ``X_unit`` rows appended as liar-imputed
        pending rows — the speculative precompute uses this to chain
        the constant-liar across streamed proposal slices (slice i+1 is
        repelled from slice i the same way a live ask is repelled from
        in-flight trials).  No-op view of the same observed data; the
        liar value and version tag are unchanged."""
        k = len(X_unit)
        if k == 0 or self._lv is None:
            return self
        out = object.__new__(CacheSnapshot)
        out.version = self.version
        out.count = self.count
        out.pending_count = self.pending_count + k
        # distinct token -> samplers memoizing on (id, token) can never
        # confuse the extended view with its parent
        out.token = (self.token[0], self.token[1] + k)
        out.liar = self.liar
        out._obs = self._obs
        out._lv = self._lv
        Xa, ya = self._aug
        Xa = np.concatenate([Xa, np.asarray(X_unit, dtype=np.float64)])
        ya = np.concatenate([ya, np.full(k, self._lv)])
        out._aug = (Xa, ya)
        out._padded = self._padded
        n = len(ya)
        cap = pad_pow2(n)
        Xp = np.zeros((cap, Xa.shape[1]), dtype=np.float64)
        yp = np.zeros(cap, dtype=np.float64)
        mask = np.zeros(cap, dtype=np.float64)
        Xp[:n], yp[:n], mask[:n] = Xa, ya, 1.0
        out._aug_padded = (Xp, yp, mask)
        return out
