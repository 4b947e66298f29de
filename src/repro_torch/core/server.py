"""The HOPAAS server: ask / tell / should_prune / version (paper Table 1),
the batched ask_batch / tell_batch extension, and the v2 resource surface.

The wire layer is declarative (``repro_torch.core.api``): routes are data —
method + path template + typed schemas — dispatched by a router that
enforces validation, header auth, 405-with-Allow, and structured error
envelopes *before* a handler runs.  ``HopaasServer`` itself exposes
transport-independent core operations (``op_ask``/``op_tell``/...) that
raise ``ApiError`` for client failures; the v1 compat shim and the v2
resource routes are both thin adapters over the same ops, mounted by
``api.build_router``.

``handle_request(method, path, body, headers)`` is the full entry point
(status, payload, response headers); ``handle(method, path, body)`` is
the pre-router signature kept for in-process callers.  Multiple
``HopaasServer`` *workers* may share one storage object, reproducing the
paper's "scalable set of Uvicorn instances + shared PostgreSQL"
architecture.

Sharding: the server holds one ``StudyContext`` per study — sampler,
pruner, decoded search space, a per-study RNG, the storage shard's
lock, and an incremental ``ObservationCache``.  All request handling
serializes on the *per-study* lock, so requests for different studies
proceed fully in parallel; there is no global server lock.  Lease
expiry is driven by the storage's per-study deadline min-heap, so
sweeps touch only expired entries instead of scanning every trial.

Hot-path cost model: `ask` syncs the observation cache (O(1) when
nothing completed, O(new) otherwise — never a history rescan) and hands
it to the sampler; intermediate reports aggregate over the study's
per-step indices; study summaries read the incrementally raced
incumbent; paginated trial listings answer from the per-state uid
buckets.  Nothing on the request path scales with trial count.

Fault tolerance beyond the paper's text (needed for 1000+-node campaigns):
  * every RUNNING trial carries a *lease*; intermediate reports act as
    heartbeats that renew it;
  * `sweep_expired()` marks trials whose lease lapsed as FAILED and
    re-enqueues their parameters so another worker picks them up (straggler
    mitigation / elastic membership);
  * all state mutations flow through the (journaled) storage, so a service
    restart resumes every study where it left off.
"""
from __future__ import annotations

import atexit
import dataclasses
import math
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Callable

import numpy as np

from . import faults
from .api import ApiError, build_openapi, build_router
from .api.router import Router
from .auth import TokenManager
from .kernels import launch_counts, resolve_device
from .obs_cache import ObservationCache
from .pruners import make_pruner
from .samplers import make_sampler
from .space import SearchSpace
from .speculate import SpeculativeQueue, SpeculativeWorker
from .storage import InMemoryStorage
from .types import Direction, StudyConfig, Trial, TrialState

HOPAAS_VERSION = "1.1.0-jax"

# the exact key set (and order) of a pre-router /api/studies record —
# the v1 shim projects the richer v2 resource down to this
_V1_STUDY_KEYS = ("key", "name", "n_trials", "n_completed", "n_pruned",
                  "n_failed", "best_value", "best_params")


def _default_storage() -> InMemoryStorage:
    """Storage for servers constructed without one.

    ``REPRO_STORAGE=durable`` switches the default to a ``DurableStorage``
    in a throwaway directory (fsync off — the point is exercising the
    engine's WAL/snapshot/recovery code paths, not disk latency).  CI
    runs the tier-1 suite a second time under this flag so every test
    that builds a bare ``HopaasServer()`` also drives the journaled
    engine.
    """
    mode = os.environ.get("REPRO_STORAGE", "memory")
    if mode.startswith("durable"):
        from .durable import DurableStorage
        root = tempfile.mkdtemp(prefix="hopaas-durable-")
        storage = DurableStorage(root, fsync="off",
                                 segment_bytes=256 * 1024)
        atexit.register(shutil.rmtree, root, ignore_errors=True)
        return storage
    return InMemoryStorage()


def _default_speculate_depth() -> int:
    """Depth of the per-study speculative proposal buffer, from the
    ``REPRO_SPECULATE`` env (0 = off).  Off by default: a bare server's
    proposals must not depend on background-thread timing — speculation
    is opted into per deployment (``--speculate-depth``), per server
    (ctor arg), or per fleet (env, inherited by fabric workers)."""
    try:
        return max(0, int(os.environ.get("REPRO_SPECULATE", "0") or 0))
    except ValueError:
        return 0


def _require_finite_value(value: float | None, field: str = "value") -> None:
    """Non-finite objectives never reach storage: NaN corrupts incumbent
    comparisons and bare NaN/Infinity is invalid strict JSON for the WAL.
    The wire schemas already reject these with a 422; this guards the
    direct in-process op_* callers the same way."""
    if value is not None and not math.isfinite(value):
        raise ApiError(422, "invalid_value",
                       f"field {field!r} must be finite, got {value!r}",
                       field=field)


@dataclasses.dataclass
class StudyContext:
    """Per-study shard of the server: everything `ask`/`tell`/`should_prune`
    need, guarded by the storage shard's lock (shared across workers)."""

    key: str
    config: StudyConfig
    space: SearchSpace
    sampler: Any
    pruner: Any
    lock: threading.RLock
    rng: np.random.Generator
    # incremental (X, y) featurization of this study's observations —
    # synced from the storage's completion log under the shard lock, so
    # ask cost no longer scales with history length
    cache: ObservationCache
    # speculative ask pipeline (None when speculation is off or the
    # sampler cannot precompute): version-tagged proposal buffer drained
    # by op_ask, refilled off-lock by the server's SpeculativeWorker
    spec: SpeculativeQueue | None = None
    # dedicated sampler instance for the precompute thread (built
    # lazily): the request path's sampler memos must never be touched
    # from two threads
    spec_sampler: Any = None
    # precompute round counter — seeds a dedicated rng stream per round,
    # disjoint from ctx.rng (which stays single-threaded on the request
    # path); guarded by ctx.lock
    spec_round: int = 0
    # largest worker-fleet size hint seen on an ask (the v2
    # ``parallelism`` field): raises the effective precompute depth so
    # the buffer covers one full wave of concurrent asks
    parallelism: int = 0


class HopaasServer:
    # precompute rounds publish in slices of at least this many
    # proposals so the first supply lands in the queue while the tail
    # of the round is still computing; each slice is one fused sampler
    # evaluation, so fewer/larger slices also mean faster rounds (the
    # background thread is GIL-starved under a contended fleet and
    # supply rate, not latency, bounds the queue hit rate)
    _SPECULATE_SLICE = 32

    def __init__(self, storage: InMemoryStorage | None = None,
                 tokens: TokenManager | None = None,
                 lease_seconds: float = 60.0, max_retries: int = 3,
                 seed: int = 0, worker_name: str = "worker-0",
                 speculate_depth: int | None = None,
                 speculate_staleness: int | None = None,
                 device: str | None = None):
        # where TPE and GP compute: a server setting, never part of the
        # study spec (so it reaches neither StudyConfig, the WAL nor
        # state_digest); None -> the CUDA device, raising if absent
        self.device = resolve_device(device)
        self.storage = storage or _default_storage()
        self.tokens = tokens or TokenManager()
        self.lease_seconds = float(lease_seconds)
        self.max_retries = int(max_retries)
        self.worker_name = worker_name
        self._seed = int(seed)
        self._contexts: dict[str, StudyContext] = {}
        self._ctx_lock = threading.Lock()      # guards context creation only
        self._router: Router | None = None
        self.speculate_depth = (_default_speculate_depth()
                                if speculate_depth is None
                                else max(0, int(speculate_depth)))
        # proposals computed <= this many storage versions ago still
        # drain (the liar rows already anticipated the in-flight trials
        # behind most bumps — registrations, lease renewals, tells).
        # None -> dynamic: scales with the fleet-size hint, since a
        # 256-worker wave legitimately bumps the version ~512 times
        # between a proposal's compute and its drain
        self.speculate_staleness = (None if speculate_staleness is None
                                    else max(0, int(speculate_staleness)))
        self._speculator: SpeculativeWorker | None = None
        if self.speculate_depth > 0:
            self._speculator = SpeculativeWorker(
                self._precompute_study,
                name=f"speculate-{worker_name}")

    def close(self) -> None:
        """Stop the speculative precompute thread (no-op when off)."""
        if self._speculator is not None:
            self._speculator.stop()
            self._speculator = None

    # ------------------------------------------------------------------ #
    # wire entry points
    # ------------------------------------------------------------------ #
    @property
    def router(self) -> Router:
        if self._router is None:
            self._router = build_router(self)
        return self._router

    def handle_request(self, method: str, path: str, body: Any = None,
                       headers: dict[str, str] | None = None,
                       body_error: str | None = None
                       ) -> tuple[int, dict[str, Any], dict[str, str]]:
        """Full dispatch: (status, payload, response headers)."""
        return self.router.dispatch(method, path, body, headers, body_error)

    def handle(self, method: str, path: str, body: dict[str, Any] | None = None
               ) -> tuple[int, dict[str, Any]]:
        """Pre-router signature kept for in-process callers and tests."""
        status, payload, _ = self.handle_request(method, path, body)
        return status, payload

    def openapi_document(self) -> dict[str, Any]:
        return build_openapi(self.router, HOPAAS_VERSION)

    # ------------------------------------------------------------------ #
    # per-study contexts
    # ------------------------------------------------------------------ #
    def _build_context(self, key: str, config: StudyConfig) -> StudyContext:
        space = SearchSpace.from_properties(config.properties)
        sampler = make_sampler(config.sampler, device=self.device)
        # the cache maintains the pending (constant-liar) view only for
        # samplers that consume it — everyone else keeps the exact
        # pre-liar behaviour and sync cost
        liar = (getattr(sampler, "liar", "none")
                if getattr(sampler, "pending_aware", False) else "none")
        speculative = (self._speculator is not None
                       and getattr(sampler, "uses_cache", False)
                       and liar != "none")
        return StudyContext(
            key=key, config=config, space=space,
            sampler=sampler,
            pruner=make_pruner(config.pruner),
            lock=self.storage.study_lock(key),
            # per-study stream: concurrent asks on different studies must
            # not share one (non-thread-safe) Generator
            rng=np.random.default_rng([self._seed, int(key[:8], 16)]),
            cache=ObservationCache(space, config.direction, liar=liar),
            spec=SpeculativeQueue() if speculative else None)

    def _context(self, config: StudyConfig) -> tuple[StudyContext, bool]:
        study, created = self.storage.get_or_create_study(config)
        key = study.key
        with self._ctx_lock:
            ctx = self._contexts.get(key)
            if ctx is None:
                ctx = self._build_context(key, study.config)
                self._contexts[key] = ctx
        return ctx, created

    def evict_context(self, study_key: str) -> None:
        """Forget the cached per-study context (sampler state, observation
        cache, resource cache).  Required when a shard is dropped from the
        backing storage (fabric handoff): a re-adopted study must rebuild
        its context against the new shard, not serve from the stale one."""
        with self._ctx_lock:
            self._contexts.pop(study_key, None)

    def _context_for_key(self, study_key: str) -> StudyContext | None:
        """Context for a study possibly created by another worker."""
        with self._ctx_lock:
            ctx = self._contexts.get(study_key)
        if ctx is not None:
            return ctx
        study = self.storage.get_study(study_key)
        if study is None:
            return None
        with self._ctx_lock:
            ctx = self._contexts.get(study_key)
            if ctx is None:
                ctx = self._build_context(study_key, study.config)
                self._contexts[study_key] = ctx
        return ctx

    # ------------------------------------------------------------------ #
    # study resolution + config validation
    # ------------------------------------------------------------------ #
    @staticmethod
    def _study_config(body: dict[str, Any]) -> StudyConfig:
        return StudyConfig(
            name=body.get("name", "unnamed"),
            properties=body.get("properties", {}),
            direction=Direction(body.get("direction") or "minimize"),
            sampler=body.get("sampler") or {"name": "tpe"},
            pruner=body.get("pruner") or {"name": "none"},
            directions=body.get("directions"),
        )

    def _validate_config(self, config: StudyConfig) -> None:
        """Dry-run the context pieces so a bad spec is a 422 *before* the
        study is persisted — never a 500 and never a poisoned study."""
        try:
            SearchSpace.from_properties(config.properties)
        except Exception as e:
            raise ApiError(422, "invalid_space",
                           f"invalid search space: {e}", field="properties")
        try:
            # a dry run checks the spec only and launches nothing, so it
            # is built on the CPU and never touches the card
            make_sampler(config.sampler, device="cpu")
        except Exception as e:
            raise ApiError(422, "invalid_sampler", str(e), field="sampler")
        try:
            make_pruner(config.pruner)
        except Exception as e:
            raise ApiError(422, "invalid_pruner", str(e), field="pruner")

    def op_resolve_study(self, spec: dict[str, Any]
                         ) -> tuple[StudyContext, bool]:
        """Create-or-get the study a spec describes (content-addressed)."""
        config = self._study_config(spec)
        if self.storage.get_study(config.key()) is None:
            self._validate_config(config)
        return self._context(config)

    # ------------------------------------------------------------------ #
    # resource serialization
    # ------------------------------------------------------------------ #
    @staticmethod
    def trial_resource(t: Trial) -> dict[str, Any]:
        return {"uid": t.uid, "trial_id": t.trial_id,
                "study_key": t.study_key, "params": t.params,
                "state": t.state.value, "value": t.value, "values": t.values,
                "worker_id": t.worker_id, "retries": t.retries,
                "last_step": t.last_step(), "created_at": t.created_at,
                "finished_at": t.finished_at}

    def study_resource(self, study) -> dict[str, Any]:
        key = study.key
        with self.storage.study_lock(key):
            counts = self.storage.counts(key)
            # incumbent is tracked incrementally on tell — no scan
            best = self.storage.best_trial(key)
            res: dict[str, Any] = {
                "key": key, "name": study.config.name,
                "n_trials": len(study.trials),
                "n_completed": counts[TrialState.COMPLETED],
                "n_pruned": counts[TrialState.PRUNED],
                "n_failed": counts[TrialState.FAILED],
                "best_value": None if best is None else best.value,
                "best_params": None if best is None else best.params,
            }
            if study.config.directions:
                res["pareto_front"] = [
                    {"params": t.params, "values": t.values}
                    for t in study.pareto_front()]
            res.update({
                "n_running": counts[TrialState.RUNNING],
                "direction": study.config.direction.value,
                "directions": study.config.directions,
                "sampler": study.config.sampler.get("name", "tpe"),
                "pruner": study.config.pruner.get("name", "none"),
                # shard mutation counter: mutations replay identically, so
                # the resource stays equal across a crash-restart recovery
                "data_version": self.storage.data_version(key),
            })
        return res

    # ------------------------------------------------------------------ #
    # core operations (raise ApiError on client failures)
    # ------------------------------------------------------------------ #
    # fabric workers replace this with a callable merging their
    # role/epoch/replication view into the health resource
    health_hook: Callable[[], dict[str, Any]] | None = None

    def _lease_deadline(self) -> float:
        """Lease stamp for a suggested/heartbeating trial.  The
        ``lease_skew`` fault point simulates a skewed clock here without
        touching the system clock."""
        return time.time() + self.lease_seconds + faults.skew("lease_skew")

    def op_version(self) -> dict[str, Any]:
        return {"version": HOPAAS_VERSION}

    def op_health(self) -> dict[str, Any]:
        """Machine-readable readiness (``GET /api/v2/health``): role,
        lease epoch, replication lag, WAL/fsync stats — what a load
        balancer or the fabric monitor needs to pick a backend."""
        stats = self.storage.storage_stats()
        storage_keys = ("backend", "n_studies", "fsync", "wal_records",
                        "wal_bytes", "fsyncs", "group_commits",
                        "active_segment", "snapshot_covers")
        health: dict[str, Any] = {
            "status": "ok",
            "version": HOPAAS_VERSION,
            "worker": self.worker_name,
            "role": "leader",
            "epoch": int(getattr(self.storage, "lease_epoch", 0)),
            "replication": stats.get("replication"),
            "storage": {k: stats[k] for k in storage_keys if k in stats},
            "speculation": self.speculation_stats(),
            # where this process's samplers compute, and its acquisition
            # kernel launches (a fabric worker's are its own process's)
            "device": {"type": self.device.type,
                       "kernel_launches": launch_counts()},
        }
        hook = self.health_hook
        if hook is not None:
            health.update(hook() or {})
        return health

    def op_version_v2(self) -> dict[str, Any]:
        """v2 version resource: adds the storage/durability stats (the v1
        payload is byte-frozen to ``{"version": ...}``)."""
        stats = dict(self.storage.storage_stats())
        stats["speculation"] = self.speculation_stats()
        return {"version": HOPAAS_VERSION, "storage": stats}

    def op_create_study(self, spec: dict[str, Any]
                        ) -> tuple[bool, dict[str, Any]]:
        ctx, created = self.op_resolve_study(spec)
        return created, self.study_resource(self.storage.get_study(ctx.key))

    def op_get_study(self, key: str) -> dict[str, Any]:
        study = self.storage.get_study(key)
        if study is None:
            raise ApiError(404, "study_not_found", f"unknown study {key!r}")
        return self.study_resource(study)

    def op_list_studies(self, cursor: int | None = None, limit: int = 100
                        ) -> tuple[list[dict[str, Any]], int | None]:
        studies = self.storage.studies()      # registry order (stable)
        start = 0 if cursor is None else int(cursor) + 1
        page = studies[start:start + limit]
        next_cursor = (start + len(page) - 1) if len(page) == limit else None
        return [self.study_resource(s) for s in page], next_cursor

    def op_list_trials(self, key: str, state: str | None = None,
                       cursor: int | None = None, limit: int = 100
                       ) -> tuple[list[dict[str, Any]], int | None]:
        page = self.storage.trials_page(
            key, state=None if state is None else TrialState(state),
            cursor=cursor, limit=limit)
        if page is None:
            raise ApiError(404, "study_not_found", f"unknown study {key!r}")
        trials, next_cursor = page
        return [self.trial_resource(t) for t in trials], next_cursor

    def op_get_trial(self, uid: str) -> dict[str, Any]:
        trial = self.storage.get_trial(uid)
        if trial is None:
            raise ApiError(404, "trial_not_found", f"unknown trial {uid!r}")
        return self.trial_resource(trial)

    def op_ask(self, study_key: str, worker_id: str | None, n: int = 1,
               parallelism: int | None = None) -> list[dict[str, Any]]:
        """Suggest ``n`` trials for an *existing* study (v2 path).

        ``parallelism`` is the client's fleet-size hint: the speculative
        precompute sizes its proposal buffer to cover one full wave of
        that many concurrent asks (capped; ignored when speculation is
        off)."""
        ctx = self._context_for_key(study_key)
        if ctx is None:
            raise ApiError(404, "study_not_found",
                           f"unknown study {study_key!r}")
        with ctx.lock:
            if parallelism:
                ctx.parallelism = max(ctx.parallelism,
                                      min(int(parallelism), 4096))
            self._sweep_study(ctx.key, time.time())
            trials = self._start_trials(ctx, n, worker_id)
        return [self.trial_resource(t) for t in trials]

    def op_tell(self, uid: str, value: Any = None,
                state: str = "completed",
                idempotency_key: str | None = None) -> dict[str, Any]:
        # multi-objective: value may be a list (one entry per objective)
        values = None
        if isinstance(value, (list, tuple)):
            values = [float(v) for v in value]
            for i, v in enumerate(values):
                _require_finite_value(v, f"value[{i}]")
            value = values[0]
        elif value is not None:
            _require_finite_value(float(value))
        final_state = TrialState(state or "completed")
        trial = self.storage.get_trial(uid)
        if trial is None:
            raise ApiError(404, "trial_not_found", f"unknown trial {uid!r}")
        with self.storage.study_lock(trial.study_key):
            if idempotency_key:
                prior = self.storage.idempotent_result(
                    trial.study_key, idempotency_key)
                if prior is not None:
                    # a retry of a tell that already applied (lost
                    # response, fabric resend, failover replay): return
                    # the original result — exactly-once, never a 409
                    return dict(prior)
            if trial.state == TrialState.PRUNED:
                # the server already finalized this trial on a report;
                # accept the client's value but keep the PRUNED state.
                out = {"uid": uid, "state": trial.state.value}
                self.storage.update_trial(
                    uid, value=(None if value is None else float(value)),
                    values=values,
                    idem=(None if not idempotency_key
                          else (idempotency_key, out)))
            else:
                if trial.state != TrialState.RUNNING:
                    raise ApiError(409, "conflict",
                                   f"trial {uid} already {trial.state.value}")
                out = {"uid": uid, "state": final_state.value}
                # the dedup note rides in the finalize's own WAL record
                # (one atomic unit through recovery, replication, and
                # migration), so a replica can never hold the finalize
                # without the key that makes its retry recognizable
                self.storage.update_trial(
                    uid, value=(None if value is None else float(value)),
                    values=values, state=final_state,
                    finished_at=time.time(), lease_deadline=None,
                    idem=(None if not idempotency_key
                          else (idempotency_key, out)))
        # a finalize is exactly the event that invalidates precomputed
        # proposals: new observation, smaller pending set
        self._notify_speculator(self._peek_context(trial.study_key))
        return out

    def op_tell_batch(self, tells: list[dict[str, Any]]
                      ) -> list[dict[str, Any]]:
        """Per-item finalization: one conflict never fails the batch."""
        results = []
        for item in tells:
            try:
                out = self.op_tell(item.get("trial_uid", ""),
                                   item.get("value"),
                                   item.get("state") or "completed",
                                   item.get("idempotency_key"))
                results.append({"status": 200, **out})
            except ApiError as e:
                results.append({"status": e.status,
                                "uid": item.get("trial_uid", ""),
                                "error": e.payload()["error"]})
        return results

    def op_report(self, uid: str, step: int = 0, value: float = 0.0
                  ) -> dict[str, Any]:
        """Record an intermediate value (lease heartbeat) and return the
        pruning verdict — v1 ``should_prune``."""
        _require_finite_value(float(value))
        trial = self.storage.get_trial(uid)
        if trial is None:
            raise ApiError(404, "trial_not_found", f"unknown trial {uid!r}")
        ctx = self._context_for_key(trial.study_key)
        if ctx is None:
            # the trial exists but its study is not resolvable (e.g. a
            # partially replayed or externally mutated store) — a client
            # error, not a server crash
            raise ApiError(404, "study_not_found",
                           f"study {trial.study_key!r} for trial "
                           f"{uid!r} is not resolvable")
        with ctx.lock:
            if trial.state != TrialState.RUNNING:
                # zombie worker: its lease was revoked (or the trial pruned)
                # while it was away — instruct it to abandon the trial.
                return {"uid": uid, "should_prune": True,
                        "note": f"trial is {trial.state.value}"}
            study = self.storage.get_study(trial.study_key)
            # heartbeat: renew the lease + record the intermediate
            self.storage.update_trial(
                uid, intermediate=(int(step), float(value)),
                lease_deadline=self._lease_deadline())
            prune = bool(ctx.pruner.should_prune(study, trial, int(step)))
            if prune:
                self.storage.update_trial(
                    uid, state=TrialState.PRUNED, finished_at=time.time(),
                    lease_deadline=None)
        if prune:
            self._notify_speculator(ctx)
        return {"uid": uid, "should_prune": prune}

    # ------------------------------------------------------------------ #
    # trial suggestion (shared by v1 and v2 ask paths)
    # ------------------------------------------------------------------ #
    def _start_trials(self, ctx: StudyContext, n: int,
                      worker_id: str | None) -> list[Trial]:
        """Suggest + register ``n`` trials.  Caller holds ``ctx.lock``."""
        study = self.storage.get_study(ctx.key)
        batch: list[tuple[dict[str, Any], int]] = []    # (params, retries)
        while len(batch) < n:                 # fault-tolerance requeue path
            waiting = self.storage.pop_waiting(ctx.key)
            if waiting is None:
                break
            batch.append((waiting["params"], waiting["retries"]))
        remaining = n - len(batch)
        if remaining and ctx.spec is not None:
            # speculative fast path: drain precomputed proposals.  The
            # version is stable while we hold the shard lock, and a
            # drained proposal is registered through the same journaled
            # add_trial as an inline one — nothing moves off-WAL.
            version = self.storage.data_version(ctx.key)
            bound = self._staleness_bound(ctx)
            while remaining:
                params = ctx.spec.take(version, bound)
                if params is None:
                    break                     # miss -> inline, never block
                batch.append((params, 0))
                remaining -= 1
        if remaining:
            kwargs: dict[str, Any] = {}
            if getattr(ctx.sampler, "multi_objective", False):
                kwargs["signs"] = ctx.config.direction_signs()
            if getattr(ctx.sampler, "uses_cache", False):
                # O(1) when nothing completed since the last ask; O(new)
                # otherwise — never a rescan of the trial list
                kwargs["cache"] = ctx.cache.sync(self.storage, ctx.key)
            # cooperative overprovisioning: a miss already pays the
            # lock + KDE cost for a top-1 draw, and widening the same
            # fused evaluation to top-(1+extra) is nearly free — the
            # surplus publishes at the current version, so the next
            # wave of asks drains exact hits instead of missing too.
            # This is what keeps the queue fed under heavy contention:
            # the lone background thread is GIL-starved by the very
            # fleet it serves, while the miss path's compute budget
            # scales with demand by construction.
            extra = 0
            if (ctx.spec is not None and "cache" in kwargs
                    and ctx.sampler.speculative_ready(kwargs["cache"])):
                extra = max(4, min(32, ctx.parallelism // 8))
                if remaining == 1:
                    # single-ask miss (the contended hot path): one
                    # fused draw, no intra-batch re-chunking
                    kwargs["chunk"] = remaining + extra
            if remaining == 1 and not extra:
                params_list = [ctx.sampler.suggest(
                    ctx.space, study.trials, ctx.config.direction, ctx.rng,
                    **kwargs)]
            else:
                params_list = ctx.sampler.suggest_batch(
                    ctx.space, study.trials, ctx.config.direction, ctx.rng,
                    remaining + extra, **kwargs)
            if extra:
                ctx.spec.publish(self.storage.data_version(ctx.key),
                                 params_list[remaining:])
                params_list = params_list[:remaining]
            batch.extend((p, 0) for p in params_list)
        trials = [self.storage.add_trial(
                      ctx.key, params, worker_id=worker_id,
                      lease_deadline=self._lease_deadline(),
                      retries=retries)
                  for params, retries in batch]
        # every ask changes the pending set (and possibly drained the
        # buffer) -> wake the precompute worker to refill against the
        # new view.  The dirty set dedups bursts.
        self._notify_speculator(ctx)
        return trials

    # ------------------------------------------------------------------ #
    # speculative precompute (off-lock proposal pipeline)
    # ------------------------------------------------------------------ #
    def _notify_speculator(self, ctx: StudyContext | None) -> None:
        if ctx is not None and ctx.spec is not None \
                and self._speculator is not None:
            self._speculator.notify(ctx.key)

    def _peek_context(self, study_key: str) -> StudyContext | None:
        """Already-built context, or None — never builds one (the tell/
        sweep notify path must stay allocation-free)."""
        with self._ctx_lock:
            return self._contexts.get(study_key)

    def _staleness_bound(self, ctx: StudyContext) -> int:
        """Max proposal age (in storage versions) the drain accepts.
        A wave of K concurrent asks bumps the version ~2K times (one
        registration + one tell each) between a proposal's compute and
        its drain, so the dynamic bound tracks the fleet-size hint."""
        if self.speculate_staleness is not None:
            return self.speculate_staleness
        return max(64, 8 * max(self.speculate_depth, ctx.parallelism))

    def _precompute_study(self, study_key: str) -> None:
        """SpeculativeWorker callback: regenerate one study's proposal
        buffer.  Snapshot under the shard lock, sample off it."""
        ctx = self._context_for_key(study_key)
        if ctx is None or ctx.spec is None:
            return
        with ctx.lock:
            cache = ctx.cache.sync(self.storage, ctx.key)
            snap = cache.snapshot()
            depth = max(self.speculate_depth, ctx.parallelism)
            round_no = ctx.spec_round
            ctx.spec_round += 1
            sampler = ctx.spec_sampler
            if sampler is None:
                sampler = make_sampler(ctx.config.sampler,
                                       device=self.device)
                ctx.spec_sampler = sampler
        if ctx.spec.depth() >= depth:
            # queue already holds a full wave — don't burn sampler
            # compute on proposals the next publish would only age out;
            # the next drain re-notifies and refills
            return
        if not sampler.speculative_ready(snap):
            # startup (or a size-gated model) falls back to index-based
            # proposals that need the live trial count — inline only
            return
        rng = np.random.default_rng(
            [self._seed, int(study_key[:8], 16), 0x5bec, round_no])
        # stream the round in slices: each slice is one fused sampler
        # evaluation published as soon as it lands (same version -> the
        # queue merges them), then appended to the snapshot as fantasy
        # rows so the next slice is liar-repelled from it.  Total
        # compute matches the monolithic chunked batch — only the
        # publish granularity changes, so contended asks drain the
        # early slices while the tail is still computing instead of
        # missing to inline for the whole round.
        slice_n = max(self._SPECULATE_SLICE, -(-depth // 4))
        view = snap
        done = 0
        while done < depth:
            k = min(slice_n, depth - done)
            proposals = sampler.suggest_batch(
                ctx.space, [], ctx.config.direction, rng, k,
                cache=view, chunk=k)
            if not proposals:
                break
            if not ctx.spec.publish(snap.version, proposals):
                break                         # a newer round already landed
            done += len(proposals)
            if done < depth:
                view = view.with_fantasies(
                    ctx.space.to_unit_matrix(proposals))

    def speculation_stats(self) -> dict[str, Any]:
        """Aggregated speculative-pipeline counters across studies —
        surfaced in ``/api/v2/version`` storage stats and ``/health``."""
        with self._ctx_lock:
            ctxs = list(self._contexts.values())
        out: dict[str, Any] = {
            "enabled": self._speculator is not None,
            "depth": self.speculate_depth,
            # the per-drain bound additionally scales with each study's
            # parallelism hint; this is the floor
            "staleness_limit": (self.speculate_staleness
                                if self.speculate_staleness is not None
                                else max(64, 8 * self.speculate_depth)),
            "hits": 0, "stale_hits": 0, "misses": 0, "published": 0,
            "rejected": 0, "discarded": 0, "queued": 0,
            "pending_trials": 0, "rounds": 0, "errors": 0,
        }
        if self._speculator is not None:
            w = self._speculator.stats()
            out["rounds"], out["errors"] = w["rounds"], w["errors"]
        for ctx in ctxs:
            out["pending_trials"] += ctx.cache.pending_count
            if ctx.spec is not None:
                s = ctx.spec.stats()
                for k in ("hits", "stale_hits", "misses", "published",
                          "rejected", "discarded", "queued"):
                    out[k] += s[k]
        return out

    # ------------------------------------------------------------------ #
    # v1 compat endpoints (byte-compatible success payloads; also the
    # in-process API used by existing tests and tools)
    # ------------------------------------------------------------------ #
    @staticmethod
    def _v1_trial(trial: Trial, study_key: str) -> dict[str, Any]:
        return {"trial_uid": trial.uid, "trial_id": trial.trial_id,
                "study_key": study_key, "properties": trial.params}

    def _ask(self, body: dict[str, Any], identity: dict[str, Any]
             ) -> tuple[int, dict[str, Any]]:
        try:
            ctx, created = self.op_resolve_study(body)
            worker_id = body.get("worker_id") or identity.get("user")
            with ctx.lock:
                self._sweep_study(ctx.key, time.time())
                (trial,) = self._start_trials(ctx, 1, worker_id)
        except ApiError as e:
            return e.status, e.payload()
        payload = self._v1_trial(trial, ctx.key)
        payload["study_created"] = created
        return 200, payload

    def _ask_batch(self, body: dict[str, Any], identity: dict[str, Any]
                   ) -> tuple[int, dict[str, Any]]:
        n = int(body.get("n", 1))
        if n < 1:
            # direct in-process callers only: the wire path rejects this
            # with a schema 422 before the handler runs
            return 400, {"detail": f"batch size must be >= 1, got {n}"}
        try:
            ctx, created = self.op_resolve_study(body)
            worker_id = body.get("worker_id") or identity.get("user")
            with ctx.lock:
                self._sweep_study(ctx.key, time.time())
                trials = self._start_trials(ctx, n, worker_id)
        except ApiError as e:
            return e.status, e.payload()
        return 200, {"trials": [self._v1_trial(t, ctx.key) for t in trials],
                     "study_key": ctx.key, "study_created": created}

    def _tell(self, body: dict[str, Any]) -> tuple[int, dict[str, Any]]:
        try:
            out = self.op_tell(body.get("trial_uid", ""), body.get("value"),
                               body.get("state") or "completed",
                               body.get("idempotency_key"))
        except ApiError as e:
            return e.status, e.payload()
        return 200, {"trial_uid": out["uid"], "state": out["state"]}

    def _tell_batch(self, body: dict[str, Any]) -> tuple[int, dict[str, Any]]:
        tells = body.get("tells")
        if not isinstance(tells, list):
            # direct in-process callers only: the wire path rejects this
            # with a schema 422 before the handler runs
            return 400, {"detail": "tell_batch needs a 'tells' list"}
        results = []
        for item in tells:
            status, payload = self._tell(item or {})
            results.append({"status": status, **payload})
        return 200, {"results": results}

    def _should_prune(self, body: dict[str, Any]
                      ) -> tuple[int, dict[str, Any]]:
        try:
            out = self.op_report(body.get("trial_uid", ""),
                                 int(body.get("step", 0)),
                                 float(body.get("value", 0.0)))
        except ApiError as e:
            return e.status, e.payload()
        payload = {"trial_uid": out["uid"],
                   "should_prune": out["should_prune"]}
        if "note" in out:
            payload["detail"] = out["note"]
        return 200, payload

    def _studies(self) -> tuple[int, dict[str, Any]]:
        out = []
        for s in self.storage.studies():
            res = self.study_resource(s)
            rec = {k: res[k] for k in _V1_STUDY_KEYS}
            if "pareto_front" in res:
                rec["pareto_front"] = res["pareto_front"]
            out.append(rec)
        return 200, {"studies": out}

    # ------------------------------------------------------------------ #
    # fault tolerance
    # ------------------------------------------------------------------ #
    def _sweep_study(self, study_key: str, now: float) -> int:
        """Fail this study's lapsed-lease trials; requeue params (bounded).
        Heap-backed: cost is O(expired · log n), not a trial scan."""
        with self.storage.study_lock(study_key):
            expired = self.storage.pop_expired(study_key, now)
            for t in expired:
                self.storage.update_trial(
                    t.uid, state=TrialState.FAILED, finished_at=now,
                    lease_deadline=None)
                if t.retries < self.max_retries:
                    self.storage.enqueue_params(
                        study_key, t.params, t.retries + 1)
        if expired:
            self._notify_speculator(self._peek_context(study_key))
        return len(expired)

    def sweep_expired(self, study_key: str | None = None) -> int:
        now = time.time()
        keys = ([study_key] if study_key is not None
                else [s.key for s in self.storage.studies()])
        return sum(self._sweep_study(k, now) for k in keys)
