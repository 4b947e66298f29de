"""Core datatypes for the HOPAAS service.

Terminology follows the paper (sec. 2):
  * a *trial* is a single training attempt with a specific set of
    hyperparameters to test;
  * a *study* represents an optimization session and includes a collection
    of trials.  A study is unambiguously defined by the set of
    hyperparameters to optimize, their ranges, and the search modality
    (sampler + pruner + direction).
"""
from __future__ import annotations

import dataclasses
import enum
import hashlib
import json
import time
from typing import Any


class TrialState(str, enum.Enum):
    RUNNING = "running"
    COMPLETED = "completed"
    PRUNED = "pruned"
    FAILED = "failed"      # lease expired / worker died


class Direction(str, enum.Enum):
    MINIMIZE = "minimize"
    MAXIMIZE = "maximize"


@dataclasses.dataclass
class Trial:
    """A single hyperparameter evaluation, tracked server-side."""

    trial_id: int                      # index within the study
    uid: str                           # globally unique "study_key:trial_id"
    study_key: str
    params: dict[str, Any]
    state: TrialState = TrialState.RUNNING
    value: float | None = None
    # multi-objective studies (paper sec. 5 future work): one value per
    # objective; ``value`` then mirrors values[0] for display
    values: list[float] | None = None
    # step -> intermediate objective value (fed through should_prune)
    intermediates: dict[int, float] = dataclasses.field(default_factory=dict)
    worker_id: str | None = None
    lease_deadline: float | None = None   # epoch seconds; None = no lease
    created_at: float = dataclasses.field(default_factory=time.time)
    finished_at: float | None = None
    # bookkeeping for fault tolerance: how many times these params were
    # re-enqueued after a worker died mid-trial
    retries: int = 0

    def last_step(self) -> int:
        return max(self.intermediates) if self.intermediates else -1

    @classmethod
    def tombstone(cls, study_key: str, trial_id: int) -> "Trial":
        """Explicit placeholder for a journal gap: a FAILED trial that holds
        the slot so uid->trial lookups of later trials stay aligned."""
        t = cls(trial_id=trial_id, uid=f"{study_key}:{trial_id}",
                study_key=study_key, params={}, state=TrialState.FAILED)
        t.finished_at = t.created_at
        return t

    def to_record(self) -> dict[str, Any]:
        # hot path: journaled on every add/update.  dataclasses.asdict
        # deep-copies recursively (~100us per call); the explicit dict is
        # equivalent for this flat record (params/intermediates values
        # are scalars) at a fraction of the cost.
        return {"trial_id": self.trial_id, "uid": self.uid,
                "study_key": self.study_key, "params": dict(self.params),
                "state": self.state.value, "value": self.value,
                "values": (None if self.values is None
                           else list(self.values)),
                "intermediates": dict(self.intermediates),
                "worker_id": self.worker_id,
                "lease_deadline": self.lease_deadline,
                "created_at": self.created_at,
                "finished_at": self.finished_at, "retries": self.retries}

    @classmethod
    def from_record(cls, d: dict[str, Any]) -> "Trial":
        d = dict(d)
        d["state"] = TrialState(d["state"])
        d["intermediates"] = {int(k): float(v) for k, v in d["intermediates"].items()}
        return cls(**d)


@dataclasses.dataclass
class StudyConfig:
    """Everything that unambiguously defines a study (paper sec. 2)."""

    name: str
    # hyperparameter name -> serialized space spec (see repro_torch.core.space)
    properties: dict[str, Any]
    direction: Direction = Direction.MINIMIZE
    sampler: dict[str, Any] = dataclasses.field(default_factory=lambda: {"name": "tpe"})
    pruner: dict[str, Any] = dataclasses.field(default_factory=lambda: {"name": "none"})
    # multi-objective: per-objective directions; None = single-objective
    directions: list[str] | None = None

    @property
    def n_objectives(self) -> int:
        return len(self.directions) if self.directions else 1

    def direction_signs(self) -> list[float]:
        """+1 per minimized objective, -1 per maximized."""
        if self.directions is None:
            return [1.0 if self.direction == Direction.MINIMIZE else -1.0]
        return [1.0 if Direction(d) == Direction.MINIMIZE else -1.0
                for d in self.directions]

    def key(self) -> str:
        """Content hash used by the server to route `ask` requests."""
        blob = json.dumps(
            {
                "name": self.name,
                "properties": self.properties,
                "direction": self.direction.value,
                "sampler": self.sampler,
                "pruner": self.pruner,
                "directions": self.directions,
            },
            sort_keys=True,
        )
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def to_record(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["direction"] = self.direction.value
        return d

    @classmethod
    def from_record(cls, d: dict[str, Any]) -> "StudyConfig":
        d = dict(d)
        d["direction"] = Direction(d["direction"])
        return cls(**d)


@dataclasses.dataclass
class Study:
    config: StudyConfig
    trials: list[Trial] = dataclasses.field(default_factory=list)
    created_at: float = dataclasses.field(default_factory=time.time)
    # -- runtime read-path indices (never serialized) -------------------
    # step -> {trial_uid -> latest reported value}; lets the median /
    # percentile / SHA pruner heartbeats aggregate over "who reported at
    # this step" without scanning every trial's intermediates dict.
    _step_reports: dict[int, dict[str, float]] | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    _last_steps: dict[str, int] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)
    # (resource, sign) -> {uid -> best sign*value within the resource};
    # built on first SHA/hyperband query, then maintained per report
    _rung_cache: dict[tuple[int, float], dict[str, float]] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)
    _indexed_trials: int = dataclasses.field(
        default=0, init=False, repr=False, compare=False)
    # True only for studies owned by a storage layer, which routes every
    # mutation through record_report/note_trial_added under the shard
    # lock — the precondition for trusting the incremental indices
    _managed: bool = dataclasses.field(
        default=False, init=False, repr=False, compare=False)

    @property
    def key(self) -> str:
        return self.config.key()

    # -- snapshot serialization ----------------------------------------
    # The storage engine's point-in-time snapshots serialize whole
    # studies; the runtime read-path indices are derived state and are
    # rebuilt on load, never serialized.
    def to_record(self) -> dict[str, Any]:
        return {"config": self.config.to_record(),
                "created_at": self.created_at,
                "trials": [t.to_record() for t in self.trials]}

    @classmethod
    def from_record(cls, d: dict[str, Any]) -> "Study":
        return cls(config=StudyConfig.from_record(d["config"]),
                   trials=[Trial.from_record(t) for t in d["trials"]],
                   created_at=d["created_at"])

    # -- incremental report index --------------------------------------
    # Maintained by the storage layer under the shard lock: every
    # ``update_trial(intermediate=...)`` calls ``record_report`` and every
    # ``add_trial`` calls ``note_trial_added``.  Studies built by hand
    # (tests, library use) are not managed and rebuild the index on every
    # query — the pre-cache live-scan semantics, so direct mutation of
    # ``trial.intermediates`` is always observed.
    def _ensure_index(self) -> None:
        if (self._managed and self._step_reports is not None
                and self._indexed_trials == len(self.trials)):
            return
        idx: dict[int, dict[str, float]] = {}
        last: dict[str, int] = {}
        for t in self.trials:
            for s, v in t.intermediates.items():
                idx.setdefault(s, {})[t.uid] = v
            if t.intermediates:
                last[t.uid] = max(t.intermediates)
        self._step_reports = idx
        self._last_steps = last
        self._rung_cache = {}
        self._indexed_trials = len(self.trials)

    def note_trial_added(self) -> None:
        """O(1) index maintenance for a freshly created (report-less) trial."""
        if (self._managed and self._step_reports is not None
                and self._indexed_trials == len(self.trials) - 1):
            self._indexed_trials += 1

    def record_report(self, uid: str, step: int, value: float) -> None:
        """O(1) index maintenance for one intermediate report."""
        if (not self._managed or self._step_reports is None
                or self._indexed_trials != len(self.trials)):
            return                      # stale: next query rebuilds anyway
        reports = self._step_reports.setdefault(step, {})
        re_report = uid in reports
        reports[uid] = value
        if step > self._last_steps.get(uid, -1):
            self._last_steps[uid] = step
        for (resource, sign), rung in self._rung_cache.items():
            if step + 1 > resource:
                continue
            if not re_report:
                sv = sign * value
                if sv < rung.get(uid, float("inf")):
                    rung[uid] = sv
            else:
                # a step's value was *replaced* (client retry): the min is
                # not incrementally updatable, recompute this uid's entry
                # from its latest-per-step reports
                rung[uid] = min(
                    sign * reps[uid]
                    for s, reps in self._step_reports.items()
                    if s + 1 <= resource and uid in reps)

    def reports_at(self, step: int) -> dict[str, float]:
        """{trial_uid: latest value reported at ``step``} from the index."""
        self._ensure_index()
        return self._step_reports.get(step, {})

    def _rung_snapshot(self, resource: int, sign: float) -> dict[str, float]:
        self._ensure_index()
        key = (int(resource), float(sign))
        snap = self._rung_cache.get(key)
        if snap is None:
            snap = {}
            for s, reports in self._step_reports.items():
                if s + 1 <= resource:
                    for uid, v in reports.items():
                        sv = sign * v
                        if sv < snap.get(uid, float("inf")):
                            snap[uid] = sv
            self._rung_cache[key] = snap
        return snap

    def rung_value(self, uid: str, resource: int, sign: float) -> float | None:
        """Best sign*value ``uid`` achieved within ``resource`` steps."""
        return self._rung_snapshot(resource, sign).get(uid)

    def rung_competitors(self, resource: int, sign: float,
                         exclude_uid: str) -> list[float]:
        """Rung values of every *other* trial that reached the rung."""
        snap = self._rung_snapshot(resource, sign)
        last = self._last_steps
        return [v for uid, v in snap.items()
                if uid != exclude_uid and last.get(uid, -1) + 1 >= resource]

    def completed(self) -> list[Trial]:
        return [t for t in self.trials if t.state == TrialState.COMPLETED]

    def best_trial(self) -> Trial | None:
        done = [t for t in self.completed() if t.value is not None]
        if not done:
            return None
        sign = 1.0 if self.config.direction == Direction.MINIMIZE else -1.0
        return min(done, key=lambda t: sign * t.value)

    def pareto_front(self) -> list[Trial]:
        """Non-dominated completed trials (multi-objective studies)."""
        signs = self.config.direction_signs()
        done = [t for t in self.completed() if t.values is not None
                and len(t.values) == len(signs)]
        front: list[Trial] = []
        for t in done:
            tv = [s * v for s, v in zip(signs, t.values)]
            dominated = False
            for o in done:
                if o is t:
                    continue
                ov = [s * v for s, v in zip(signs, o.values)]
                if all(a <= b for a, b in zip(ov, tv)) and \
                        any(a < b for a, b in zip(ov, tv)):
                    dominated = True
                    break
            if not dominated:
                front.append(t)
        return front
