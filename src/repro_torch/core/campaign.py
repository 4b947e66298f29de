"""Multi-worker optimization campaigns (paper sec. 4).

Drives N concurrent HOPAAS clients — the stand-in for the >20 heterogeneous
MARCONI-100 / INFN-Cloud / GCP nodes of the paper — against one service.
Workers are *elastic*: they can join late, leave early, or die mid-trial
(``failure_rate``); the server's lease/requeue machinery absorbs all of it.

``transport_factory`` is called once per worker.  It may return a fresh
transport each time (one socket per node — the distributed shape) or
one shared ``PooledHttpTransport`` (all workers draw from a bounded
keep-alive pool; checkout/checkin keeps concurrent workers off each
other's sockets without opening N connections).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable

import numpy as np

from .client import Client, HopaasError, Study, Trial
from .transport import Transport
from .types import Direction, StudyConfig


def _safe_tell(study: Study, trial: Trial, value: float | None,
               state: str | None) -> None:
    try:
        study.tell(trial, value=value, state=state)
    except HopaasError:
        pass      # server already finalized the trial (lease sweep / prune)

# objective(trial_params, report) -> float, where report(step, value) -> bool
Objective = Callable[[dict[str, Any], Callable[[int, float], bool]], float]


@dataclasses.dataclass
class CampaignResult:
    n_trials: int
    n_completed: int
    n_pruned: int
    n_failed: int
    best_value: float | None
    best_params: dict[str, Any] | None
    wall_seconds: float
    trials_per_worker: dict[str, int]


def run_campaign(objective: Objective, *, study_spec: dict[str, Any],
                 transport_factory: Callable[[], Transport], token: str,
                 n_workers: int = 8, n_trials: int = 64,
                 failure_rate: float = 0.0, stagger_seconds: float = 0.0,
                 batch_size: int = 1, seed: int = 0) -> CampaignResult:
    """Run ``n_trials`` total across ``n_workers`` concurrent workers.

    With ``batch_size > 1`` each worker claims up to ``batch_size`` trials
    per round and uses the batched wire protocol — one ``ask_batch`` round
    trip to suggest them and one ``tell_batch`` to finalize the survivors —
    instead of 2·k sequential round trips.
    """
    counter_lock = threading.Lock()
    issued = {"n": 0}
    per_worker: dict[str, int] = {}
    rng = np.random.default_rng(seed)
    fail_draws = rng.uniform(size=n_trials * 2)
    t0 = time.time()

    def worker(widx: int) -> None:
        if stagger_seconds:
            time.sleep(stagger_seconds * widx)   # elastic late join
        wid = f"node-{widx:02d}"
        client = Client(transport_factory(), token, worker_id=wid)
        study = Study(client=client, **study_spec)
        while True:
            with counter_lock:
                if issued["n"] >= n_trials:
                    return
                k = min(max(1, batch_size), n_trials - issued["n"])
                first_idx = issued["n"]
                issued["n"] += k
                per_worker[wid] = per_worker.get(wid, 0) + k
            trials = study.ask_batch(k) if batch_size > 1 else [study.ask()]
            finished: list[tuple] = []
            for j, trial in enumerate(trials):
                die = (failure_rate > 0
                       and fail_draws[first_idx + j] < failure_rate)

                def report(step: int, value: float, _t=trial) -> bool:
                    return _t.should_prune(step, value)

                try:
                    value = objective(trial.params, report)
                except Exception:
                    finished.append((trial, None, "failed"))
                    continue
                if die:
                    continue      # worker "crashes": never tells -> lease expires
                # a worker may lose the race against the lease sweeper (it
                # was declared dead and its trial requeued); the server's
                # verdict wins — losing this tell is the designed straggler
                # behavior.
                finished.append(
                    (trial, value, "pruned" if trial.pruned else None))
            if batch_size > 1:
                try:
                    study.tell_batch(finished)
                except HopaasError:
                    pass          # whole-batch transport failure: leases expire
            else:
                for trial, value, state in finished:
                    _safe_tell(study, trial, value, state)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    # summarize through the service API (what the web UI would show):
    # the study key is content-addressed, so it can be derived locally and
    # its v2 resource fetched directly — a pure read (no study list scan,
    # and no accidental create if every worker died before its first ask)
    client = Client(transport_factory(), token)
    probe = Study(client=client, **study_spec)
    key = StudyConfig(
        name=probe.name, properties=probe.properties,
        direction=Direction(probe.direction), sampler=probe.sampler,
        pruner=probe.pruner, directions=probe.directions).key()
    try:
        s: dict[str, Any] = client.study(key)
    except HopaasError:
        s = {}
    return CampaignResult(
        n_trials=s.get("n_trials", 0), n_completed=s.get("n_completed", 0),
        n_pruned=s.get("n_pruned", 0), n_failed=s.get("n_failed", 0),
        best_value=s.get("best_value"), best_params=s.get("best_params"),
        wall_seconds=time.time() - t0, trials_per_worker=per_worker)
