"""Study reporting — the CSV/ASCII stand-in for the paper's web dashboard."""
from __future__ import annotations

import json
from typing import Any

from .types import Direction, Study, TrialState


def convergence_trace(study: Study) -> list[float]:
    """Best-so-far objective after each completed trial (ordered by finish)."""
    sign = 1.0 if study.config.direction == Direction.MINIMIZE else -1.0
    done = sorted(study.completed(), key=lambda t: t.finished_at or 0.0)
    best, trace = float("inf"), []
    for t in done:
        best = min(best, sign * t.value)
        trace.append(sign * best)
    return trace


def study_summary(study: Study) -> dict[str, Any]:
    best = study.best_trial()
    states = [t.state for t in study.trials]
    return {
        "name": study.config.name,
        "key": study.key,
        "direction": study.config.direction.value,
        "sampler": study.config.sampler,
        "pruner": study.config.pruner,
        "n_trials": len(study.trials),
        "n_completed": states.count(TrialState.COMPLETED),
        "n_pruned": states.count(TrialState.PRUNED),
        "n_failed": states.count(TrialState.FAILED),
        "n_running": states.count(TrialState.RUNNING),
        "best_value": None if best is None else best.value,
        "best_params": None if best is None else best.params,
        "total_steps": sum(len(t.intermediates) for t in study.trials),
    }


def format_report(study: Study) -> str:
    s = study_summary(study)
    lines = [f"study {s['name']} [{s['key']}]  direction={s['direction']}",
             f"  sampler={s['sampler']}  pruner={s['pruner']}",
             f"  trials: {s['n_trials']} total | {s['n_completed']} completed | "
             f"{s['n_pruned']} pruned | {s['n_failed']} failed | {s['n_running']} running",
             f"  best value: {s['best_value']}",
             f"  best params: {json.dumps(s['best_params'], default=str)}"]
    return "\n".join(lines)
