"""pytest plugin: the port's runtime sanitizers over a test session.

    REPRO_TORCH_SANITIZE=1 PYTHONPATH=src python -m pytest \\
        -p repro_torch.analysis.pytest_plugin tests/test_torch_service.py

``REPRO_TORCH_SANITIZE=1`` wraps every lock created from
``src/repro_torch/`` (see :mod:`.sanitize`), records the real
acquisition order while the session runs, and at session end
cross-checks it against the static lock-order graph of
``src/repro_torch/core``: an observed order the static graph can reach
in reverse is a potential deadlock and fails the run.

``REPRO_TORCH_SANITIZE=race`` adds the Eraser-style shared-state
sanitizer over the port's eight configured classes: a field observed
written from two threads with an empty lockset intersection fails the
session.

The sanitizer installs at ``pytest_configure``, before collection
imports the port.  It refuses to start while ``REPRO_SANITIZE`` (the
JAX package's sanitizer, installed by the repo-root ``conftest.py``) is
also set: two sanitizers would both rebind the ``threading`` factories.
"""
from __future__ import annotations

import os

import pytest

ENV = "REPRO_TORCH_SANITIZE"
MODES = ("1", "race")


def _mode() -> str:
    mode = os.environ.get(ENV, "")
    if mode and mode not in MODES:
        raise pytest.UsageError(
            f"{ENV}={mode!r}: expected one of {', '.join(MODES)}")
    if mode and os.environ.get("REPRO_SANITIZE"):
        raise pytest.UsageError(
            f"{ENV} and REPRO_SANITIZE are both set: the JAX package's "
            f"sanitizer (repo-root conftest.py) and the port's would both "
            f"wrap the threading lock factories; unset REPRO_SANITIZE")
    return mode


def pytest_load_initial_conftests(early_config, parser, args):
    # a -p plugin sees this hook before any conftest.py is imported: the
    # refusal comes before the repo-root conftest installs its sanitizer
    _mode()


def pytest_configure(config):
    mode = _mode()
    if not mode:
        return
    from . import sanitize

    sanitize.install()
    if mode == "race":
        sanitize.install_race()


def summary_lines(out: dict, race: dict | None) -> list[str]:
    """The session-end report of :func:`sanitize.cross_check_repo` (and
    of :func:`sanitize.race_report` in race mode), one line each."""
    lines = [
        f"repro-sanitize: {len(out['edges'])} lock-order edge(s) observed "
        f"across {sum(out['locks_created'].values())} instrumented "
        f"lock(s) of {len(out['locks_created'])} lock class(es); "
        f"{len(out['unknown'])} edge(s) not in the static graph, "
        f"{len(out['inversions'])} inversion(s), "
        f"{len(out['stalls'])} stall(s)"]
    unkeyed = sorted(k for k in out["locks_created"] if ".py:" in k)
    if unkeyed:
        lines.append(f"repro-sanitize: note: {len(unkeyed)} lock "
                     f"creation site(s) with no static lock class: "
                     f"{', '.join(unkeyed)}")
    for item in out["unknown"]:
        lines.append(f"repro-sanitize: note: edge {item['edge']} not in the "
                     f"static graph (observed at {item['site']})")
    for stall in out["stalls"]:
        lines.append(f"repro-sanitize: STALL: {stall['thread']} waited "
                     f"{stall['waited']:.0f}s for {stall['key']}")
    for inv in out["inversions"]:
        lines.append(f"repro-sanitize: INVERSION: observed {inv['edge']} "
                     f"at {inv['site']} but the static graph orders "
                     f"{inv['static_reverse_path']}")
    if race is not None:
        lines.append(f"repro-sanitize: race mode tracked "
                     f"{race['fields_tracked']} shared field(s) across "
                     f"{len(race['instrumented_classes'])} class(es) "
                     f"({race['fields_allowed']} audited allow-listed); "
                     f"{len(race['violations'])} race(s)")
        for v in race["violations"]:
            lines.append(f"repro-sanitize: RACE: {v['class']}.{v['field']} "
                         f"written by threads {v['threads']} with empty "
                         f"lockset intersection (last write at {v['site']})")
    return lines


def pytest_sessionfinish(session, exitstatus):
    if not os.environ.get(ENV):
        return
    from . import sanitize

    out = sanitize.cross_check_repo()
    race = sanitize.race_report() if sanitize.race_installed() else None
    print("\n" + "\n".join(summary_lines(out, race)))
    if out["inversions"]:
        raise RuntimeError(
            f"repro-sanitize: {len(out['inversions'])} lock-order "
            f"inversion(s) against the static graph — potential "
            f"deadlock(s); see the lines above")
    if race is not None and race["violations"]:
        raise RuntimeError(
            f"repro-sanitize: {len(race['violations'])} shared-state "
            f"race(s) observed — unlocked cross-thread field write(s); "
            f"see the lines above")
