"""repro-check CLI: ``python -m repro_torch.analysis``.

    PYTHONPATH=src python -m repro_torch.analysis           # run everything
    PYTHONPATH=src python -m repro_torch.analysis --checker lock-order
    PYTHONPATH=src python -m repro_torch.analysis --write-baseline
    PYTHONPATH=src python -m repro_torch.analysis --format json

Exit codes: 0 = no non-baselined findings; 1 = new findings (this is
``--fail-on-new``, which is the default and only mode — the flag is
accepted for CI readability); 2 = usage error.

Stale baseline entries (fixed findings still listed) are reported so
debt gets deleted from the baseline, never hoarded; they do not fail
the run.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .checkers import CHECKERS
from .findings import Baseline, Finding
from .loader import Project


# the port's own debt ledger, kept inside the package (committed empty)
DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"


def _default_repo_root() -> Path:
    # src/repro_torch/analysis/cli.py -> repo root is three levels above src/
    return Path(__file__).resolve().parents[3]


def run_checkers(project: Project, names: list[str] | None = None
                 ) -> list[Finding]:
    findings: list[Finding] = []
    for name, checker in CHECKERS.items():
        if names and name not in names:
            continue
        findings.extend(checker(project))
    return findings


def print_stats(project: Project) -> int:
    """Per-checker coverage counts (``--stats``).  Returns non-zero when
    thread-root discovery comes up empty for any required subsystem —
    a rename that silently shrinks coverage must fail CI, because zero
    roots reads exactly like a clean run."""
    from .checkers import lock_order, shared_state, wire_schema

    print(f"repro-check: project: {len(project.modules)} module(s), "
          f"{len(project.functions)} function(s), "
          f"{len(project.classes)} class(es) loaded")

    graph = lock_order.build_lock_graph(project)
    print(f"repro-check: lock-order: {len(graph['keys'])} lock "
          f"class(es), {len(graph['edges'])} static acquisition edge(s)")

    routes = 0
    for name in wire_schema.DEFAULT_CONFIG["routes_modules"]:
        mod = project.modules.get(name)
        if mod is not None:
            routes += len(wire_schema._routes(mod))
    client = project.modules.get(wire_schema.DEFAULT_CONFIG["client_module"])
    calls = len(wire_schema._client_calls(client)) if client else 0
    print(f"repro-check: wire-schema: {routes} route(s), "
          f"{calls} client call(s) cross-checked")

    ss = shared_state.stats(project)
    per_sub = ", ".join(f"{sub}: {n}" for sub, n
                        in ss["roots_by_subsystem"].items())
    print(f"repro-check: shared-state: {ss['roots']} thread root(s) "
          f"({per_sub}); {ss['classes_found']}/"
          f"{ss['classes_configured']} configured class(es) found; "
          f"{ss['fields_examined']} field(s) examined, "
          f"{ss['fields_escaped']} escaped to >=2 roots, "
          f"{ss['fields_allowed']} allow-audited, "
          f"{ss['fields_flagged']} flagged")

    empty = [sub for sub in ss["required_subsystems"]
             if not ss["roots_by_subsystem"].get(sub)]
    if empty:
        print(f"repro-check: FAIL: zero thread roots discovered in "
              f"subsystem(s): {', '.join(empty)} — root discovery "
              f"coverage collapsed (a spawn-site rename reads as "
              f"'clean')", file=sys.stderr)
        return 1
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repo-specific static analysis: lock order, "
                    "event-loop blocking, write-ahead ordering, "
                    "wire-schema drift, thread hygiene")
    ap.add_argument("--root", default=None,
                    help="package to analyze "
                         "(default: <repo>/src/repro_torch/core)")
    ap.add_argument("--baseline", default=None,
                    help="baseline file (default: the port's own, "
                         "repro_torch/analysis/baseline.json)")
    ap.add_argument("--checker", action="append", default=None,
                    choices=sorted(CHECKERS),
                    help="run only this checker (repeatable)")
    ap.add_argument("--fail-on-new", action="store_true",
                    help="exit non-zero on non-baselined findings "
                         "(the default; flag kept for explicit CI steps)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from current findings")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--stats", action="store_true",
                    help="print per-checker coverage counts instead of "
                         "findings; fails when thread-root discovery is "
                         "empty for a required subsystem")
    args = ap.parse_args(argv)

    repo_root = _default_repo_root()
    root = Path(args.root) if args.root else repo_root / "src/repro_torch/core"
    if not root.is_dir():
        print(f"repro-check: no such package root: {root}",
              file=sys.stderr)
        return 2
    baseline_path = (Path(args.baseline) if args.baseline
                     else DEFAULT_BASELINE)

    project = Project(root, repo_root=repo_root).load()
    if args.stats:
        return print_stats(project)
    findings = run_checkers(project, args.checker)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))

    if args.write_baseline:
        Baseline.from_findings(findings).save(baseline_path)
        print(f"repro-check: wrote {len(findings)} finding(s) to "
              f"{baseline_path}")
        return 0

    baseline = Baseline.load(baseline_path)
    new, known, stale = baseline.split(findings)

    if args.format == "json":
        print(json.dumps({
            "new": [f.__dict__ | {"fingerprint": f.fingerprint}
                    for f in new],
            "baselined": [f.fingerprint for f in known],
            "stale": stale,
        }, indent=1))
    else:
        for f in new:
            print(f.render())
        if known:
            print(f"repro-check: {len(known)} baselined finding(s) "
                  f"suppressed")
        for fp in stale:
            print(f"repro-check: stale baseline entry {fp} "
                  f"({baseline.entries[fp]}) — finding fixed, delete it "
                  f"from {baseline_path.name}")
        counts: dict[str, int] = {}
        for f in findings:
            counts[f.checker] = counts.get(f.checker, 0) + 1
        ran = args.checker or sorted(CHECKERS)
        summary = ", ".join(f"{c}: {counts.get(c, 0)}" for c in ran)
        print(f"repro-check: {summary}; {len(new)} new")
    return 1 if new else 0
