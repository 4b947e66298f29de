"""Thread-hygiene checker: silently swallowed exceptions.

A ``except Exception: pass`` (or bare ``except:``) inside the
concurrency modules hides real failures — a background flusher or
monitor loop that dies silently looks exactly like a healthy idle one.
This rule flags any handler that catches ``Exception``/``BaseException``
(or everything) and whose body neither logs, re-raises, records, nor
returns a value — it just ``pass``es or ``continue``s.

Deliberate swallows (e.g. best-effort cleanup on shutdown) are audited
in-code:

    except Exception:   # repro-check: allow(swallow) -- shutdown path
        pass

``contextlib.suppress(...)`` is not flagged: writing it is already an
explicit, reviewable statement of intent.
"""
from __future__ import annotations

import ast

from ..findings import Finding
from ..loader import Project

DEFAULT_CONFIG = {
    "modules": ("storage", "durable", "aio", "fabric", "replication",
                "server", "faults"),
}

_BROAD = {"Exception", "BaseException"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:
        return True
    t = handler.type
    if isinstance(t, ast.Name):
        return t.id in _BROAD
    if isinstance(t, ast.Tuple):
        return any(isinstance(el, ast.Name) and el.id in _BROAD
                   for el in t.elts)
    return False


def _swallows(handler: ast.ExceptHandler) -> bool:
    """True when the handler body does nothing observable."""
    for stmt in handler.body:
        if isinstance(stmt, (ast.Pass, ast.Continue, ast.Break)):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(
                stmt.value, ast.Constant):
            continue    # docstring-style no-op
        return False
    return True


def run(project: Project, config: dict | None = None) -> list[Finding]:
    cfg = dict(DEFAULT_CONFIG)
    if config:
        cfg.update(config)
    findings: list[Finding] = []
    tag = "swallow"
    for name in cfg["modules"]:
        mod = project.modules.get(name)
        if mod is None:
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not (_is_broad(node) and _swallows(node)):
                continue
            if mod.is_allowed(node.lineno, tag):
                continue
            caught = (ast.unparse(node.type) if node.type is not None
                      else "<bare>")
            # locate the enclosing function for a stable fingerprint
            symbol = ""
            for fi in project.functions.values():
                if fi.module is mod and fi.node.lineno <= node.lineno <= (
                        fi.node.end_lineno or 0):
                    symbol = fi.qual
            findings.append(Finding(
                checker="thread-hygiene", rule="swallowed-exception",
                path=mod.path, line=node.lineno, symbol=symbol,
                message=f"`except {caught}` silently swallowed — log it, "
                        f"narrow it, or annotate "
                        f"`# repro-check: allow(swallow)`",
                detail=f"{symbol}|{caught}"))
    return findings
