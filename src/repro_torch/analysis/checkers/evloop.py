"""Event-loop blocking checker.

The event-loop frontend (``repro_torch.core.aio``) runs exactly one IO thread;
everything that thread executes must be non-blocking or the whole
frontend stalls.  This checker walks the call graph from the IO-thread
entry points of ``EventLoopFrontend`` to any blocking primitive.

Audited exceptions are annotated in-code:

    # repro-check: allow(blocking) -- <why this cannot actually block>

e.g. the memory-backend inline dispatch (``_execute`` from ``_on_read``,
which by construction cannot touch a WAL or a socket) and sends on
sockets already in non-blocking mode.

The entry-point list is configuration, not discovery: selector callbacks
are registered as data (``key.data``), which a static call graph cannot
follow, so the contract is stated explicitly here and pinned by the
``missing-entry`` rule — if a configured entry disappears from the
class, the checker fails rather than silently analyzing nothing.
"""
from __future__ import annotations

from ..callgraph import CallGraph
from ..findings import Finding
from ..loader import Project

DEFAULT_CONFIG = {
    "module": "aio",
    "cls": "EventLoopFrontend",
    # everything the selector loop runs on the IO thread
    "entries": ("_loop", "_accept", "_on_read", "_on_write", "_flush_ready",
                "_write_some", "_drain_done", "_close_conn", "_wake"),
    # the loop's own selector poll is the one sanctioned blocking point
    "allowed_kinds": (),
}


def run(project: Project, config: dict | None = None) -> list[Finding]:
    cfg = dict(DEFAULT_CONFIG)
    if config:
        cfg.update(config)
    cg = CallGraph(project)
    findings: list[Finding] = []

    cls_qual = f"{cfg['module']}.{cfg['cls']}"
    cls = project.classes.get(cls_qual)
    if cls is None:
        findings.append(Finding(
            checker="evloop-blocking", rule="missing-entry",
            path="", line=0, symbol=cls_qual,
            message=f"configured IO-thread class {cls_qual} not found",
            detail=f"class:{cls_qual}"))
        return findings

    for entry in cfg["entries"]:
        if entry not in cls.methods:
            findings.append(Finding(
                checker="evloop-blocking", rule="missing-entry",
                path=cls.module.path, line=cls.node.lineno,
                symbol=cls_qual,
                message=f"configured IO-thread entry point "
                        f"{cls_qual}.{entry} no longer exists — update "
                        f"the checker config to match the frontend",
                detail=f"entry:{cls_qual}.{entry}"))
            continue
        qual = cls.methods[entry].qual
        for bc in cg.reachable_blocking(qual, allow_tag="blocking"):
            if bc.kind in cfg["allowed_kinds"]:
                continue
            findings.append(Finding(
                checker="evloop-blocking", rule="io-thread-blocks",
                path=bc.site.path, line=bc.site.line,
                symbol=bc.site.caller,
                message=f"{bc.kind} call `{bc.site.text[:80]}` reachable "
                        f"on the IO thread via "
                        f"{' -> '.join(bc.chain[:4])}",
                detail=f"{entry}|{bc.kind}|{bc.site.path}|"
                       f"{bc.site.caller}|{bc.site.text[:60]}"))

    seen: set[str] = set()
    out = []
    for f in findings:
        if f.fingerprint not in seen:
            seen.add(f.fingerprint)
            out.append(f)
    return out
