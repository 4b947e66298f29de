"""Write-ahead ordering checker.

The storage invariant: every mutator serializes its operation to
the journal/WAL (``self._log({...})``) *before* touching in-memory
state, so crash recovery replays to a digest-identical state.  A mutation
that lands before the log call is unrecoverable — the journal would
miss it (or record it after a partially applied state).

The checker walks every method of the storage classes that calls the
journal serializer and flags in-memory mutations (assignments or
mutating calls rooted at ``self`` or a shard) that can execute on a path
where the log call has not happened yet.  Branches are analyzed
independently; a path counts as "logged" only once every branch through
it has logged.

Exemptions: counters/telemetry attributes (configured), and
``# repro-check: allow(wal-order)`` for audited sites (e.g. rebuilding
derived indexes during replay, which by definition must not re-journal).
"""
from __future__ import annotations

import ast

from ..findings import Finding
from ..loader import FunctionInfo, Project

DEFAULT_CONFIG = {
    "module": "storage",
    # classes whose mutators must write ahead; subclasses are included
    "classes": ("InMemoryStorage",),
    "log_method": "_log",
    # receivers whose mutation is state (self plus the shard parameter)
    "roots": ("self", "shard"),
    # attributes that are telemetry/bookkeeping, not recovered state
    "exempt_attrs": ("_stats", "_metrics", "_last_flush", "_dirty",
                     "_pending_ack"),
}

_MUTATING_ATTRS = {"append", "appendleft", "add", "insert", "update",
                   "setdefault", "pop", "popitem", "remove", "discard",
                   "clear", "extend", "__setitem__"}


def _root_of(expr: ast.expr) -> str | None:
    while isinstance(expr, (ast.Attribute, ast.Subscript)):
        expr = expr.value
    return expr.id if isinstance(expr, ast.Name) else None


def _attr_chain(expr: ast.expr) -> list[str]:
    out: list[str] = []
    while isinstance(expr, (ast.Attribute, ast.Subscript)):
        if isinstance(expr, ast.Attribute):
            out.append(expr.attr)
        expr = expr.value
    return list(reversed(out))


class _PathWalker:
    """Linearized walk tracking whether the log call has happened yet."""

    def __init__(self, fi: FunctionInfo, cfg: dict,
                 findings: list[Finding]):
        self.fi = fi
        self.cfg = cfg
        self.findings = findings
        self.exempt = set(cfg["exempt_attrs"])
        self.roots = set(cfg["roots"])

    # -> True when the statement list is guaranteed to have logged
    def walk(self, body: list[ast.stmt], logged: bool) -> bool:
        for stmt in body:
            logged = self._stmt(stmt, logged)
        return logged

    def _stmt(self, stmt: ast.stmt, logged: bool) -> bool:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return logged
        if not logged:
            self._check_mutations(stmt)
        if isinstance(stmt, ast.If):
            a = self.walk(stmt.body, logged)
            b = self.walk(stmt.orelse, logged)
            return a and b
        if isinstance(stmt, (ast.For, ast.While)):
            self.walk(stmt.body, logged)
            self.walk(stmt.orelse, logged)
            return logged
        if isinstance(stmt, ast.With):
            return self.walk(stmt.body, logged)
        if isinstance(stmt, ast.Try):
            a = self.walk(stmt.body, logged)
            for handler in stmt.handlers:
                a = self.walk(handler.body, logged) and a
            a = self.walk(stmt.orelse, a) and a
            return self.walk(stmt.finalbody, a)
        return logged or self._logs(stmt)

    def _logs(self, stmt: ast.stmt) -> bool:
        log_method = self.cfg["log_method"]
        for node in ast.walk(stmt):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == log_method
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "self"):
                return True
        return False

    def logs_anywhere(self) -> bool:
        return self._logs(self.fi.node)

    def _check_mutations(self, stmt: ast.stmt) -> None:
        # only the statement itself, not nested blocks (handled above)
        if isinstance(stmt, (ast.If, ast.For, ast.While, ast.With,
                             ast.Try)):
            nodes: list[ast.AST] = [stmt.test] if isinstance(
                stmt, (ast.If, ast.While)) else []
            if isinstance(stmt, ast.For):
                nodes = [stmt.iter]
            if isinstance(stmt, ast.With):
                nodes = [i.context_expr for i in stmt.items]
        else:
            nodes = [stmt]
        for top in nodes:
            if top is None:
                continue
            for node in ast.walk(top):
                self._check_node(node)

    def _check_node(self, node: ast.AST) -> None:
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Tuple):
                    sub = list(t.elts)
                else:
                    sub = [t]
                for target in sub:
                    if not isinstance(target, (ast.Attribute,
                                               ast.Subscript)):
                        continue
                    self._flag_if_state(target, node)
        elif isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute) and \
                node.func.attr in _MUTATING_ATTRS:
            self._flag_if_state(node.func.value, node)

    def _flag_if_state(self, expr: ast.expr, node: ast.AST) -> None:
        root = _root_of(expr)
        if root not in self.roots:
            return
        chain = _attr_chain(expr)
        if chain and chain[0] in self.exempt:
            return
        mod = self.fi.module
        line = getattr(node, "lineno", self.fi.node.lineno)
        if mod.is_allowed(line, "wal-order") or \
                mod.function_allowed(self.fi.node, "wal-order"):
            return
        text = ast.unparse(node)[:80]
        self.findings.append(Finding(
            checker="wal-order", rule="mutate-before-journal",
            path=mod.path, line=line, symbol=self.fi.qual,
            message=f"in-memory mutation `{text}` can execute before "
                    f"the write-ahead `self.{self.cfg['log_method']}(...)` "
                    f"call — recovery would diverge",
            detail=f"{self.fi.qual}|{text}"))


def run(project: Project, config: dict | None = None) -> list[Finding]:
    cfg = dict(DEFAULT_CONFIG)
    if config:
        cfg.update(config)
    findings: list[Finding] = []
    targets: list[str] = []
    for name in cfg["classes"]:
        for cls in project.class_by_name(name):
            targets.append(cls.qual)
            targets.extend(s.qual for s in project.subclasses(cls.qual))

    seen_methods: set[str] = set()
    for cls_qual in targets:
        cls = project.classes.get(cls_qual)
        if cls is None:
            continue
        for method in cls.methods.values():
            if method.qual in seen_methods:
                continue
            seen_methods.add(method.qual)
            if method.name == cfg["log_method"]:
                continue
            walker = _PathWalker(method, cfg, findings)
            if not walker.logs_anywhere():
                continue
            walker.walk(method.node.body, logged=False)

    seen: set[str] = set()
    out = []
    for f in findings:
        if f.fingerprint not in seen:
            seen.add(f.fingerprint)
            out.append(f)
    return out
