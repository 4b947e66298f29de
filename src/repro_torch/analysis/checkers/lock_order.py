"""Lock-order checker: static acquisition graph + blocking-under-lock.

Two rules over the concurrency modules (``storage``, ``durable``,
``aio``, ``fabric``, ``replication``, ``server`` by default):

``lock-cycle``
    Every ``with <lock>:`` / ``<lock>.acquire()`` /
    ``stack.enter_context(<lock>)`` span contributes edges *held-lock ->
    newly-acquired-lock* (including acquisitions made by transitively
    called functions).  Locks are abstracted to *lock classes* —
    ``storage._StudyShard.lock`` is one node no matter how many shards
    exist, the standard static deadlock abstraction.  Any strongly
    connected component with more than one node is a potential deadlock.

``blocking-under-lock``
    A blocking primitive (``os.fsync``, socket send/recv, ``sleep``,
    thread ``join``, subprocess waits, foreign ``Condition.wait``)
    reached while a *shard or WAL* lock class is held.  ``cv.wait()``
    under its own condition is exempt (it releases the lock).  Audited
    exceptions carry ``# repro-check: allow(blocking-under-lock)``.

The graph this builds is also exported (``build_lock_graph``) for the
runtime sanitizer, which validates real acquisition order against it.
"""
from __future__ import annotations

import ast
import dataclasses

from ..callgraph import CallGraph, classify_blocking
from ..findings import Finding
from ..loader import FunctionInfo, Project

_LOCK_FACTORIES = {"Lock", "RLock", "Condition", "BoundedSemaphore",
                   "Semaphore"}

DEFAULT_CONFIG = {
    # modules whose lock spans are analyzed (project-relative names)
    "modules": ("storage", "durable", "aio", "fabric", "replication",
                "server", "speculate"),
    # lock classes defined in these modules are "shard or WAL" locks:
    # blocking while holding one is a finding
    "critical_modules": ("storage", "durable"),
    # attribute expressions the resolver cannot type, mapped by hand —
    # server keeps the per-study shard lock on its context object
    "aliases": {
        ("server", "ctx.lock"): "storage._StudyShard.lock",
        ("server", "self.lock"): "storage._StudyShard.lock",
    },
}


@dataclasses.dataclass(frozen=True)
class LockClass:
    key: str        # "storage._StudyShard.lock" / "aio._switch_lock"
    module: str
    attr: str
    line: int


@dataclasses.dataclass
class Span:
    key: str
    func: FunctionInfo
    start: int
    end: int
    ref_text: str   # source expression of the acquisition ("self._lock")
    line: int


class LockModel:
    """Discovered lock classes + resolution of lock reference exprs."""

    def __init__(self, project: Project, aliases: dict | None = None):
        self.project = project
        self.aliases = dict(aliases or {})
        self.classes: dict[str, LockClass] = {}
        # attr name -> lock classes carrying it
        self.by_attr: dict[str, list[LockClass]] = {}
        # provider function name -> lock key (e.g. study_lock)
        self.providers: dict[str, str] = {}
        self._discover()
        self._discover_providers()

    def _add(self, key: str, module: str, attr: str, line: int) -> None:
        lc = LockClass(key=key, module=module, attr=attr, line=line)
        self.classes[key] = lc
        self.by_attr.setdefault(attr, []).append(lc)

    def _discover(self) -> None:
        for mod in self.project.modules.values():
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Assign) or not isinstance(
                        node.value, ast.Call):
                    continue
                fn = node.value.func
                name = (fn.attr if isinstance(fn, ast.Attribute)
                        else fn.id if isinstance(fn, ast.Name) else "")
                if name not in _LOCK_FACTORIES:
                    continue
                for target in node.targets:
                    if (isinstance(target, ast.Attribute)
                            and isinstance(target.value, ast.Name)
                            and target.value.id == "self"):
                        cls = self._enclosing_class(mod, node)
                        owner = cls or mod.name
                        self._add(f"{mod.name}.{owner.split('.')[-1]}."
                                  f"{target.attr}"
                                  if cls else f"{mod.name}.{target.attr}",
                                  mod.name, target.attr, node.lineno)
                    elif isinstance(target, ast.Name):
                        # module-level or long-lived local lock
                        self._add(f"{mod.name}.{target.id}", mod.name,
                                  target.id, node.lineno)

    def _enclosing_class(self, mod, node) -> str | None:
        for cls in mod.tree.body:
            if isinstance(cls, ast.ClassDef) and \
                    cls.lineno <= node.lineno <= (cls.end_lineno or 1 << 30):
                return cls.name
        return None

    def _discover_providers(self) -> None:
        """Functions that *return* a lock (``storage.study_lock``)."""
        for fi in self.project.functions.values():
            for node in ast.walk(fi.node):
                if isinstance(node, ast.Return) and node.value is not None:
                    key = self._resolve_expr(node.value, fi, {})
                    if key is not None:
                        self.providers[fi.name] = key

    # ------------------------------------------------------------------ #
    def resolve(self, expr: ast.expr, fi: FunctionInfo,
                local_binds: dict[str, str]) -> str | None:
        return self._resolve_expr(expr, fi, local_binds)

    def _resolve_expr(self, expr: ast.expr, fi: FunctionInfo,
                      local_binds: dict[str, str]) -> str | None:
        text = ast.unparse(expr)
        alias = self.aliases.get((fi.module.name, text))
        if alias is not None:
            return alias
        if isinstance(expr, ast.Call):
            # provider call: self.storage.study_lock(key)
            fn = expr.func
            name = (fn.attr if isinstance(fn, ast.Attribute)
                    else fn.id if isinstance(fn, ast.Name) else "")
            return self.providers.get(name)
        if isinstance(expr, ast.Name):
            if expr.id in local_binds:
                return local_binds[expr.id]
            key = f"{fi.module.name}.{expr.id}"
            return key if key in self.classes else None
        if isinstance(expr, ast.Attribute):
            cands = self.by_attr.get(expr.attr, [])
            if not cands:
                return None
            recv = ast.unparse(expr.value)
            if recv == "self" and fi.cls:
                # own (or inherited/overriding) class first
                names = {c.name for c in self.project.mro(fi.cls)}
                names |= {c.name
                          for c in self.project.subclasses(fi.cls)}
                own = [c for c in cands
                       if c.key.split(".")[-2] in names]
                if own:
                    return own[0].key
            same_mod = [c for c in cands if c.module == fi.module.name]
            if len(same_mod) == 1:
                return same_mod[0].key
            pool = same_mod or cands
            # name hint: "shard".lock -> _StudyShard.lock
            hint = recv.split(".")[-1].split("[")[0].lstrip("_").lower()
            hinted = [c for c in pool
                      if hint and hint in c.key.split(".")[-2]
                      .lstrip("_").lower()]
            if len(hinted) == 1:
                return hinted[0].key
            if len(pool) == 1:
                return pool[0].key
            return None
        return None


def _local_lock_binds(fi: FunctionInfo, model: LockModel) -> dict[str, str]:
    """``lock = self.storage.study_lock(k)``-style local name bindings."""
    binds: dict[str, str] = {}
    for node in ast.walk(fi.node):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            key = model.resolve(node.value, fi, binds)
            if key is not None:
                binds[node.targets[0].id] = key
    return binds


def _spans_in(fi: FunctionInfo, model: LockModel) -> list[Span]:
    binds = _local_lock_binds(fi, model)
    spans: list[Span] = []
    end_of_func = fi.node.end_lineno or fi.node.lineno

    for node in ast.walk(fi.node):
        if isinstance(node, ast.With):
            for item in node.items:
                key = model.resolve(item.context_expr, fi, binds)
                if key is not None:
                    spans.append(Span(
                        key=key, func=fi, start=node.lineno,
                        end=node.end_lineno or node.lineno,
                        ref_text=ast.unparse(item.context_expr),
                        line=node.lineno))
        elif isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr == "acquire":
                key = model.resolve(fn.value, fi, binds)
                if key is not None:
                    spans.append(Span(
                        key=key, func=fi, start=node.lineno,
                        end=_release_line(fi, fn.value, node.lineno)
                        or end_of_func,
                        ref_text=ast.unparse(fn.value), line=node.lineno))
            elif (isinstance(fn, ast.Attribute)
                  and fn.attr == "enter_context" and node.args):
                key = model.resolve(node.args[0], fi, binds)
                if key is not None:
                    # held until the ExitStack unwinds — treat as the
                    # rest of the function (conservative)
                    spans.append(Span(
                        key=key, func=fi, start=node.lineno,
                        end=end_of_func,
                        ref_text=ast.unparse(node.args[0]),
                        line=node.lineno))
    return spans


def _release_line(fi: FunctionInfo, ref: ast.expr, after: int
                  ) -> int | None:
    want = ast.unparse(ref)
    best: int | None = None
    for node in ast.walk(fi.node):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "release"
                and ast.unparse(node.func.value) == want
                and node.lineno >= after):
            if best is None or node.lineno < best:
                best = node.lineno
    return best


# --------------------------------------------------------------------------- #
def build_lock_graph(project: Project, config: dict | None = None) -> dict:
    """-> {"keys": [...], "edges": {(a, b): example-site}, "spans": ...}

    Shared by the checker and the runtime sanitizer cross-check.
    """
    cfg = dict(DEFAULT_CONFIG)
    if config:
        cfg.update(config)
    model = LockModel(project, aliases=cfg.get("aliases"))
    cg = CallGraph(project)

    all_spans: dict[str, list[Span]] = {}
    for fi in project.functions.values():
        spans = _spans_in(fi, model)
        if spans:
            all_spans[fi.qual] = spans

    # transitive lock acquisition per function (memoized, cycle-tolerant)
    closure_cache: dict[str, set[tuple[str, str]]] = {}

    def closure(qual: str, stack: tuple = ()) -> set[tuple[str, str]]:
        if qual in closure_cache:
            return closure_cache[qual]
        if qual in stack or len(stack) > 12:
            return set()
        acc = {(s.key, f"{s.func.module.path}:{s.line}")
               for s in all_spans.get(qual, [])}
        for callee, site in cg.calls_in(qual):
            if site.fresh:
                continue    # private instance: its locks are unaliased
            acc |= closure(callee.qual, stack + (qual,))
        closure_cache[qual] = acc
        return acc

    edges: dict[tuple[str, str], str] = {}

    def add_edge(a: str, b: str, where: str) -> None:
        if a != b and (a, b) not in edges:
            edges[(a, b)] = where

    for qual, spans in all_spans.items():
        fi = project.functions[qual]
        for span in spans:
            where = f"{fi.module.path}:{span.line} in {qual}"
            # nested spans in the same function
            for other in spans:
                if other is not span and span.start <= other.start \
                        and other.end <= span.end:
                    add_edge(span.key, other.key, where)
            # acquisitions made by calls inside the span
            for callee, site in cg.calls_in(qual):
                if not (span.start <= site.line <= span.end):
                    continue
                if site.fresh:
                    continue    # private instance: locks unaliased
                if fi.module.is_allowed(site.line, "lock-order"):
                    continue
                for key, where2 in closure(callee.qual):
                    add_edge(span.key, key,
                             f"{where} -> {callee.qual} ({where2})")

    return {"keys": sorted(model.classes),
            "edges": edges,
            "spans": all_spans,
            "model": model,
            "callgraph": cg,
            "config": cfg}


def _sccs(nodes: list[str], edges: dict[tuple[str, str], str]
          ) -> list[list[str]]:
    """Tarjan strongly connected components."""
    adj: dict[str, list[str]] = {n: [] for n in nodes}
    for (a, b) in edges:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, [])
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    out: list[list[str]] = []
    counter = [0]

    def strong(v: str) -> None:
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        for w in adj.get(v, ()):
            if w not in index:
                strong(w)
                low[v] = min(low[v], low[w])
            elif w in on_stack:
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            comp = []
            while True:
                w = stack.pop()
                on_stack.discard(w)
                comp.append(w)
                if w == v:
                    break
            out.append(comp)

    for v in list(adj):
        if v not in index:
            strong(v)
    return out


# --------------------------------------------------------------------------- #
def run(project: Project, config: dict | None = None) -> list[Finding]:
    cfg = dict(DEFAULT_CONFIG)
    if config:
        cfg.update(config)
    graph = build_lock_graph(project, cfg)
    model: LockModel = graph["model"]
    cg: CallGraph = graph["callgraph"]
    all_spans: dict[str, list[Span]] = graph["spans"]
    findings: list[Finding] = []

    # rule 1: cycles in the acquisition graph
    for comp in _sccs(graph["keys"], graph["edges"]):
        if len(comp) < 2:
            continue
        comp = sorted(comp)
        sites = [graph["edges"][(a, b)]
                 for (a, b) in graph["edges"] if a in comp and b in comp]
        first = min(sites) if sites else ""
        findings.append(Finding(
            checker="lock-order", rule="lock-cycle",
            path=first.split(":")[0] if first else "",
            line=int(first.split(":")[1].split(" ")[0]) if first else 0,
            symbol="",
            message=f"potential deadlock: lock classes acquired in a "
                    f"cycle: {' <-> '.join(comp)}"
                    + (f"; e.g. {sites[0]}" if sites else ""),
            detail="cycle:" + ",".join(comp)))

    # rule 2: blocking calls while a shard/WAL lock class is held
    critical_mods = set(cfg["critical_modules"])
    analyzed = set(cfg["modules"])
    tag = "blocking-under-lock"

    def is_critical(key: str) -> bool:
        lc = model.classes.get(key)
        return (lc.module if lc else key.split(".")[0]) in critical_mods

    for qual, spans in all_spans.items():
        fi = project.functions[qual]
        if fi.module.name.split(".")[0] not in analyzed:
            continue
        if fi.module.function_allowed(fi.node, tag):
            continue
        for span in spans:
            if not is_critical(span.key):
                continue
            held_refs = {s.ref_text for s in spans
                         if s.start <= span.start and span.end <= s.end}
            # direct blocking calls inside the span
            imports = project.imports.get(fi.module.name, {})
            for node in ast.walk(fi.node):
                if not isinstance(node, ast.Call) or not (
                        span.start <= node.lineno <= span.end):
                    continue
                kind = classify_blocking(node, fi.module, imports)
                if kind is None:
                    continue
                if kind == "wait" and isinstance(node.func, ast.Attribute) \
                        and ast.unparse(node.func.value) in held_refs:
                    continue  # cv.wait under its own condition releases it
                if fi.module.is_allowed(node.lineno, tag):
                    continue
                findings.append(Finding(
                    checker="lock-order", rule="blocking-under-lock",
                    path=fi.module.path, line=node.lineno, symbol=qual,
                    message=f"{kind} call "
                            f"`{ast.unparse(node)[:80]}` while holding "
                            f"{span.key}",
                    detail=f"{span.key}|{kind}|"
                           f"{ast.unparse(node)[:80]}"))
            # blocking reached through calls made inside the span
            for callee, site in cg.calls_in(qual):
                if not (span.start <= site.line <= span.end):
                    continue
                if fi.module.is_allowed(site.line, tag):
                    continue
                for bc in cg.reachable_blocking(callee.qual,
                                                allow_tag=tag):
                    if bc.kind == "wait" and any(
                            bc.site.text.startswith(r + ".wait")
                            for r in held_refs):
                        continue
                    findings.append(Finding(
                        checker="lock-order", rule="blocking-under-lock",
                        path=fi.module.path, line=site.line, symbol=qual,
                        message=f"{bc.kind} at {bc.site.path}:"
                                f"{bc.site.line} reachable while holding "
                                f"{span.key} via "
                                f"{' -> '.join(bc.chain[-3:])}",
                        detail=f"{span.key}|{bc.kind}|{bc.site.path}|"
                               f"{bc.site.caller}"))

    # dedupe (same fingerprint can arise via several chains)
    seen: set[str] = set()
    out = []
    for f in findings:
        if f.fingerprint not in seen:
            seen.add(f.fingerprint)
            out.append(f)
    return out
