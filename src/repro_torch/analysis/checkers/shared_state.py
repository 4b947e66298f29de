"""Eraser-style shared-state checker: thread roots -> escape -> lockset.

Three passes over the core package, all AST-only:

1. **Thread-root discovery** — every concurrent entry point:
   ``threading.Thread(target=...)`` spawns (lane pools, WAL flusher and
   compactor daemons, the fabric monitor, replication hub/client
   threads), ``threading.Timer``, ``multiprocessing.Process`` workers,
   and ``threading.Thread`` subclasses' ``run`` methods.  A synthetic
   ``<main>`` root covers everything reachable from external entry
   points (loaded functions with no loaded caller).  Dynamic dispatch
   the call graph cannot see (the router calling registered handler
   closures) is closed over by configured ``dispatch_edges``.

2. **Escape analysis** — which instance attributes of the configured
   core classes are accessed from >= 2 roots after construction.
   Receivers are typed from ``self``, annotated parameters and
   return-annotated helpers (``shard = self._shard(key)``); accesses on
   locally constructed instances are private to the constructing
   function, matching the call-graph's fresh-instance rule.  Functions
   reachable only from ``__init__`` methods are construction-phase:
   their accesses happen before the instance is published.

3. **Lockset pass** (Eraser's core idea) — reusing the lock-order
   checker's lock-class abstraction: every access gets the set of lock
   classes statically held there (enclosing ``with``/``acquire`` spans
   plus a meet-over-call-sites entry lockset), and an escaped field
   whose intersection across all post-init accesses is empty — no
   single lock consistently protects it — is flagged.

Audited lock-free fields (GIL-atomic monotonic counters, single-writer
stats, write-once flags) carry
``# repro-check: allow(shared-state) -- why`` on any line that touches
the field (conventionally the initialising assignment); that audits the
whole field.  The runtime race sanitizer (``REPRO_SANITIZE=race``)
derives its allowlist from the same annotations, so the static model
and observed behaviour stay cross-validated.
"""
from __future__ import annotations

import ast
import dataclasses

from ..callgraph import CallGraph, _ann_class_name
from ..findings import Finding
from ..loader import ClassInfo, FunctionInfo, Project
from .lock_order import DEFAULT_CONFIG as _LOCK_DEFAULTS
from .lock_order import Span, build_lock_graph

TAG = "shared-state"
MAIN_ROOT = "<main>"

DEFAULT_CONFIG = {
    # classes whose instances are shared across threads; a configured
    # name missing from the project is itself a finding (coverage pin)
    "classes": ("_StudyShard", "DurableStorage", "ReplicationHub",
                "ReplicationClient", "FabricDispatcher",
                "EventLoopFrontend", "SpeculativeQueue",
                "SpeculativeWorker"),
    # subsystems (top-level module names) that must contribute at least
    # one discovered thread root — used by the --stats coverage guard
    "root_subsystems": ("aio", "durable", "fabric", "replication",
                        "speculate"),
    # dynamic dispatch the AST cannot resolve: the router calls handler
    # closures registered at construction time, so handler bodies (which
    # live in the register_* functions) run on whatever thread dispatches
    "dispatch_edges": (
        ("api.router.Router.dispatch", "api.v2.register_v2"),
        ("api.router.Router.dispatch", "api.v1.register_v1"),
    ),
    # entry points spawned outside the loaded AST (the threaded frontend
    # hands _make_handler's nested class to ThreadingHTTPServer, which
    # runs it on per-connection threads)
    "extra_roots": ("transport._make_handler",),
    "aliases": _LOCK_DEFAULTS["aliases"],
}

_SPAWN_KINDS = {"Thread": "thread", "Timer": "timer", "Process": "process"}

# receiver-mutating method names: ``self.waiting.append(x)`` writes the
# field's value even though the reference is only read
_MUTATORS = {"append", "add", "update", "pop", "popitem", "remove",
             "discard", "clear", "extend", "insert", "setdefault",
             "appendleft", "popleft", "sort"}
_HEAP_FNS = {"heappush", "heappop", "heapify", "heapreplace",
             "heappushpop"}


@dataclasses.dataclass(frozen=True)
class ThreadRoot:
    qual: str        # entry function qual ("durable.DurableStorage._flush_loop")
    kind: str        # "thread" | "timer" | "process" | "thread-subclass" | "config"
    subsystem: str   # top-level module name of the spawn site
    path: str
    line: int


@dataclasses.dataclass
class Access:
    attr: str
    func: FunctionInfo
    line: int
    write: bool
    recv: str


@dataclasses.dataclass
class FieldReport:
    family: str              # configured class name
    cls_qual: str            # primary class qual
    class_names: tuple[str, ...]   # every class name in the family
    attr: str
    accesses: list[Access]
    post_init: list[Access]
    roots: set[str]
    lockset: frozenset[str] | None   # intersection over post-init accesses
    allowed: bool
    flagged: bool
    example: Access | None


@dataclasses.dataclass
class SharedStateReport:
    roots: list[ThreadRoot]
    fields: list[FieldReport]
    families: dict[str, list[str]]   # configured name -> class quals found
    missing: list[str]               # configured names not in the project


# --------------------------------------------------------------------------- #
# pass 1: thread roots
# --------------------------------------------------------------------------- #
def _target_functions(project: Project, fi: FunctionInfo,
                      expr: ast.expr) -> list[FunctionInfo]:
    """Resolve a ``target=`` expression to candidate entry functions."""
    if isinstance(expr, ast.Call):
        fn = expr.func
        name = (fn.attr if isinstance(fn, ast.Attribute)
                else getattr(fn, "id", ""))
        if name == "partial" and expr.args:
            expr = expr.args[0]
    if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
        recv = expr.value.id
        if recv == "self" and fi.cls:
            out: dict[str, FunctionInfo] = {}
            for cls in project.mro(fi.cls):
                if expr.attr in cls.methods and expr.attr not in out:
                    out[cls.qual] = cls.methods[expr.attr]
            for sub in project.subclasses(fi.cls):
                if expr.attr in sub.methods:
                    out[sub.qual] = sub.methods[expr.attr]
            return list(out.values())
        for cand in project.class_by_name(recv):
            for cls in project.mro(cand.qual):
                if expr.attr in cls.methods:
                    return [cls.methods[expr.attr]]
        # obj.method where obj is untyped: unique-name fallback
        cands = project.methods_by_name.get(expr.attr, [])
        if len(cands) == 1:
            return list(cands)
        return []
    if isinstance(expr, ast.Name):
        qual = f"{fi.module.name}.{expr.id}"
        if qual in project.functions:
            return [project.functions[qual]]
        target = project.imports.get(fi.module.name, {}).get(expr.id)
        if target:
            tail = target.split(".")
            for k in range(1, len(tail)):
                qual = ".".join(tail[-k - 1:])
                if qual in project.functions:
                    return [project.functions[qual]]
    return []


def discover_roots(project: Project, config: dict | None = None
                   ) -> list[ThreadRoot]:
    cfg = dict(DEFAULT_CONFIG)
    if config:
        cfg.update(config)
    roots: dict[str, ThreadRoot] = {}

    def add(qual: str, kind: str, subsystem: str, path: str,
            line: int) -> None:
        if qual not in roots:
            roots[qual] = ThreadRoot(qual=qual, kind=kind,
                                     subsystem=subsystem, path=path,
                                     line=line)

    # threading.Thread subclasses: run() is an entry once started
    for info in project.classes.values():
        if any(b.split(".")[-1] == "Thread" for b in info.bases):
            run = info.methods.get("run")
            if run is not None:
                add(run.qual, "thread-subclass",
                    info.module.name.split(".")[0], info.module.path,
                    info.node.lineno)

    for fi in project.functions.values():
        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            name = (fn.attr if isinstance(fn, ast.Attribute)
                    else fn.id if isinstance(fn, ast.Name) else "")
            kind = _SPAWN_KINDS.get(name)
            if kind is None:
                continue
            target_expr = None
            for kw in node.keywords:
                if kw.arg == "target":
                    target_expr = kw.value
            if target_expr is None and kind == "timer" \
                    and len(node.args) >= 2:
                target_expr = node.args[1]
            if target_expr is None:
                continue
            for tgt in _target_functions(project, fi, target_expr):
                add(tgt.qual, kind, fi.module.name.split(".")[0],
                    fi.module.path, node.lineno)

    for qual in cfg.get("extra_roots", ()):
        fi = project.functions.get(qual)
        if fi is not None:
            add(qual, "config", fi.module.name.split(".")[0],
                fi.module.path, fi.node.lineno)
    return sorted(roots.values(), key=lambda r: r.qual)


# --------------------------------------------------------------------------- #
# call-graph scaffolding shared by the escape and lockset passes
# --------------------------------------------------------------------------- #
def _call_edges(project: Project, cg: CallGraph,
                dispatch: tuple) -> dict[str, list[tuple[str, int, bool]]]:
    """caller qual -> [(callee qual, call line, receiver-is-fresh)]."""
    edges: dict[str, list[tuple[str, int, bool]]] = {
        q: [] for q in project.functions}
    for qual in project.functions:
        for callee, site in cg.calls_in(qual):
            edges[qual].append((callee.qual, site.line, site.fresh))
    for a, b in dispatch:
        if a in edges and b in project.functions:
            edges[a].append((b, 0, False))
    return edges


def _callers(edges: dict[str, list[tuple[str, int, bool]]]
             ) -> dict[str, set[str]]:
    out: dict[str, set[str]] = {}
    for caller, outs in edges.items():
        for callee, _, _ in outs:
            out.setdefault(callee, set()).add(caller)
    return out


def _reach_from(edges: dict[str, list[tuple[str, int, bool]]],
                entry: str) -> set[str]:
    seen: set[str] = set()
    stack = [entry]
    while stack:
        q = stack.pop()
        if q in seen:
            continue
        seen.add(q)
        for callee, _, fresh in edges.get(q, ()):
            if fresh:
                continue    # private instance: not the shared object
            stack.append(callee)
    return seen


def _init_only(project: Project, callers: dict[str, set[str]],
               root_quals: set[str]) -> set[str]:
    """Functions reachable *only* from ``__init__`` methods."""
    init = {q for q in project.functions
            if q.split(".")[-1] == "__init__" and q not in root_quals}
    changed = True
    while changed:
        changed = False
        for q in project.functions:
            if q in init or q in root_quals:
                continue
            cs = callers.get(q)
            if cs and all(c in init for c in cs):
                init.add(q)
                changed = True
    return init


def _spans_at(spans: dict[str, list[Span]], qual: str, line: int
              ) -> set[str]:
    return {s.key for s in spans.get(qual, ())
            if s.start <= line <= s.end}


def _entry_locksets(project: Project,
                    edges: dict[str, list[tuple[str, int, bool]]],
                    spans: dict[str, list[Span]],
                    forced_empty: set[str]) -> dict[str, set[str] | None]:
    """Meet-over-call-sites locks held when each function is entered.

    ``None`` is top (never reached from an entry: no opinion); thread
    roots and external entries are pinned to the empty set.
    """
    held: dict[str, set[str] | None] = {q: None for q in project.functions}
    for q in forced_empty:
        if q in held:
            held[q] = set()
    changed = True
    while changed:
        changed = False
        for caller, outs in edges.items():
            ch = held.get(caller)
            if ch is None:
                continue
            for callee, line, fresh in outs:
                if fresh or callee in forced_empty:
                    continue
                at = ch | _spans_at(spans, caller, line)
                cur = held.get(callee)
                if cur is None:
                    held[callee] = set(at)
                    changed = True
                else:
                    new = cur & at
                    if new != cur:
                        held[callee] = new
                        changed = True
    return held


# --------------------------------------------------------------------------- #
# pass 2: access collection over typed receivers
# --------------------------------------------------------------------------- #
def _families(project: Project, cfg: dict
              ) -> dict[str, dict[str, ClassInfo]]:
    out: dict[str, dict[str, ClassInfo]] = {}
    for name in cfg["classes"]:
        fam: dict[str, ClassInfo] = {}
        for ci in project.class_by_name(name):
            for m in project.mro(ci.qual):
                fam[m.qual] = m
            for s in project.subclasses(ci.qual):
                fam[s.qual] = s
        out[name] = fam
    return out


def _return_type(project: Project, fi: FunctionInfo,
                 call: ast.Call) -> str | None:
    """Class name of the callee's return annotation, best effort."""
    fn = call.func
    cands: list[FunctionInfo] = []
    if isinstance(fn, ast.Name):
        qual = f"{fi.module.name}.{fn.id}"
        if qual in project.functions:
            cands = [project.functions[qual]]
    elif isinstance(fn, ast.Attribute):
        if isinstance(fn.value, ast.Name) and fn.value.id == "self" \
                and fi.cls:
            for cls in project.mro(fi.cls):
                if fn.attr in cls.methods:
                    cands = [cls.methods[fn.attr]]
                    break
        if not cands:
            pool = project.methods_by_name.get(fn.attr, [])
            if len(pool) == 1:
                cands = list(pool)
    for cand in cands:
        if cand.node.returns is not None:
            return _ann_class_name(ast.unparse(cand.node.returns))
    return None


def _typed_receivers(project: Project, fi: FunctionInfo,
                     fam_names: set[str]) -> set[str]:
    """Local names statically typed as a family class in ``fi`` —
    excluding names bound by direct construction (fresh instances)."""
    recvs: set[str] = set()
    fresh: set[str] = set()
    args = (list(fi.node.args.args) + list(fi.node.args.kwonlyargs)
            + list(getattr(fi.node.args, "posonlyargs", [])))
    for arg in args:
        if arg.arg == "self" or arg.annotation is None:
            continue
        if _ann_class_name(ast.unparse(arg.annotation)) in fam_names:
            recvs.add(arg.arg)
    for node in ast.walk(fi.node):
        target = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            target = node.targets[0].id
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            if _ann_class_name(ast.unparse(node.annotation)) in fam_names:
                recvs.add(node.target.id)
            continue
        if target is None or not isinstance(node.value, ast.Call):
            continue
        callee = node.value.func
        if isinstance(callee, ast.Name) and callee.id in fam_names:
            fresh.add(target)
            continue
        rt = _return_type(project, fi, node.value)
        if rt in fam_names:
            recvs.add(target)
    return recvs - fresh


def _collect_accesses(fi: FunctionInfo, recv: str, method_names: set[str],
                      skip_attrs: set[str],
                      out: dict[str, list[Access]]) -> None:
    parent: dict[ast.AST, ast.AST] = {}
    for node in ast.walk(fi.node):
        for ch in ast.iter_child_nodes(node):
            parent[ch] = node
    for node in ast.walk(fi.node):
        if not isinstance(node, ast.Attribute):
            continue
        if not (isinstance(node.value, ast.Name)
                and node.value.id == recv):
            continue
        attr = node.attr
        if attr.startswith("__") or attr in skip_attrs \
                or attr in method_names:
            continue
        write = isinstance(node.ctx, (ast.Store, ast.Del))
        if not write:
            p = parent.get(node)
            if isinstance(p, ast.Subscript) and p.value is node \
                    and isinstance(p.ctx, (ast.Store, ast.Del)):
                write = True
            elif isinstance(p, ast.Attribute) and p.value is node \
                    and p.attr in _MUTATORS:
                pp = parent.get(p)
                if isinstance(pp, ast.Call) and pp.func is p:
                    write = True
            elif isinstance(p, ast.Call) and p.args and p.args[0] is node:
                fn = p.func
                nm = (fn.attr if isinstance(fn, ast.Attribute)
                      else getattr(fn, "id", ""))
                if nm in _HEAP_FNS:
                    write = True
        out.setdefault(attr, []).append(Access(
            attr=attr, func=fi, line=node.lineno, write=write, recv=recv))


def _family_accesses(project: Project, fam: dict[str, ClassInfo],
                     lock_attrs: set[str]) -> dict[str, list[Access]]:
    method_names: set[str] = set()
    for ci in fam.values():
        method_names |= set(ci.methods)
    fam_names = {ci.name for ci in fam.values()}
    accesses: dict[str, list[Access]] = {}
    seen: set[str] = set()
    for ci in fam.values():
        for m in ci.methods.values():
            if m.qual in seen:
                continue
            seen.add(m.qual)
            _collect_accesses(m, "self", method_names, lock_attrs,
                              accesses)
    for fi in project.functions.values():
        for recv in _typed_receivers(project, fi, fam_names):
            _collect_accesses(fi, recv, method_names, lock_attrs,
                              accesses)
    return accesses


def _class_default_allowed(fam: dict[str, ClassInfo], attr: str) -> bool:
    """allow(shared-state) on a class-level default assignment line."""
    for ci in fam.values():
        for node in ci.node.body:
            target = None
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id == attr:
                        target = t
            elif isinstance(node, ast.AnnAssign) \
                    and isinstance(node.target, ast.Name) \
                    and node.target.id == attr:
                target = node.target
            if target is not None and ci.module.is_allowed(
                    node.lineno, TAG):
                return True
    return False


# --------------------------------------------------------------------------- #
# pass 3: lockset verdicts
# --------------------------------------------------------------------------- #
def analyze(project: Project, config: dict | None = None,
            graph: dict | None = None) -> SharedStateReport:
    cfg = dict(DEFAULT_CONFIG)
    if config:
        cfg.update(config)
    if graph is None:
        graph = build_lock_graph(project, {"aliases": cfg["aliases"]})
    model = graph["model"]
    cg: CallGraph = graph["callgraph"]
    spans: dict[str, list[Span]] = graph["spans"]

    roots = discover_roots(project, cfg)
    root_quals = {r.qual for r in roots}
    edges = _call_edges(project, cg, tuple(cfg.get("dispatch_edges", ())))
    callers = _callers(edges)
    externals = {q for q in project.functions
                 if q not in callers and q not in root_quals}
    init_only = _init_only(project, callers, root_quals)
    entry_held = _entry_locksets(project, edges, spans,
                                 root_quals | externals)

    reach = {q: _reach_from(edges, q) for q in root_quals}
    main_reach: set[str] = set()
    for q in externals:
        main_reach |= _reach_from(edges, q)
    roots_of: dict[str, set[str]] = {}
    for q in project.functions:
        rs = {rq for rq in root_quals if q in reach[rq]}
        if q in main_reach:
            rs.add(MAIN_ROOT)
        if not rs:
            # unreachable from any loaded entry (dynamic dispatch we do
            # not model): assume the main thread can run it
            rs = {MAIN_ROOT}
        roots_of[q] = rs

    lock_attrs = {lc.key.split(".")[-1] for lc in model.classes.values()}

    fields: list[FieldReport] = []
    families: dict[str, list[str]] = {}
    missing: list[str] = []
    for name, fam in _families(project, cfg).items():
        if not fam:
            missing.append(name)
            continue
        primary = next((ci for ci in fam.values() if ci.name == name),
                       next(iter(fam.values())))
        families[name] = sorted(fam)
        class_names = tuple(sorted({ci.name for ci in fam.values()}))
        accesses = _family_accesses(project, fam, lock_attrs)
        for attr, accs in sorted(accesses.items()):
            allowed = _class_default_allowed(fam, attr) or any(
                a.func.module.is_allowed(a.line, TAG)
                or a.func.module.function_allowed(a.func.node, TAG)
                for a in accs)
            post = [a for a in accs if a.func.qual not in init_only]
            writes = [a for a in post if a.write]
            acc_roots: set[str] = set()
            for a in post:
                acc_roots |= roots_of[a.func.qual]
            lockset: frozenset[str] | None = None
            flagged = False
            example: Access | None = None
            if not allowed and writes and len(acc_roots) >= 2:
                inter: set[str] | None = None
                empty_at: Access | None = None
                for a in post:
                    eh = entry_held.get(a.func.qual)
                    if eh is None:
                        continue    # unreached: no opinion
                    ls = eh | _spans_at(spans, a.func.qual, a.line)
                    inter = set(ls) if inter is None else inter & ls
                    if not ls and (empty_at is None or
                                   (a.write and not empty_at.write)):
                        empty_at = a
                if inter is not None:
                    lockset = frozenset(inter)
                    if not inter:
                        flagged = True
                        example = (empty_at
                                   or next(iter(writes), post[0]))
            fields.append(FieldReport(
                family=name, cls_qual=primary.qual,
                class_names=class_names, attr=attr, accesses=accs,
                post_init=post, roots=acc_roots, lockset=lockset,
                allowed=allowed, flagged=flagged, example=example))
    return SharedStateReport(roots=roots, fields=fields,
                             families=families, missing=missing)


def allowed_fields(project: Project, config: dict | None = None
                   ) -> set[tuple[str, str]]:
    """(class name, attr) pairs audited with allow(shared-state),
    expanded over every class in the owning family — the runtime race
    sanitizer matches by concrete ``type(obj).__name__``."""
    rep = analyze(project, config)
    out: set[tuple[str, str]] = set()
    for fr in rep.fields:
        if fr.allowed:
            for cls_name in fr.class_names:
                out.add((cls_name, fr.attr))
    return out


def stats(project: Project, config: dict | None = None,
          report: SharedStateReport | None = None) -> dict:
    cfg = dict(DEFAULT_CONFIG)
    if config:
        cfg.update(config)
    rep = report if report is not None else analyze(project, cfg)
    by_subsystem: dict[str, int] = {s: 0 for s in cfg["root_subsystems"]}
    for r in rep.roots:
        by_subsystem[r.subsystem] = by_subsystem.get(r.subsystem, 0) + 1
    return {
        "roots": len(rep.roots),
        "roots_by_subsystem": dict(sorted(by_subsystem.items())),
        "required_subsystems": list(cfg["root_subsystems"]),
        "classes_configured": len(cfg["classes"]),
        "classes_found": len(rep.families),
        "fields_examined": len(rep.fields),
        "fields_escaped": sum(1 for f in rep.fields
                              if len(f.roots) >= 2
                              and any(a.write for a in f.post_init)),
        "fields_allowed": sum(1 for f in rep.fields if f.allowed),
        "fields_flagged": sum(1 for f in rep.fields if f.flagged),
    }


# --------------------------------------------------------------------------- #
def run(project: Project, config: dict | None = None) -> list[Finding]:
    cfg = dict(DEFAULT_CONFIG)
    if config:
        cfg.update(config)
    rep = analyze(project, cfg)
    findings: list[Finding] = []

    for name in rep.missing:
        findings.append(Finding(
            checker="shared-state", rule="missing-class",
            path="", line=0, symbol=name,
            message=f"configured shared class {name!r} not found — "
                    f"renamed or dropped without updating the checker "
                    f"config (coverage would silently shrink)",
            detail=f"missing:{name}"))

    for fr in rep.fields:
        if not fr.flagged:
            continue
        ex = fr.example
        shown = sorted(fr.roots)
        if len(shown) > 4:
            shown = shown[:4] + [f"+{len(fr.roots) - 4} more"]
        where = (f"{ex.func.module.path}:{ex.line} in {ex.func.qual}"
                 if ex else "?")
        what = "write" if ex is not None and ex.write else "access"
        findings.append(Finding(
            checker="shared-state", rule="unlocked-shared-field",
            path=ex.func.module.path if ex else "",
            line=ex.line if ex else 0,
            symbol=f"{fr.cls_qual}.{fr.attr}",
            message=f"field {fr.cls_qual}.{fr.attr} is shared across "
                    f"roots {{{', '.join(shown)}}} with empty lockset "
                    f"intersection; e.g. unlocked {what} at {where}",
            detail=f"{fr.cls_qual}|{fr.attr}"))

    seen: set[str] = set()
    out: list[Finding] = []
    for f in findings:
        if f.fingerprint not in seen:
            seen.add(f.fingerprint)
            out.append(f)
    return out
