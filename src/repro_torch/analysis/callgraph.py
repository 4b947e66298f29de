"""Call-graph construction with best-effort method resolution.

The graph is *may-call*: an edge means the caller can plausibly reach the
callee.  Resolution handles the shapes the core package actually uses —

  * bare names (module functions, imported functions),
  * ``self.method()`` through the loaded MRO **and** loaded subclass
    overrides (virtual dispatch: ``InMemoryStorage.add_trial`` calling
    ``self._log`` must reach ``DurableStorage._log``),
  * ``Class.method()`` / ``obj.method()`` where ``obj`` was constructed
    from a loaded class in the same function,
  * a unique-method-name fallback for everything else (sound for
    may-block analysis; annotations cut the false edges that matter).

Also home to the blocking-primitive classifier shared by the lock-order
and event-loop checkers.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from typing import Callable, Iterable

from .loader import FunctionInfo, Module, Project


@dataclasses.dataclass(frozen=True)
class CallSite:
    caller: str                  # qual of the calling function
    path: str
    line: int
    text: str                    # unparsed call expression (truncated)
    # receiver is an instance constructed in the calling function
    # (``shadow = InMemoryStorage(); shadow.load_state(...)``) — its
    # locks are private and must not alias the live store's lock classes
    fresh: bool = False


@dataclasses.dataclass(frozen=True)
class BlockingCall:
    kind: str                    # "fsync" | "socket" | "sleep" | ...
    site: CallSite
    chain: tuple[str, ...]       # qualified call chain from the entry


# attribute names that mean a blocking syscall on the receiver
_SOCKET_ATTRS = {"sendall", "recv", "recv_into", "accept", "connect",
                 "getresponse", "send", "makefile", "sendfile"}
_PROC_ATTRS = {"communicate"}
_THREADISH = ("thread", "proc", "worker", "flusher", "compactor",
              "monitor", "_t", "child")

# method names whose unique-name fallback resolution is noise, not signal:
# they collide with builtin dict/list/set/str/file methods used everywhere
_FALLBACK_DENY = {
    "get", "pop", "update", "items", "keys", "values", "add", "remove",
    "clear", "append", "extend", "insert", "discard", "setdefault",
    "popitem", "copy", "count", "index", "sort", "split", "strip",
    "join", "read", "write", "encode", "decode", "format", "replace",
    "startswith", "endswith", "lower", "upper", "stop", "start",
    "submit", "put", "get_nowait", "put_nowait",
    # file-object methods: ``self._active_file.flush()`` must not alias
    # the storage classes' flush()/close() overrides
    "flush", "close",
}


def classify_blocking(call: ast.Call, module: Module,
                      imports: dict[str, str]) -> str | None:
    """Blocking-primitive kind of ``call``, or None."""
    fn = call.func
    if isinstance(fn, ast.Name):
        target = imports.get(fn.id, fn.id)
        if target in ("time.sleep", "sleep"):
            return "sleep"
        if target in ("os.fsync", "os.fdatasync", "fsync", "fdatasync"):
            return "fsync"
        return None
    if not isinstance(fn, ast.Attribute):
        return None
    attr = fn.attr
    recv = ast.unparse(fn.value)
    recv_root = recv.split(".")[0].split("[")[0]
    dotted = imports.get(recv_root, recv_root)
    if attr == "sleep" and dotted == "time":
        return "sleep"
    if attr in ("fsync", "fdatasync") and dotted == "os":
        return "fsync"
    if attr in ("flock", "lockf") and dotted == "fcntl":
        return "flock"
    if attr in _SOCKET_ATTRS:
        # str.startswith-style false positives are impossible for these
        # names; ``send`` on non-blocking sockets is excused by
        # annotation at the audited sites.
        return "socket"
    if attr in _PROC_ATTRS:
        return "subprocess"
    if attr == "wait":
        # Condition.wait under its *own* condition releases the lock —
        # the lock-order checker exempts that case by receiver; every
        # other .wait() (Popen, Event, foreign Condition) blocks.
        return "wait"
    if attr == "join":
        # distinguish Thread.join from str.join: a thread-ish receiver
        # name, or a no-arg / numeric-timeout call.
        low = recv.lower()
        if any(t in low for t in _THREADISH):
            return "join"
        if not call.args:
            return "join"
        if (len(call.args) == 1
                and isinstance(call.args[0], ast.Constant)
                and isinstance(call.args[0].value, (int, float))):
            return "join"
    return None


def _ann_class_name(text: str) -> str:
    """``HopaasServer`` / ``Optional[RouteTable]`` / ``x.Y | None`` ->
    the bare class name (best effort)."""
    text = text.strip().strip("'\"")
    m = re.fullmatch(r"Optional\[(.+)\]", text)
    if m:
        text = m.group(1)
    text = text.split("|")[0].strip()
    return text.split(".")[-1].strip("'\"")


class CallGraph:
    def __init__(self, project: Project):
        self.project = project
        # qual -> list[(callee FunctionInfo, CallSite)]
        self._edges: dict[str, list[tuple[FunctionInfo, CallSite]]] = {}
        # qual -> list[(blocking kind, CallSite)]
        self._direct_blocking: dict[str, list[tuple[str, CallSite]]] = {}
        # class qual -> {attr -> class qual}: ``self.server = server``
        # where the param is annotated, or ``self.x = SomeClass(...)``
        self._attr_types = self._class_attr_types()
        self._build()

    def _class_attr_types(self) -> dict[str, dict[str, str]]:
        out: dict[str, dict[str, str]] = {}
        for info in self.project.classes.values():
            types: dict[str, str] = {}
            ambiguous: set[str] = set()

            def note(attr: str, qual: str) -> None:
                if types.get(attr, qual) != qual:
                    ambiguous.add(attr)
                types[attr] = qual

            for m in info.methods.values():
                ann: dict[str, str] = {}
                args = list(m.node.args.args) + list(
                    m.node.args.kwonlyargs)
                for arg in args:
                    if arg.annotation is None:
                        continue
                    name = _ann_class_name(ast.unparse(arg.annotation))
                    for cand in self.project.class_by_name(name):
                        ann[arg.arg] = cand.qual
                        break
                for node in ast.walk(m.node):
                    target = value = None
                    if isinstance(node, ast.Assign) \
                            and len(node.targets) == 1:
                        target, value = node.targets[0], node.value
                    elif isinstance(node, ast.AnnAssign):
                        target, value = node.target, node.value
                    if not (isinstance(target, ast.Attribute)
                            and isinstance(target.value, ast.Name)
                            and target.value.id == "self"):
                        continue
                    if (isinstance(node, ast.AnnAssign)
                            and node.annotation is not None):
                        name = _ann_class_name(
                            ast.unparse(node.annotation))
                        for cand in self.project.class_by_name(name):
                            note(target.attr, cand.qual)
                            break
                        continue
                    if isinstance(value, ast.Call) and isinstance(
                            value.func, ast.Name):
                        for cand in self.project.class_by_name(
                                value.func.id):
                            note(target.attr, cand.qual)
                            break
                    elif isinstance(value, ast.Name) and value.id in ann:
                        note(target.attr, ann[value.id])
            for attr in ambiguous:
                types.pop(attr, None)
            out[info.qual] = types
        return out

    # ------------------------------------------------------------------ #
    def _build(self) -> None:
        for fi in self.project.functions.values():
            edges: list[tuple[FunctionInfo, CallSite]] = []
            blocking: list[tuple[str, CallSite]] = []
            imports = self.project.imports.get(fi.module.name, {})
            local_types = self._infer_local_types(fi)
            for node in ast.walk(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                fresh = (isinstance(node.func, ast.Attribute)
                         and isinstance(node.func.value, ast.Name)
                         and node.func.value.id in local_types)
                site = CallSite(
                    caller=fi.qual, path=fi.module.path,
                    line=node.lineno,
                    text=ast.unparse(node)[:120],
                    fresh=fresh)
                kind = classify_blocking(node, fi.module, imports)
                if kind is not None:
                    blocking.append((kind, site))
                for callee in self._resolve(fi, node, imports, local_types):
                    edges.append((callee, site))
            self._edges[fi.qual] = edges
            self._direct_blocking[fi.qual] = blocking

    def _infer_local_types(self, fi: FunctionInfo) -> dict[str, str]:
        """name -> class qual for ``x = SomeLoadedClass(...)`` locals."""
        out: dict[str, str] = {}
        for node in ast.walk(fi.node):
            if (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)
                    and isinstance(node.value.func, ast.Name)):
                for cand in self.project.class_by_name(node.value.func.id):
                    out[node.targets[0].id] = cand.qual
        return out

    def _resolve(self, fi: FunctionInfo, call: ast.Call,
                 imports: dict[str, str], local_types: dict[str, str]
                 ) -> list[FunctionInfo]:
        fn = call.func
        if isinstance(fn, ast.Name):
            # module function in the same module
            mod_qual = f"{fi.module.name}.{fn.id}"
            if mod_qual in self.project.functions:
                return [self.project.functions[mod_qual]]
            # imported function from a loaded module
            target = imports.get(fn.id)
            if target:
                tail = target.split(".")
                for k in range(1, len(tail)):
                    qual = ".".join(tail[-k - 1:])
                    if qual in self.project.functions:
                        return [self.project.functions[qual]]
            # constructor of a loaded class
            ctors = []
            for cand in self.project.class_by_name(fn.id):
                init = cand.methods.get("__init__")
                if init:
                    ctors.append(init)
            return ctors
        if not isinstance(fn, ast.Attribute):
            return []
        attr = fn.attr
        recv = fn.value
        # self.method() — MRO plus loaded subclass overrides
        if isinstance(recv, ast.Name) and recv.id == "self" and fi.cls:
            out: dict[str, FunctionInfo] = {}
            for cls in self.project.mro(fi.cls):
                if attr in cls.methods and attr not in out:
                    out[cls.qual] = cls.methods[attr]
            for sub in self.project.subclasses(fi.cls):
                if attr in sub.methods:
                    out[sub.qual] = sub.methods[attr]
            if out:
                return list(out.values())
        # Class.method() / obj.method() with an inferred local type
        if isinstance(recv, ast.Name):
            cls_qual = local_types.get(recv.id)
            if cls_qual is None:
                for cand in self.project.class_by_name(recv.id):
                    cls_qual = cand.qual
                    break
            if cls_qual:
                for cls in self.project.mro(cls_qual):
                    if attr in cls.methods:
                        return [cls.methods[attr]]
        # self.attr.method() with a typed instance attribute — resolve
        # through the attribute class's MRO plus loaded overrides
        # (virtual dispatch), never through the name-soup fallback
        if (isinstance(recv, ast.Attribute)
                and isinstance(recv.value, ast.Name)
                and recv.value.id == "self" and fi.cls):
            t = self._attr_types.get(fi.cls, {}).get(recv.attr)
            if t:
                out: dict[str, FunctionInfo] = {}
                for cls in self.project.mro(t):
                    if attr in cls.methods and attr not in out:
                        out[cls.qual] = cls.methods[attr]
                for sub in self.project.subclasses(t):
                    if attr in sub.methods:
                        out[sub.qual] = sub.methods[attr]
                if out:
                    return list(out.values())
        # fallback: every loaded method with this name (may-call) —
        # except names shared with builtin collections/strings, which
        # produce wildly false edges (a dict's .pop is not RouteTable.pop)
        if attr in _FALLBACK_DENY:
            return []
        cands = self.project.methods_by_name.get(attr, [])
        if 0 < len(cands) <= 6:
            return list(cands)
        return []

    # ------------------------------------------------------------------ #
    def calls_in(self, qual: str) -> list[tuple[FunctionInfo, CallSite]]:
        return self._edges.get(qual, [])

    def direct_blocking(self, qual: str) -> list[tuple[str, CallSite]]:
        return self._direct_blocking.get(qual, [])

    def reachable_blocking(
            self, entry: str, *, allow_tag: str,
            skip_call: Callable[[CallSite], bool] | None = None,
            max_depth: int = 12) -> list[BlockingCall]:
        """Blocking primitives reachable from ``entry``.

        Traversal stops at call sites (or whole functions) annotated with
        ``# repro-check: allow(<allow_tag>)`` and at sites where
        ``skip_call`` returns True.
        """
        out: list[BlockingCall] = []
        seen: set[str] = set()

        def visit(qual: str, chain: tuple[str, ...], depth: int) -> None:
            if qual in seen or depth > max_depth:
                return
            seen.add(qual)
            fi = self.project.functions.get(qual)
            if fi is not None and fi.module.function_allowed(
                    fi.node, allow_tag):
                return
            for kind, site in self.direct_blocking(qual):
                mod = self._module_of(qual)
                if mod is not None and mod.is_allowed(site.line, allow_tag):
                    continue
                if skip_call is not None and skip_call(site):
                    continue
                out.append(BlockingCall(kind=kind, site=site,
                                        chain=chain + (qual,)))
            for callee, site in self.calls_in(qual):
                mod = self._module_of(qual)
                if mod is not None and mod.is_allowed(site.line, allow_tag):
                    continue
                if skip_call is not None and skip_call(site):
                    continue
                visit(callee.qual, chain + (qual,), depth + 1)

        visit(entry, (), 0)
        return out

    def _module_of(self, qual: str) -> Module | None:
        fi = self.project.functions.get(qual)
        return fi.module if fi else None

    def transitive_callees(self, entry: str, max_depth: int = 12
                           ) -> Iterable[str]:
        seen: set[str] = set()
        stack = [(entry, 0)]
        while stack:
            qual, depth = stack.pop()
            if qual in seen or depth > max_depth:
                continue
            seen.add(qual)
            yield qual
            for callee, _ in self.calls_in(qual):
                stack.append((callee.qual, depth + 1))
