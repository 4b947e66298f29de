"""Runtime lock sanitizer of the port (``REPRO_TORCH_SANITIZE=1``).

Instruments ``threading.Lock`` / ``threading.RLock`` so every lock
*created from the port's source* records the real acquisition order
observed while the test suite runs:

  * each lock instance is keyed to the same *lock class* the static
    checker uses (``storage._StudyShard.lock``) by matching its
    creation site against the AST lock model of
    ``src/repro_torch/core`` — the runtime edge set is directly
    comparable to the static acquisition graph;
  * a watchdog inside ``acquire`` dumps every held lock and all thread
    stacks to stderr when an acquisition stalls longer than
    ``REPRO_TORCH_SANITIZE_STALL`` seconds (default 30) — a suspected
    deadlock becomes a readable report instead of a hung CI job;
  * at session end (see :mod:`.pytest_plugin`),
    :func:`cross_check` compares the observed edges against the static
    graph: an observed order ``a -> b`` where the static graph can
    reach ``a`` from ``b`` is an *inversion* — the combined evidence is
    a cycle — and fails the run.

Only locks created from files under ``src/repro_torch/`` are wrapped
(the separator included, so that a process that also holds the JAX
package's ``src/repro/`` wraps none of its locks); the stdlib's own
locks (``queue``, ``logging``, ``threading.Condition`` internals
created from ``threading.py``) pass through untouched.

``REPRO_TORCH_SANITIZE=race`` layers an Eraser-style shared-state sanitizer
on top (see :func:`install_race`): the concurrency-bearing core classes
get a ``__setattr__`` wrapper that records (thread, field, held
lockset) samples and runs the classic lockset state machine per
(instance, field) — exclusive while one thread owns the field, then a
candidate lockset seeded at the first access from a second thread and
intersected on every later cross-thread write.  An empty observed
intersection is a data race and fails the session.  Fields audited
with ``# repro-check: allow(shared-state)`` are exempt, read from the
same static model the ``shared-state`` checker uses, so the static and
runtime views validate each other.  Every configured class is
imported from ``repro_torch.core`` and instrumented, or
:func:`install_race` raises.  Bare ``threading.Condition()``
objects created from the port's source are given a tracked inner lock in
this mode, so ``with self._cv:`` sections count as locked.
"""
from __future__ import annotations

import importlib
import itertools
import linecache
import os
import sys
import threading
import traceback
from typing import Any

# originals, captured before install() rebinds the factories
_ORIG_LOCK = threading.Lock
_ORIG_RLOCK = threading.RLock
_ORIG_CONDITION = threading.Condition

# the package whose locks and classes are keyed and instrumented
CORE = "src/repro_torch/core"

_STALL_SECONDS = float(os.environ.get("REPRO_TORCH_SANITIZE_STALL", "30"))

_installed = False
_state_lock = _ORIG_LOCK()          # guards the module-global records
_edges: dict[tuple[str, str], str] = {}   # (held, acquired) -> example
_self_edges: dict[str, int] = {}          # key -> times nested with itself
_keys_seen: dict[str, int] = {}           # key -> locks created
_stalls: list[dict[str, Any]] = []
_site_keys: dict[tuple[str, int], str] = {}
_tls = threading.local()
# one clock for creations and acquisitions: lets an edge recorder see
# that the acquired lock was born inside the held lock's critical
# section (the runtime image of the static fresh-instance rule)
_clock = itertools.count()
# thread ident -> (thread name, its held list) — readable cross-thread
# by the stall dump, unlike the threading.local itself
_held_by_thread: dict[int, tuple[str, list]] = {}


def _held() -> list[tuple["_TrackedLock", int]]:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
        t = threading.current_thread()
        with _state_lock:
            _held_by_thread[t.ident or 0] = (t.name, held)
    return held


class _TrackedLock:
    """Order-recording proxy around a real ``Lock``/``RLock``.

    Implements the context-manager and ``acquire``/``release`` surface
    plus (via delegation) the private RLock methods ``Condition``
    needs, so ``threading.Condition(tracked_rlock)`` keeps working.
    """

    def __init__(self, inner: Any, key: str):
        self._inner = inner
        self.key = key
        self.created_by = threading.get_ident()
        self.created_seq = next(_clock)

    # -- acquisition ---------------------------------------------------- #
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not blocking or timeout != -1:
            got = self._inner.acquire(blocking, timeout)
            if got:
                self._note_acquired()
            return got
        waited = 0.0
        dumped = False
        while not self._inner.acquire(timeout=1.0):
            waited += 1.0
            if waited >= _STALL_SECONDS and not dumped:
                dumped = True
                _dump_stall(self, waited)
        self._note_acquired()
        return True

    def release(self) -> None:
        self._inner.release()
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is self:
                del held[i]
                break

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __getattr__(self, name: str) -> Any:
        # Condition compatibility: _is_owned/_acquire_restore/... go to
        # the real lock (order bookkeeping is best-effort around waits)
        return getattr(self._inner, name)

    # -- bookkeeping ---------------------------------------------------- #
    def _note_acquired(self) -> None:
        held = _held()
        seq = next(_clock)
        if any(h is self for h, _ in held):  # RLock re-entry: no new edge
            held.append((self, seq))
            return
        if held:
            me = threading.get_ident()
            where = _caller_site()
            with _state_lock:
                for h, h_seq in held:
                    if (self.created_by == me
                            and self.created_seq > h_seq):
                        # this lock was born inside the held lock's
                        # critical section, on this thread: a private
                        # instance no other thread can contend
                        continue
                    if h.key == self.key:
                        _self_edges[self.key] = \
                            _self_edges.get(self.key, 0) + 1
                    elif (h.key, self.key) not in _edges:
                        _edges[(h.key, self.key)] = where
        held.append((self, seq))


def _caller_site() -> str:
    f: Any = sys._getframe(1)
    while f is not None and f.f_code.co_filename == __file__:
        f = f.f_back
    if f is None:
        return "?"
    return f"{f.f_code.co_filename}:{f.f_lineno}"


def _dump_stall(lock: _TrackedLock, waited: float) -> None:
    lines = [
        f"repro-sanitize: suspected deadlock — thread "
        f"{threading.current_thread().name!r} has waited {waited:.0f}s "
        f"for {lock.key}",
        "repro-sanitize: locks held per thread:",
    ]
    with _state_lock:
        _stalls.append({"key": lock.key, "waited": waited,
                        "thread": threading.current_thread().name})
        holders = {ident: (name, [h.key for h, _ in held])
                   for ident, (name, held) in _held_by_thread.items()}
    for ident, (name, keys) in sorted(holders.items()):
        if keys:
            lines.append(f"  {name} ({ident}): {keys}")
    lines.append("repro-sanitize: all thread stacks:")
    for tid, frame in sys._current_frames().items():
        lines.append(f"  -- thread {tid} --")
        lines.extend("  " + ln.rstrip()
                     for ln in traceback.format_stack(frame))
    print("\n".join(lines), file=sys.stderr, flush=True)


# ----------------------------------------------------------------------- #
# installation
# ----------------------------------------------------------------------- #
def _load_site_keys(repo_root: str) -> dict[tuple[str, int], str]:
    """(abs file, lineno of the ``threading.Lock()`` assignment) ->
    static lock-class key, from the same model the checker uses."""
    from .checkers.lock_order import LockModel
    from .loader import load_core

    project = load_core(repo_root, CORE)
    model = LockModel(project)
    out: dict[tuple[str, int], str] = {}
    for lc in model.classes.values():
        mod = project.modules.get(lc.module)
        if mod is None:
            continue
        abs_path = os.path.realpath(os.path.join(repo_root, mod.path))
        out[(abs_path, lc.line)] = lc.key
    return out


def _repo_root() -> str:
    # src/repro_torch/analysis/sanitize.py -> repo root three levels
    # above src/
    return os.path.realpath(
        os.path.join(os.path.dirname(__file__), "..", "..", ".."))


def _src_prefix(root: str) -> str:
    # with its separator: "src/repro_torch" alone would also be a
    # prefix of a sibling package's path
    return os.path.join(root, "src", "repro_torch") + os.sep


def _make_factory(orig: Any, src_prefix: str):
    def factory(*args: Any, **kwargs: Any) -> Any:
        inner = orig(*args, **kwargs)
        frame = sys._getframe(1)
        fname = os.path.realpath(frame.f_code.co_filename)
        if not fname.startswith(src_prefix):
            return inner
        # extension code (numpy's BitGenerator, etc.) can call the
        # factory with no Python frame of its own — the nearest port
        # frame would be blamed for a lock it never created.  Only wrap
        # when the creating source line really constructs a lock.
        if "Lock(" not in linecache.getline(fname, frame.f_lineno):
            return inner
        key = _site_keys.get((fname, frame.f_lineno))
        if key is None:
            rel = os.path.relpath(fname, _repo_root())
            key = f"{rel}:{frame.f_lineno}"
        with _state_lock:
            _keys_seen[key] = _keys_seen.get(key, 0) + 1
        return _TrackedLock(inner, key)
    return factory


def install(repo_root: str | None = None,
            src_prefix: str | None = None) -> None:
    """Patch the ``threading`` lock factories.  Idempotent."""
    global _installed
    if _installed:
        return
    root = repo_root or _repo_root()
    prefix = src_prefix or _src_prefix(root)
    _site_keys.update(_load_site_keys(root))
    threading.Lock = _make_factory(_ORIG_LOCK, prefix)
    threading.RLock = _make_factory(_ORIG_RLOCK, prefix)
    _installed = True


def installed() -> bool:
    return _installed


# ----------------------------------------------------------------------- #
# race mode (REPRO_SANITIZE=race): Eraser lockset state machine
# ----------------------------------------------------------------------- #
_race_installed = False
_race_prefix = ""
_race_allowed: set[tuple[str, str]] = set()
# id(instance) -> field -> {"owner": ident, "owner_name": str,
#                           "lockset": None (exclusive) | set[str]}
_race_state: dict[int, dict[str, dict[str, Any]]] = {}
_race_seen: set[tuple[str, str]] = set()
_race_violations: list[dict[str, Any]] = []
_race_classes: list[str] = []
_race_class_modules: dict[str, str] = {}   # class -> module it came from
_race_fields_tracked: set[tuple[str, str]] = set()


def _condition_factory(lock: Any = None) -> Any:
    """Replacement ``threading.Condition``: a bare ``Condition()``
    created from the port's source gets a tracked inner RLock keyed to its
    creation site, so critical sections entered through the condition
    count as locked in both the order and race bookkeeping.  Explicit
    locks and callers outside the port pass through untouched."""
    if lock is not None:
        return _ORIG_CONDITION(lock)
    frame: Any = sys._getframe(1)
    fname = os.path.realpath(frame.f_code.co_filename)
    if (not _race_prefix or not fname.startswith(_race_prefix)
            or "Condition(" not in linecache.getline(fname, frame.f_lineno)):
        return _ORIG_CONDITION()
    key = _site_keys.get((fname, frame.f_lineno))
    if key is None:
        rel = os.path.relpath(fname, _repo_root())
        key = f"{rel}:{frame.f_lineno}"
    with _state_lock:
        _keys_seen[key] = _keys_seen.get(key, 0) + 1
    return _ORIG_CONDITION(_TrackedLock(_ORIG_RLOCK(), key))


def _race_skip_value(value: Any) -> bool:
    # synchronization primitives and thread handles are not data fields
    return (isinstance(value, _TrackedLock)
            or type(value).__module__ in ("threading", "_thread"))


def _race_note(obj: Any, name: str, value: Any) -> None:
    if name.startswith("__") or name.startswith("_abc_"):
        return
    if _race_skip_value(value):
        return
    mro_names = [k.__name__ for k in type(obj).__mro__]
    if any((cn, name) in _race_allowed for cn in mro_names):
        return
    cname = mro_names[0]
    t = threading.get_ident()
    held = frozenset(h.key for h, _ in _held())
    with _state_lock:
        _race_fields_tracked.add((cname, name))
        fields = _race_state.setdefault(id(obj), {})
        st = fields.get(name)
        if st is None:
            fields[name] = {
                "owner": t,
                "owner_name": threading.current_thread().name,
                "lockset": None,
            }
            return
        if st["lockset"] is None:
            if st["owner"] == t:
                return                  # still thread-exclusive
            # first access from a second thread: seed the candidate set
            st["lockset"] = set(held)
        else:
            st["lockset"] &= held
        if not st["lockset"] and (cname, name) not in _race_seen:
            _race_seen.add((cname, name))
            _race_violations.append({
                "class": cname,
                "field": name,
                "site": _caller_site(),
                "threads": sorted({st["owner_name"],
                                   threading.current_thread().name}),
            })


def _instrument_class(cls: type) -> None:
    if cls.__dict__.get("__repro_race__"):
        return
    orig_setattr = cls.__setattr__
    orig_init = cls.__init__

    def __setattr__(self: Any, name: str, value: Any) -> None:
        orig_setattr(self, name, value)
        _race_note(self, name, value)

    def __init__(self: Any, *args: Any, **kwargs: Any) -> None:
        # ids are recycled: a new instance at a dead instance's address
        # must not inherit its lockset history
        with _state_lock:
            _race_state.pop(id(self), None)
        orig_init(self, *args, **kwargs)

    cls.__setattr__ = __setattr__      # type: ignore[method-assign]
    cls.__init__ = __init__            # type: ignore[method-assign]
    cls.__repro_race__ = True          # type: ignore[attr-defined]


def install_race(repo_root: str | None = None,
                 src_prefix: str | None = None) -> None:
    """Install the shared-state race sanitizer.  Idempotent; implies
    :func:`install` (lockset samples come from the tracked locks).
    Imports each configured class from ``repro_torch.core`` and raises,
    naming the classes, unless every one was instrumented."""
    global _race_installed, _race_prefix
    if _race_installed:
        return
    install(repo_root, src_prefix)
    root = repo_root or _repo_root()
    _race_prefix = src_prefix or _src_prefix(root)
    threading.Condition = _condition_factory  # type: ignore[misc,assignment]

    from .checkers import shared_state
    from .loader import load_core

    project = load_core(root, CORE)
    _race_allowed.update(shared_state.allowed_fields(project))
    missing: list[str] = []
    for cname in shared_state.DEFAULT_CONFIG["classes"]:
        cls, why = None, "no such class in the core"
        for ci in project.class_by_name(cname):
            modname = "repro_torch.core." + ci.module.name
            try:
                mod = importlib.import_module(modname)
            except ImportError as exc:
                why = f"{modname}: {exc}"
                continue
            cls = getattr(mod, cname, None)
            if isinstance(cls, type):
                break
        if not isinstance(cls, type):
            missing.append(f"{cname} ({why})")
            continue
        _instrument_class(cls)
        _race_classes.append(cname)
        _race_class_modules[cname] = cls.__module__
    if missing:
        raise RuntimeError(
            f"repro-sanitize: configured class(es) {', '.join(missing)} "
            f"not found in repro_torch.core: race mode would not see "
            f"them")
    _race_installed = True


def race_installed() -> bool:
    return _race_installed


def race_report() -> dict[str, Any]:
    with _state_lock:
        return {
            "violations": [dict(v) for v in _race_violations],
            "instrumented_classes": list(_race_classes),
            "class_modules": dict(_race_class_modules),
            "fields_tracked": len(_race_fields_tracked),
            "fields_allowed": len(_race_allowed),
        }


# ----------------------------------------------------------------------- #
# reporting + static cross-check
# ----------------------------------------------------------------------- #
def report() -> dict[str, Any]:
    with _state_lock:
        return {
            "edges": {f"{a} -> {b}": site
                      for (a, b), site in sorted(_edges.items())},
            "self_edges": dict(_self_edges),
            "locks_created": dict(_keys_seen),
            "stalls": list(_stalls),
        }


def cross_check(runtime_edges: dict[tuple[str, str], str],
                static_edges: dict[tuple[str, str], str]
                ) -> dict[str, list]:
    """Compare observed order against the static acquisition graph.

    ``inversions``: observed ``a -> b`` where the static graph reaches
    ``a`` from ``b`` — combined, a cycle (potential deadlock).
    ``unknown``: observed edges the static graph has no opinion on
    (informational; usually locks below the model's resolution).
    """
    adj: dict[str, set[str]] = {}
    for (a, b) in static_edges:
        adj.setdefault(a, set()).add(b)

    reach_cache: dict[str, set[str]] = {}

    def reachable(src: str) -> set[str]:
        if src in reach_cache:
            return reach_cache[src]
        seen: set[str] = set()
        stack = [src]
        while stack:
            n = stack.pop()
            for m in adj.get(n, ()):
                if m not in seen:
                    seen.add(m)
                    stack.append(m)
        reach_cache[src] = seen
        return seen

    inversions, unknown = [], []
    for (a, b), site in sorted(runtime_edges.items()):
        if a in reachable(b):
            inversions.append({"edge": f"{a} -> {b}", "site": site,
                               "static_reverse_path": f"{b} ~> {a}"})
        elif (a, b) not in static_edges:
            unknown.append({"edge": f"{a} -> {b}", "site": site})
    return {"inversions": inversions, "unknown": unknown}


def cross_check_repo(repo_root: str | None = None) -> dict[str, Any]:
    """Full session-end check: observed edges vs the freshly built
    static graph of this repo.  Returns the merged report."""
    from .checkers.lock_order import build_lock_graph
    from .loader import load_core

    root = repo_root or _repo_root()
    graph = build_lock_graph(load_core(root, CORE))
    with _state_lock:
        runtime = dict(_edges)
    out = cross_check(runtime, graph["edges"])
    out.update(report())
    return out
