"""Deterministic fault injection for durability / replication tests.

Crash-recovery code is only as trustworthy as the crashes it has been
tested against.  This module gives the test-suite named *injection
points* compiled into the production paths (``durable._ensure_durable``,
``replication`` shipping, lease stamping) that are inert unless armed:

* **In-process**: ``install({"name": {...}})`` arms faults for the
  current process — unit tests exercising torn ships or skewed clocks.
* **Cross-process**: the fabric spawns workers as subprocesses, so chaos
  tests arm faults through the ``REPRO_FAULTS`` environment variable (a
  JSON spec, read once at worker startup).  ``set_context`` lets a spec
  target one worker / role ("kill the *leader* of worker 1 before its
  3rd fsync") while every other process ignores it.

Every injector is seeded: given the same spec and the same sequence of
``fire`` calls, the same faults trigger at the same points — chaos runs
are replayable.

Spec format (one entry per fault name)::

    {
      "crash_before_fsync": {"mode": "nth", "n": 3, "worker": 0,
                             "role": "leader"},
      "torn_ship":          {"mode": "once", "arg": "torn"},
      "lease_skew":         {"mode": "always", "arg": -30.0},
    }

``mode`` is ``always`` | ``once`` | ``nth`` (fire only on the n-th
arrival, 1-based).  ``worker`` / ``role`` restrict the fault to a
matching ``set_context``.  ``arg`` carries a per-fault payload (mangle
style, skew seconds).
"""
from __future__ import annotations

import json
import os
import random
import threading
from typing import Any

ENV_VAR = "REPRO_FAULTS"


class FaultInjector:
    """Named, seeded, context-filtered fault points (see module doc)."""

    def __init__(self, spec: dict[str, dict[str, Any]] | None = None,
                 *, seed: int = 0):
        self._spec = dict(spec or {})
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._arrivals: dict[str, int] = {}
        self.fired: dict[str, int] = {}
        self._context: dict[str, Any] = {}

    # -- arming / context ------------------------------------------------
    def set_context(self, **ctx: Any) -> None:
        """Describe the current process (worker id, role, ...) so specs
        carrying matching filter keys only fire here."""
        with self._lock:
            self._context.update(ctx)

    def _matches(self, entry: dict[str, Any]) -> bool:
        for key in ("worker", "role"):
            if key in entry and self._context.get(key) != entry[key]:
                return False
        return True

    # -- the core decision ----------------------------------------------
    def fire(self, name: str) -> bool:
        """True if the named fault should trigger at this arrival.
        Counts every arrival (matching or not armed alike) so ``nth``
        specs are deterministic regardless of when the spec was armed."""
        with self._lock:
            self._arrivals[name] = self._arrivals.get(name, 0) + 1
            entry = self._spec.get(name)
            if entry is None or not self._matches(entry):
                return False
            mode = entry.get("mode", "always")
            hit = False
            if mode == "always":
                hit = True
            elif mode == "once":
                hit = self.fired.get(name, 0) == 0
            elif mode == "nth":
                hit = self._arrivals[name] == int(entry.get("n", 1))
            if hit:
                self.fired[name] = self.fired.get(name, 0) + 1
            return hit

    def arg(self, name: str, default: Any = None) -> Any:
        with self._lock:
            entry = self._spec.get(name) or {}
            return entry.get("arg", default)

    # -- fault flavours ---------------------------------------------------
    def crash(self, name: str) -> None:
        """Die NOW, skipping every atexit/finally handler — the closest a
        test can get to power loss without actually pulling the plug."""
        if self.fire(name):
            os._exit(137)

    def mangle(self, name: str, data: bytes) -> bytes:
        """Corrupt ``data`` in flight: ``arg`` picks the style —
        ``"torn"`` truncates at a seeded offset (a partial send),
        ``"bitflip"`` flips one seeded bit (wire corruption)."""
        if not self.fire(name) or not data:
            return data
        style = self.arg(name, "torn")
        with self._lock:
            if style == "bitflip":
                i = self._rng.randrange(len(data))
                return data[:i] + bytes([data[i] ^ 0x40]) + data[i + 1:]
            # torn: keep a strict prefix (at least 1 byte short)
            cut = self._rng.randrange(max(1, len(data) - 1))
            return data[:cut]

    def skew(self, name: str) -> float:
        """Clock-skew seconds to add at a lease-stamping point (0.0 when
        the fault is not armed/firing)."""
        if self.fire(name):
            return float(self.arg(name, 0.0))
        return 0.0

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {"armed": sorted(self._spec),
                    "fired": dict(self.fired),
                    "arrivals": dict(self._arrivals)}


# ---------------------------------------------------------------------- #
# process-wide injector (inert by default)
# ---------------------------------------------------------------------- #
_injector = FaultInjector()


def injector() -> FaultInjector:
    return _injector


def install(spec: dict[str, dict[str, Any]] | None, *,
            seed: int = 0, **context: Any) -> FaultInjector:
    """Arm the process-wide injector (tests).  ``install(None)`` disarms."""
    global _injector
    _injector = FaultInjector(spec, seed=seed)
    if context:
        _injector.set_context(**context)
    return _injector


def set_context(**ctx: Any) -> None:
    _injector.set_context(**ctx)


def load_from_env(environ: dict[str, str] | None = None) -> FaultInjector:
    """Arm from ``REPRO_FAULTS`` (JSON: ``{"seed": 0, "faults": {...}}``
    or just the fault dict).  Called once per worker process at startup;
    a missing/empty variable leaves the injector inert."""
    raw = (environ if environ is not None else os.environ).get(ENV_VAR, "")
    if not raw.strip():
        return _injector
    spec = json.loads(raw)
    if "faults" in spec:
        return install(spec["faults"], seed=int(spec.get("seed", 0)))
    return install(spec)


# convenience passthroughs used by the injection points
def fire(name: str) -> bool:
    return _injector.fire(name)


def crash(name: str) -> None:
    _injector.crash(name)


def mangle(name: str, data: bytes) -> bytes:
    return _injector.mangle(name, data)


def skew(name: str) -> float:
    return _injector.skew(name)
