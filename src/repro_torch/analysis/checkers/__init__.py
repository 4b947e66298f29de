"""Checker registry for repro-check.

Each checker is a callable ``run(project, config=None) -> list[Finding]``.
``CHECKERS`` maps the CLI name to the callable; order is report order.
"""
from __future__ import annotations

from . import (evloop, lock_order, shared_state, thread_hygiene,
               wal_order, wire_schema)

CHECKERS = {
    "lock-order": lock_order.run,
    "evloop-blocking": evloop.run,
    "wal-order": wal_order.run,
    "wire-schema": wire_schema.run,
    "thread-hygiene": thread_hygiene.run,
    "shared-state": shared_state.run,
}

__all__ = ["CHECKERS"]
