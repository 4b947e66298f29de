"""repro-check for the port: static analysis + runtime lock sanitizer
over ``src/repro_torch/core``.

Static side (``python -m repro_torch.analysis``): an AST/call-graph
framework (:mod:`.loader`, :mod:`.callgraph`, :mod:`.findings`) with six
checkers (:mod:`.checkers`) guarding invariants the test suite cannot
see directly — lock acquisition order, the never-block rule of the
event-loop IO thread, write-ahead journaling order, client/server wire
agreement, thread hygiene, and unlocked shared state.  The findings and
the ``# repro-check: allow(<tag>)`` annotations are those of the JAX
package's suite, field for field.

Runtime side (:mod:`.sanitize`, switched on through
:mod:`.pytest_plugin` with ``REPRO_TORCH_SANITIZE=1|race``): an
instrumented lock wrapper that records the real acquisition order of
the port's locks and cross-checks it against the static graph, a
watchdog that dumps every held lock and all thread stacks on a
suspected deadlock, and an Eraser-style lockset race detector over the
port's concurrency-bearing classes.
"""
from .findings import Baseline, Finding
from .loader import Project, load_core

__all__ = ["Baseline", "Finding", "Project", "load_core"]
