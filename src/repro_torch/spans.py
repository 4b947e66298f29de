"""Spans at the port's layer boundaries, on the host's ``time.time_ns()``
clock, recorded while a ``torch.profiler`` runs.

    with spans.span("trainer.batch") as attrs:
        ...
        attrs["bytes"] = n

Recording follows the flag torch sets while any profiler runs, whatever
its activities (``torch.autograd.profiler._is_profiler_enabled``, the
one ``record_function`` reads), so a profile of a worker or of the
service gets these spans over its window and nothing is recorded
otherwise.  A profiler that traces the device alone keeps no
``record_function`` ranges; these spans stand beside it, on the clock
the profiler stamps its events with, so a span compares directly with a
kernel's launch, start and end.

With no profiler running, ``span`` returns one shared no-op context: it
reads no clock and records nothing.  A span entered then stays
unrecorded, even if a profiler starts before it exits.  No span
synchronises the device.

The spans (name: attrs):
  ``trainer.run`` (``steps``), ``trainer.init``, ``trainer.batch``
  (``bytes``), ``trainer.step`` (``step``, ``tokens``), ``trainer.sync``,
  ``trainer.report`` (``pruned``) in ``train/trainer.py``;
  ``step.cast``, ``step.forward`` and ``step.backward`` (``microbatch``),
  ``step.optimizer`` in ``train/step.py``;
  ``model.attention``, ``model.mlp`` (the attention block's two halves,
  each from its norm to its residual add) and ``model.head``
  (``positions``, a row) in ``models/transformer.py``;
  ``serve.prefill`` (``rows``, ``tokens``) in ``serve/engine.py``;
  ``client.ask``, ``client.tell`` in ``core/client.py``;
  ``sampler.suggest`` (``path``: "ask" or "precompute", ``proposals``,
  ``observations``) in ``core/server.py``;
  ``mla.project``, ``mla.core`` in ``models/mla.py``;
  ``moe.route``, ``moe.dispatch``, ``moe.sync``, ``moe.experts``,
  ``moe.combine``, ``moe.shared`` in ``models/deepseek_moe.py``;
  ``trainer.counts`` (each counter's values by its name, e.g.
  ``moe.pairs``: the held experts' pairs by MoE layer) at the end of
  ``Trainer.run``.

Counters (``count``) add a device tensor under a name and a key while a
profiler runs, on the device, in the forward only (not again in a
block's recompute); ``take_counts`` copies them all to the host once
and clears them.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler


@dataclasses.dataclass
class Span:
    """A finished span: ``root`` is the id of the outermost recorded span
    open on its thread when it began (its own id if none was)."""
    name: str
    id: int
    parent: int | None
    root: int
    thread: int
    start: int          # time.time_ns()
    end: int
    attrs: dict


_done: list[Span] = []
_ids = itertools.count(1)
_local = threading.local()


class _Off:
    """The shared context of a span not recorded; what is written into
    it is dropped."""
    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __setitem__(self, key, value) -> None:
        pass


_OFF = _Off()


class _On:
    __slots__ = ("name", "attrs", "id", "parent", "root", "stack", "start")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> dict:
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        self.stack = stack
        stack.append(self)
        self.start = time.time_ns()
        return self.attrs

    def __exit__(self, *exc) -> bool:
        end = time.time_ns()
        self.stack.pop()
        _done.append(Span(self.name, self.id, self.parent, self.root,
                          threading.get_ident(), self.start, end,
                          self.attrs))
        return False


def span(name: str, **attrs):
    """A context over one layer boundary; ``attrs`` are the counts taken
    there, and the context's value takes more (``ctx[key] = value``)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name, attrs)


def recorded() -> list[Span]:
    """The finished spans, in the order they finished."""
    return list(_done)


def clear() -> None:
    _done.clear()


_counts: dict[str, dict] = {}


def counting() -> bool:
    """Whether ``count`` records now: while a profiler runs and autograd
    is not running a backward (where a checkpointed block is computed
    again)."""
    return (_profiler._is_profiler_enabled
            and torch._C._current_graph_task_id() == -1)


def count(name: str, key, value: torch.Tensor) -> None:
    """Adds ``value`` to counter ``name`` at ``key``, on its device, where
    ``counting()``."""
    if not counting():
        return
    group = _counts.setdefault(name, {})
    group[key] = value.detach() + group[key] if key in group else \
        value.detach().clone()


def take_counts() -> dict[str, list]:
    """Every counter's values in the order of their keys, as host lists
    (one copy from the device a counter), by the counter's name, and
    clears them; empty where nothing was counted."""
    out = {name: torch.stack([group[k] for k in sorted(group)]).tolist()
           for name, group in _counts.items()}
    _counts.clear()
    return out
