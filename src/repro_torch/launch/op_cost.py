"""Per-device cost of a step from the operations it dispatches (the
counterpart of the reference's ``hlo_cost``, which parses XLA's HLO;
the port has no HLO).

``OpCounter`` is a ``TorchDispatchMode``.  For an op on DTensors it
returns ``NotImplemented``, so DTensor runs and desugars the op into the
local ops and collectives of this rank, which come back through the mode:
the counts are one device's.  That is the per-device rule, and it holds
whatever the sharding does:

* ``flops``: the local products' FLOPs, by ``FlopCounterMode``'s
  formulas (``torch.utils.flop_counter.flop_registry``).  A product
  sharded over a mesh dim counts its shard; a replicated one counts the
  whole product on every device (the work each device repeats); a
  ``Partial`` one counts the slice of the contraction the device holds.
  The products, the embedding and the NLL that ``dist.shard_ops`` runs
  on local shards come through as local ops too.
* ``bytes``: each local op's reads and writes, inputs and outputs once
  (view ops move nothing; a broadcast input counts its distinct
  elements, and a factory such as ``new_zeros`` reads no input, so
  PyTorch versions whose formulas differ there count alike).  The port runs unfused, so that is what it
  moves through HBM.
* collectives: each ``_c10d_functional`` op's bytes under the ring
  traffic model ``_TRAFFIC`` (per device, group size g), as the
  reference counts XLA's:
    all-gather: out x (g-1)/g       all-reduce: 2 x out x (g-1)/g
    reduce-scatter: out x (g-1)     all-to-all: out x (g-1)/g
    collective-permute: out
  ``CommDebugMode`` counts the same collectives by name
  (``Cost.comm_debug_calls``), a check on the interception;
* memory: each local op's new storages, counted from the op that makes
  them until they are freed (``MemTracker``'s algorithm, on the local
  ops only), and their peak, by kind: what ``track`` registered before
  the step (parameters, optimizer state, inputs), activations (made in
  the forward or its recomputation) and backward temporaries (made
  while autograd runs a node: gradients among them).  ``MemTracker``
  of PyTorch 2.11 also counts the fake tensors DTensor propagates
  shardings on, so the dry run reads the peak here.

Ops that DTensor runs on fake tensors to propagate shardings are not the
step's and are skipped, as ``MemTracker`` skips them.
"""
from __future__ import annotations

import dataclasses
import sys
import weakref
from collections import defaultdict
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_TRAFFIC = {
    "all-gather": lambda out, g: out * (g - 1) / g,
    "all-reduce": lambda out, g: 2 * out * (g - 1) / g,
    "reduce-scatter": lambda out, g: out * (g - 1),
    "all-to-all": lambda out, g: out * (g - 1) / g,
    "collective-permute": lambda out, g: out,
}

# _c10d_functional op name -> collective (the coalesced and autograd
# forms share their base name)
_FUNCOL = (("all_gather_into_tensor", "all-gather"),
           ("reduce_scatter_tensor", "reduce-scatter"),
           ("all_reduce", "all-reduce"),
           ("all_to_all_single", "all-to-all"),
           ("broadcast", "collective-permute"))


def _is_score_shaped(shape: tuple[int, ...]) -> bool:
    """(..., S, S) with S >= 2048 and >= 4 dims: an attention score or
    probability tensor (weight matrices have unequal trailing dims)."""
    return len(shape) >= 4 and shape[-1] == shape[-2] and shape[-1] >= 2048


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    by_collective: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    collective_calls: dict = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    # traffic of attention-score-shaped tensors: what a fused flash
    # kernel keeps on chip
    score_traffic: float = 0.0
    comm_debug_calls: dict = dataclasses.field(default_factory=dict)


def _nbytes(t: torch.Tensor) -> int:
    """The bytes of ``t``'s distinct elements: a broadcast (stride 0)
    dim is read once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else 1
    return n * t.element_size()


def _tensors(tree: Any) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _collective(name: str) -> str | None:
    if "c10d_functional" not in name:
        return None
    for key, kind in _FUNCOL:
        if key in name:
            return kind
    return None


def _group_size(args: tuple, kwargs: dict) -> int:
    """A funcol op's group size: its ``group_size`` argument where it
    has one, else the size of the group it names."""
    names = [a for a in (*args, *kwargs.values()) if isinstance(a, str)]
    if names:                          # (..., reduce op, group name)
        from torch.distributed.distributed_c10d import _resolve_process_group
        return _resolve_process_group(names[-1]).size()
    ints = [a for a in args if isinstance(a, int)]
    return ints[-1] if ints else 1


def _context(skip: int = 0) -> str:
    """The innermost port function (outside ``dist`` and ``launch``) on
    the stack: ``module.function``."""
    frame = sys._getframe(skip + 1)
    while frame is not None:
        name = frame.f_globals.get("__name__", "")
        if (name.startswith("repro_torch.")
                and not name.startswith(("repro_torch.launch",
                                         "repro_torch.dist"))):
            return f"{name.rsplit('.', 1)[-1]}.{frame.f_code.co_name}"
        frame = frame.f_back
    return "-"


class OpCounter(TorchDispatchMode):
    """Counts one device's FLOPs, bytes and collective traffic of the
    ops run under it (see the module docstring).  With ``record=True``
    it also keeps a row per op: (bytes, flops, collective bytes, op,
    output shape, the port function that issued it)."""

    def __init__(self, record: bool = False):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = flop_registry
        self.cost = Cost()
        self.rows: list[tuple] | None = [] if record else None
        self._entry_fake = None
        self._storages: dict[int, tuple[int, str]] = {}
        self.live: dict[str, int] = defaultdict(int)
        self.peak = 0
        self.peak_by_kind: dict[str, int] = {}

    def track(self, tensors, kind: str) -> None:
        """Count ``tensors``' storages (a DTensor's local one) as ``kind``
        until they are freed."""
        for t in tensors:
            self._add(getattr(t, "_local_tensor", t), kind)
        self._update_peak()

    def _add(self, t: torch.Tensor, kind: str) -> None:
        from torch.distributed._functional_collectives import (
            AsyncCollectiveTensor)
        if isinstance(t, AsyncCollectiveTensor):
            t = t.elem                  # a collective's output, wrapped
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        self._storages[key] = (st.nbytes(), kind)
        self.live[kind] += st.nbytes()
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        nbytes, kind = self._storages.pop(key)
        self.live[kind] -= nbytes

    def _update_peak(self) -> None:
        total = sum(self.live.values())
        if total > self.peak:
            self.peak, self.peak_by_kind = total, dict(self.live)

    def __enter__(self):
        from torch._guards import active_fake_mode
        self._entry_fake = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(t is DTensor for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._entry_fake:
            return out                      # DTensor's sharding propagation
        name = str(func)
        fl = by = co = 0.0
        kind = _collective(name)
        outs = _tensors(out)
        if kind is not None:
            g = max(_group_size(args, kwargs), 1)
            co = _TRAFFIC[kind](sum(map(_nbytes, outs)), g)
            self.cost.collective_bytes += co
            self.cost.by_collective[kind] += co
            self.cost.collective_calls[kind] += 1
        elif "c10d" not in name and not getattr(func, "is_view", False):
            packet = getattr(func, "_overloadpacket", None)
            if packet in self.flop_registry:
                fl = float(self.flop_registry[packet](*args, **kwargs,
                                                      out_val=out))
                self.cost.flops += fl
            if not name.startswith(("aten.empty", "prim.")):
                # a factory that takes a tensor (new_zeros, zeros_like)
                # reads only its dtype and device
                ins = ([] if name.startswith("aten.new_")
                       or name.split(".")[1].endswith("_like")
                       else _tensors((args, kwargs)))
                by = float(sum(map(_nbytes, ins)) + sum(map(_nbytes, outs)))
                self.cost.bytes += by
                if any(_is_score_shaped(tuple(t.shape)) for t in ins + outs):
                    self.cost.score_traffic += by
        made = ("Temp" if torch._C._current_autograd_node() is not None
                else "Activation")
        for t in outs:
            self._add(t, made)
        self._update_peak()
        if self.rows is not None and (fl or by or co):
            shape = tuple(outs[0].shape) if outs else ()
            self.rows.append((by, fl, co, name.split(".")[1]
                              if name.startswith("aten.") else name,
                              shape, _context(1)))
        return out


def count(fn: Callable, *args, record: bool = False,
          tracked: dict | None = None, **kwargs
          ) -> tuple[Any, Cost, list | None, "OpCounter"]:
    """-> (fn's result, its per-device ``Cost``, the per-op rows if
    ``record``, the counter with its memory peak), with
    ``CommDebugMode``'s collective counts beside.  ``tracked`` maps a
    kind to the tensors that hold memory before the step."""
    from torch.distributed.tensor.debug import CommDebugMode
    counter = OpCounter(record)
    for kind, tensors in (tracked or {}).items():
        counter.track(tensors, kind)
    comms = CommDebugMode()
    with comms, counter:
        result = fn(*args, **kwargs)
    counter.cost.comm_debug_calls = {
        str(k).rsplit(".", 1)[-1]: int(v)
        for k, v in comms.get_comm_counts().items()}
    return result, counter.cost, counter.rows, counter

