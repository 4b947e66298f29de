"""Checkpointing for fault-tolerant training, in the reference's format.

* **Atomic**: writes go to ``step_XXXX.npz.tmp`` then ``os.replace`` — a
  crash mid-save never corrupts the latest checkpoint.
* **Async**: the device-to-host copy happens on the caller's thread,
  serialization + fsync on a background thread — the train loop blocks
  only if a previous save is still in flight (single-buffer
  back-pressure).
* **Self-pruning**: keeps the newest ``keep`` checkpoints.

Format (the reference's, so that a checkpoint written by either package
restores in the other): one ``.npz`` per step whose keys are the
``/``-joined dict paths of the leaves (``params/blocks/attn/wq``,
``opt_state/step``), bf16 stored as fp32 (exact), plus a ``.meta`` JSON.
Trees are nested dicts of tensors (or numpy arrays) and may hold
DTensors (``repro_torch.dist``): a leaf is stored whole, as the
reference stores a sharded array.  Saving such a tree is collective:
every rank gathers each DTensor leaf (``full_tensor()``, on the caller's
thread, as the device-to-host copy is), rank 0 writes, and the others
wait for the write at a barrier (a blocking save before it returns, an
async one at the next ``save`` or ``wait``).  ``restore_tree`` puts each
leaf on the device and dtype of ``like``'s; with ``shardings`` (the tree
``dist.sharding.tree_shardings`` gives) every rank reads the file and
keeps its own shard of each leaf, in that layout, which need not be the
one saved (as the reference's ``restore`` re-derives the layout).
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Iterator

import numpy as np
import torch

from ..dist.context import is_dtensor
from ..dist.sharding import distribute_leaf


def _items(tree: dict, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(``/``-joined path, leaf) pairs of a nested dict."""
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _items(v, path + "/")
        else:
            yield path, v


def _host(leaf: Any) -> np.ndarray:
    """A copy of ``leaf`` on the host (bf16 as fp32, exact): a tensor on
    the CPU is copied too, so later in-place updates cannot reach it; a
    DTensor is gathered whole first (a collective)."""
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def _to_host(tree: dict) -> dict:
    """The tree with every leaf copied to a numpy array on the host."""
    return {k: _to_host(v) if isinstance(v, dict) else _host(v)
            for k, v in tree.items()}


def _sharded(tree: dict) -> bool:
    return any(is_dtensor(leaf) for _, leaf in _items(tree))


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank()


def _barrier() -> None:
    import torch.distributed as dist
    dist.barrier()


def save_tree(path: str, tree: dict, metadata: dict | None = None) -> None:
    """Blocking atomic save of one tree.  A tree with DTensor leaves is
    gathered by every rank and written by rank 0; every rank returns once
    the file is written."""
    sharded = _sharded(tree)
    flat = {key: _host(leaf) for key, leaf in _items(tree)}
    if not sharded or _rank() == 0:
        _write(path, flat, metadata)
    if sharded:
        _barrier()


def _write(path: str, flat: dict, metadata: dict | None) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    if metadata is not None:
        mtmp = path + ".meta.tmp"
        with open(mtmp, "w") as f:
            json.dump(metadata, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(mtmp, path + ".meta")


def restore_tree(path: str, like: dict, shardings: Any = None) -> dict:
    """Restore into the structure of ``like``: each leaf on the device
    and in the dtype of ``like``'s leaf at the same path, whose shape it
    must have; with ``shardings`` (a tree of ``dist.sharding.Sharding``
    of the same keys) each leaf a DTensor laid out so, of which this
    rank keeps its own shard."""
    with np.load(path) as zf:
        flat = {k: zf[k] for k in zf.files}

    def build(node: dict, prefix: str, sh: Any) -> dict:
        out = {}
        for k, leaf in node.items():
            key = f"{prefix}{k}"
            if isinstance(leaf, dict):
                out[k] = build(leaf, key + "/", None if sh is None else sh[k])
                continue
            if key not in flat:
                raise KeyError(f"{path}: no leaf {key!r}")
            arr = flat[key]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"{path}: {key} has shape {arr.shape}, "
                                 f"expected {tuple(leaf.shape)}")
            t = torch.from_numpy(arr).to(device=leaf.device,
                                         dtype=leaf.dtype)
            out[k] = t if sh is None else distribute_leaf(sh[k], t)
        return out

    return build(like, "", shardings)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._barrier_due = False

    # ---------------- write path ----------------
    def save(self, step: int, tree: dict, metadata: dict | None = None,
             blocking: bool = False) -> None:
        """Save ``tree`` as ``step``.  A tree with DTensor leaves is
        gathered by every rank (a collective) and written by rank 0; the
        others meet it at a barrier once the write is done: before a
        blocking save returns, else at the next ``save`` or ``wait``."""
        self.wait()                              # single in-flight save
        sharded = _sharded(tree)
        host_tree = _to_host(tree)                # device->host now
        meta = dict(metadata or {}, step=step)
        self._barrier_due = sharded

        def work():
            save_tree(self._path(step), host_tree, meta)
            self._prune()

        if sharded and _rank() != 0:
            pass                                  # rank 0 writes
        elif blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier_due:
            self._barrier_due = False
            _barrier()

    # ---------------- read path ----------------
    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        out = []
        for fn in os.listdir(self.directory):
            if fn.startswith("step_") and fn.endswith(".npz"):
                out.append(int(fn[5:-4]))
        return sorted(out)

    def restore(self, step: int, like: dict, shardings: Any = None
                ) -> tuple[dict, dict]:
        path = self._path(step)
        tree = restore_tree(path, like, shardings)
        meta = {}
        if os.path.exists(path + ".meta"):
            with open(path + ".meta") as f:
                meta = json.load(f)
        return tree, meta

    def restore_latest(self, like: dict, shardings: Any = None
                       ) -> tuple[dict, dict] | None:
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(step, like, shardings)

    # ---------------- internals ----------------
    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.npz")

    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            for suffix in (".npz", ".npz.meta"):
                p = os.path.join(self.directory, f"step_{s:08d}{suffix}")
                if os.path.exists(p):
                    os.remove(p)
