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
Trees are nested dicts of tensors (or numpy arrays).  The reference's
``shardings`` argument has no counterpart: checkpoints hold plain
tensors, not DTensors; ``restore_tree`` puts each leaf on the device and
dtype of ``like``'s.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Iterator

import numpy as np
import torch


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
    the CPU is copied too, so later in-place updates cannot reach it."""
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


def save_tree(path: str, tree: dict, metadata: dict | None = None) -> None:
    """Blocking atomic save of one tree."""
    flat = {key: _host(leaf) for key, leaf in _items(tree)}
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


def restore_tree(path: str, like: dict) -> dict:
    """Restore into the structure of ``like``: each leaf on the device
    and in the dtype of ``like``'s leaf at the same path, whose shape it
    must have."""
    with np.load(path) as zf:
        flat = {k: zf[k] for k in zf.files}

    def build(node: dict, prefix: str) -> dict:
        out = {}
        for k, leaf in node.items():
            key = f"{prefix}{k}"
            if isinstance(leaf, dict):
                out[k] = build(leaf, key + "/")
                continue
            if key not in flat:
                raise KeyError(f"{path}: no leaf {key!r}")
            arr = flat[key]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"{path}: {key} has shape {arr.shape}, "
                                 f"expected {tuple(leaf.shape)}")
            out[k] = torch.from_numpy(arr).to(device=leaf.device,
                                              dtype=leaf.dtype)
        return out

    return build(like, "")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ---------------- write path ----------------
    def save(self, step: int, tree: dict, metadata: dict | None = None,
             blocking: bool = False) -> None:
        self.wait()                              # single in-flight save
        host_tree = _to_host(tree)                # device->host now
        meta = dict(metadata or {}, step=step)

        def work():
            save_tree(self._path(step), host_tree, meta)
            self._prune()

        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

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

    def restore(self, step: int, like: dict) -> tuple[dict, dict]:
        path = self._path(step)
        tree = restore_tree(path, like)
        meta = {}
        if os.path.exists(path + ".meta"):
            with open(path + ".meta") as f:
                meta = json.load(f)
        return tree, meta

    def restore_latest(self, like: dict) -> tuple[dict, dict] | None:
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(step, like)

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
