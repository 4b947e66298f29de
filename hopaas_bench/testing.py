"""Cells at the port's smoke sizes, for the CPU tests: the cell's
configuration file with the smoke configuration's sizes (float32), each
of its groups (``harness.config_groups``: ``moe``, ``ssm``, ``rwkv`` or a
``ModelConfig`` subclass's own) at the smoke configuration's values, its
traffic cut to a few short requests or steps, its limits as they are
but for the first token's gap, which is in logits: the smoke models'
logits spread a sixth as wide as the full sizes', so their gap limit is
``TINY_GAP`` (the float32 program reads 0 there).

``bench_copy`` points the harness at a copy of the manifest and the data
files, for tests that add a configuration, a cell or a metric as a later
change would: by new files and new manifest entries alone."""
from __future__ import annotations

import copy
import shutil
import time
from pathlib import Path

import torch

from . import harness

TINY_GAP = 0.05
TINY_TRAFFIC = {
    "hpo_train": dict(history=30, steps_per_trial=3, global_batch=2,
                      seq_len=16, microbatches=1, checked_steps=2),
    "prefill": dict(batch=4, lengths=[8, 16], weights=[1, 1], max_rate=200,
                    sample=8),
}


def tiny_cell(name: str) -> harness.Cell:
    from repro_torch.models.registry import get_config

    cell = copy.deepcopy(harness.load_cell(name))
    conf = cell.config
    c = get_config(conf["arch"], smoke=True)
    conf.update(smoke=True, dtype="float32",
                **{k: getattr(c, k) for k in harness.SIZE_KEYS})
    for mode in ("train", "serve"):
        conf[mode]["param_dtype"] = "float32"
    for g in harness.config_groups(conf, c):
        conf[g] = {k: getattr(getattr(c, g), k) for k in conf[g]}
    cell.traffic.update(TINY_TRAFFIC[cell.traffic["kind"]])
    if "first_token_gap" in cell.limits["numbers"]:
        cell.limits["numbers"]["first_token_gap"]["limit"] = TINY_GAP
    return cell


def tiny_run(name: str, seed: int, seconds: float = 0.5,
             faults: frozenset = frozenset()) -> harness.Run:
    return harness.Run(tiny_cell(name), seed, seconds, False,
                       torch.device("cpu"), time.time_ns(), faults)


def bench_copy(tmp: Path, monkeypatch) -> Path:
    """Copies ``BENCHMARK.json`` and the benchmark's data folders
    (configurations, traffic, limits, metric readers) under ``tmp`` and
    points ``harness.ROOT`` and ``harness.BENCH`` at the copy for the
    test (``monkeypatch``) -> the copy's benchmark folder."""
    bench = tmp / harness.BENCH.name
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(harness.BENCH / sub, bench / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp)
    monkeypatch.setattr(harness, "ROOT", tmp)
    monkeypatch.setattr(harness, "BENCH", bench)
    return bench
