"""What every cell's run shares: the manifest and a cell's files, the
port's model configuration checked against the configuration file, the
benchmark's own weights, host spans, the device trace and the result
line.

Times are ``time.time_ns()``: the clock the profiler stamps its events
with, so a host span and a device event compare directly (the trace's
marker kernel measures what is left of an offset).
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import re
import sys
import time
from pathlib import Path
from typing import Callable

import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names a run may not hold: JAX and the JAX package
BANNED = ("jax", "jaxlib", "flax", "repro")
GEMM_RE = r"nvjet|gemm|cutlass|xmma"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is
    banned; ``None`` entries (blocked imports) are not loaded."""
    return sorted(k for k, v in sys.modules.items()
                  if v is not None and k.split(".")[0] in BANNED)


# --------------------------------------------------------------------- #
# the manifest and a cell's files
# --------------------------------------------------------------------- #
def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<traffic>.json
    limits: dict            # limits/<cell>.json: the numbers compared
    end_to_end: list[dict]  # the cell's end-to-end metrics
    per_layer: list[dict]   # the cell's per-layer metrics


def _reports(metric: dict, cell: str, e2e_names: set[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_names


def load_cell(name: str, man: dict | None = None) -> Cell:
    man = man or manifest()
    wl = {w["name"]: w for w in man["workloads"]}
    if name not in wl:
        raise KeyError(f"unknown workload {name!r}; known: {sorted(wl)}")
    w = wl[name]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((BENCH / "limits" / f"{name}.json").read_text())
    e2e = [m for m in man["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per = [m for m in man["per_layer"] if _reports(m, name, names)]
    return Cell(name, w, config, traffic, limits, e2e, per)


def bench_module(rel: str):
    """The module of the file ``rel`` under the benchmark's folder, loaded
    from its path (a metric's name holds dots, so it is no module name)."""
    spec = importlib.util.spec_from_file_location(
        f"hopaas_bench_{re.sub(r'[^A-Za-z0-9_]', '_', rel[:-3])}", BENCH / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str) -> Callable[[dict], float | None]:
    """``metrics/<name>.py``'s ``read(record)``."""
    return bench_module(f"metrics/{name}.py").read


def driver(kind: str):
    """``drivers/<kind>.py``: the one generator of a kind of traffic."""
    return importlib.import_module(f"hopaas_bench.drivers.{kind}")


# --------------------------------------------------------------------- #
# the model configuration
# --------------------------------------------------------------------- #
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the configuration file's keys that are fields of the port's ModelConfig
SIZE_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
             "d_ff", "vocab_size", "rope_theta", "norm_eps",
             "shared_attn_period")


def config_groups(conf: dict, cfg) -> list[str]:
    """The configuration file's groups: its keys that name a field of the
    port's configuration ``cfg`` whose value is a dataclass (``moe``,
    ``ssm``, ``rwkv``, or a group of a ``ModelConfig`` subclass: the
    fields are read from the instance).  Raises where the file gives a
    group (a dict) for a field that the port's arch leaves unset."""
    out = []
    for f in dataclasses.fields(cfg):
        if f.name not in conf:
            continue
        if dataclasses.is_dataclass(getattr(cfg, f.name)):
            out.append(f.name)
        elif isinstance(conf[f.name], dict):
            raise ValueError(f"{conf['name']}: group {f.name!r} in the "
                             f"file, none in the port's {conf['arch']!r}")
    return out


def model_config(conf: dict, mode: str):
    """The port's configuration as the file states it: the registry's
    ``conf["arch"]`` with the file's sizes (``SIZE_KEYS``, and each of its
    groups, ``config_groups``, as the file gives its keys) and the
    ``mode`` ("train" or "serve") implementation settings; raises where
    the file's block is not the port's.  A configuration whose port
    config carries a group of its own (a ``ModelConfig`` subclass with
    another dataclass field, registered under its arch) joins by its
    file alone: that group's keys reach the port as the file states
    them."""
    from repro_torch.models.registry import get_config

    cfg = get_config(conf["arch"], smoke=conf.get("smoke", False))
    if conf["block"] != cfg.block:
        raise ValueError(f"{conf['name']}: block {conf['block']!r} in the "
                         f"file, {cfg.block!r} in the port")
    sizes = {k: conf[k] for k in SIZE_KEYS if k in conf}
    sizes.update({g: dataclasses.replace(getattr(cfg, g), **conf[g])
                  for g in config_groups(conf, cfg)})
    impl = dict(conf[mode])
    for k in ("dtype", "param_dtype"):
        if k in impl:
            impl[k] = DTYPES[impl[k]]
    return cfg.replace(dtype=DTYPES[conf["dtype"]],
                       remat=conf.get("remat", True), **sizes, **impl)


# --------------------------------------------------------------------- #
# the benchmark's weights
# --------------------------------------------------------------------- #
def make_params(mcfg, seed: int, device, init: dict) -> dict:
    """A parameter tree in the port's layout (``transformer.init``'s leaf
    calls name each leaf's shape and its zeros, ones or normal draw) with
    the benchmark's values, every leaf drawn from one ``torch.randn`` on
    ``device`` seeded with ``seed``, in ``mcfg.param_dtype``: a normal
    leaf scaled by the scale the layout names or else by
    ``init["initializer_range"]`` (the published one), a leaf of ones
    (a norm's gain) 1 + ``init["ones"]`` x N(0, 1), a leaf of zeros
    ``init["zeros"]`` x N(0, 1), so that no leaf is the same number
    everywhere.  The same seed gives the same tree."""
    from repro_torch.models import transformer

    plan: list[tuple] = []

    def record(shape, dtype, axes=None, scale=None, init="normal"):
        plan.append((tuple(shape), dtype, init, scale))
        return torch.empty(shape, device="meta")

    transformer.init(mcfg, mk=record)
    total = sum(math.prod(p[0]) for p in plan)
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    buf = torch.randn(total, generator=gen, device=device,
                      dtype=mcfg.param_dtype)
    made, off = [], 0
    for shape, dt, kind, scale in plan:
        n = math.prod(shape)
        leaf = buf[off: off + n].view(shape)
        off += n
        if kind == "ones":
            leaf.mul_(init["ones"]).add_(1.0)
        elif kind == "zeros":
            leaf.mul_(init["zeros"])
        else:
            leaf.mul_(init["initializer_range"] if scale is None
                      else scale)
        made.append(leaf.to(dt))
    it = iter(made)
    return transformer.init(mcfg, mk=lambda *a, **k: next(it))


# --------------------------------------------------------------------- #
# host spans
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class Span:
    name: str
    start: int
    end: int
    depth: int
    attrs: dict


class Spans:
    """Host spans on ``time.time_ns()``, kept in memory."""

    def __init__(self):
        self.done: list[Span] = []
        self._depth = 0

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        start = time.time_ns()
        self._depth += 1
        try:
            yield attrs
        finally:
            self._depth -= 1
            self.done.append(Span(name, start, time.time_ns(), self._depth,
                                  attrs))

    def named(self, name: str) -> list[Span]:
        return sorted((s for s in self.done if s.name == name),
                      key=lambda s: s.start)

    def open_at(self, t: int) -> str:
        """The innermost span open at ``t``; "none" where none is."""
        best = None
        for s in self.done:
            if s.start <= t < s.end and (best is None or s.depth > best.depth):
                best = s
        return best.name if best else "none"


def containing(spans: list[Span], t: int) -> Span | None:
    """The span of ``spans`` (sorted, not overlapping) holding ``t``."""
    i = bisect.bisect_right([s.start for s in spans], t) - 1
    return spans[i] if i >= 0 and t < spans[i].end else None


# --------------------------------------------------------------------- #
# the device trace
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class Kernel:
    name: str
    start: int      # device start, host clock
    end: int
    launch: int     # host time of its launch call (its start if unknown)


class Tracer:
    """``torch.profiler`` over the measured window, device activity only
    (recording every host-side op would slow the host several-fold and
    make the idle share the profiler's).  A marker kernel launched at the
    start ties the profiler's clock to ``time.time_ns()``."""

    MARKER = "spin_kernel"

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda._sleep(1)                # load the marker's module
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.time_ns()
        torch.cuda._sleep(1)
        self.t1 = time.time_ns()
        torch.cuda.synchronize()

    def stop(self) -> list[Kernel]:
        from torch.autograd import DeviceType
        self.prof.__exit__(None, None, None)
        launch, kernels, marker = {}, [], None
        for e in self.prof.profiler.kineto_results.events():
            corr = e.correlation_id()
            if e.device_type() == DeviceType.CUDA:
                kernels.append((e.name(), e.start_ns(),
                                e.start_ns() + e.duration_ns(), corr))
                if self.MARKER in e.name() and marker is None:
                    marker = corr
            elif corr > 0:
                t = e.start_ns()
                if corr not in launch or t < launch[corr]:
                    launch[corr] = t
        self.prof = None
        offset = 0
        if marker is not None and marker in launch:
            offset = launch[marker] - (self.t0 + self.t1) // 2
        self.offset_ns = offset
        out = [Kernel(n, s - offset, e - offset,
                      launch.get(c, s) - offset)
               for n, s, e, c in kernels if self.MARKER not in n]
        out.sort(key=lambda k: k.start)
        return out


def busy_intervals(kernels: list[Kernel], t0: int, t1: int
                   ) -> list[tuple[int, int]]:
    """The union of the kernels' device intervals inside [t0, t1]."""
    merged: list[list[int]] = []
    for k in kernels:
        s, e = max(k.start, t0), min(k.end, t1)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def idle_gaps(busy: list[tuple[int, int]], t0: int, t1: int
              ) -> list[tuple[int, int]]:
    gaps, at = [], t0
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if t1 > at:
        gaps.append((at, t1))
    return gaps


def device_kind(name: str) -> str:
    k = name.lower()
    return ("gemm" if re.search(GEMM_RE, k) else
            "softmax" if "softmax" in k else
            "reduce" if "reduce" in k else
            "index" if re.search(r"index|scatter|gather", k) else
            "cast/copy" if re.search(r"memcpy|memset|copy", k) else
            "elementwise" if "elementwise" in k else "other")


def breakdown(kernels: list[Kernel], spans: Spans, t0: int, t1: int
              ) -> tuple[dict, float]:
    """-> ({"device_ops", "idle_gaps"}, busy seconds) over [t0, t1]: the
    ten device operations that took most time by name, and the ten
    longest idle gaps named by the innermost host span open when each
    began.  Logs the split of device time by kind."""
    by_name: dict[str, float] = {}
    kinds: dict[str, list] = {}
    for k in kernels:
        if k.end <= t0 or k.start >= t1:
            continue
        d = (min(k.end, t1) - max(k.start, t0)) / 1e9
        by_name[k.name] = by_name.get(k.name, 0.0) + d
        acc = kinds.setdefault(device_kind(k.name), [0, 0.0])
        acc[0] += 1
        acc[1] += d
    busy = busy_intervals(kernels, t0, t1)
    busy_s = sum(e - s for s, e in busy) / 1e9
    gaps = sorted(idle_gaps(busy, t0, t1), key=lambda g: g[0] - g[1])[:10]
    log("device time by kind: " + "; ".join(
        f"{kind} x{n} {s:.6f} s" for kind, (n, s) in
        sorted(kinds.items(), key=lambda kv: -kv[1][1])))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[spans.open_at(s), (e - s) / 1e9]
                          for s, e in gaps]}, busy_s


def launch_counts(conf: dict) -> dict[str, int]:
    """The port's launches so far of each kernel the configuration file
    names (``kernels``: name -> "module:function", whose ``launches``
    attribute counts them)."""
    out = {}
    for name, where in conf.get("kernels", {}).items():
        module, _, attr = where.partition(":")
        out[name] = getattr(importlib.import_module(module), attr).launches
    return out


# --------------------------------------------------------------------- #
# the result
# --------------------------------------------------------------------- #
def device_info(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


class Run:
    """One run of a cell: its arguments, its spans, and the window.  A
    driver calls ``open_window`` when the measured window opens,
    ``close_window`` when it closes and ``after_window`` once the
    window's work has finished, before it frees any state."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, t_start: int, faults: frozenset = frozenset()):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.device, self.t_start = trace, device, t_start
        self.faults = faults          # planted faults (tests only)
        self.spans = Spans()
        self.tracer: Tracer | None = None
        self.kernels: list[Kernel] = []
        self.t_open = self.t_close = None
        self.device_info: dict | None = None

    def open_window(self) -> None:
        if self.trace and self.device.type == "cuda":
            self.tracer = Tracer()
        self.t_open = time.time_ns()

    def close_window(self) -> None:
        self.t_close = time.time_ns()

    def after_window(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        if self.tracer is not None:
            self.kernels = self.tracer.stop()
            log(f"trace: {len(self.kernels)} device events kept, clock "
                f"offset {self.tracer.offset_ns} ns")
            self.tracer = None
        self.device_info = device_info(self.device)

    def model_config(self, mode: str):
        return model_config(self.cell.config, mode)

    @property
    def window_s(self) -> float:
        return (self.t_close - self.t_open) / 1e9


@dataclasses.dataclass
class Outcome:
    e2e: dict           # end-to-end readings by metric name
    record: dict        # what the metric readers read
    numbers: dict       # the numbers compared, by name
    attempted: int
    failed: int


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, breakdown_: dict | None, checks: dict) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown_ is not None:
        out["breakdown"] = breakdown_
    out["checks"] = checks
    return json.dumps(out)
