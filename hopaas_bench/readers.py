"""What the per-layer metric readers (``metrics/<name>.py``) share: the
measured window's spans and device events, and kernel roofline shares."""
from __future__ import annotations

from typing import Callable

from .harness import busy_intervals, containing, log
from .work.bounds import PEAKS


def in_window(rec: dict, name: str) -> list:
    run = rec["run"]
    return [s for s in run.spans.named(name)
            if run.t_open <= s.start and s.end <= run.t_close]


def idle_percent(rec: dict) -> float | None:
    """100 x (1 - the union of device events over the window)."""
    run = rec["run"]
    if not run.kernels:
        return None
    busy = busy_intervals(run.kernels, run.t_open, run.t_close)
    return 100.0 * (1.0 - sum(e - s for s, e in busy)
                    / (run.t_close - run.t_open))


def mfu_percent(rec: dict, flops: float) -> float:
    return 100.0 * flops / (rec["run"].window_s * PEAKS["bf16_flops_per_s"])


def roofline_percent(rec: dict, kernel: str, symbol: str,
                     least_ms: Callable[[int, int], float]) -> float | None:
    """Each kept launch of ``symbol`` inside a request: its least time at
    its request's shape (``least_ms(batch, length)``) over its device
    time, summed over the launches the profiler kept; None where it kept
    none.  Logs how many it kept against the port's launch counter."""
    run = rec["run"]
    requests = in_window(rec, "request")
    bound = device = 0.0
    kept = 0
    for k in run.kernels:
        if symbol not in k.name:
            continue
        req = containing(requests, k.launch)
        if req is None:
            continue
        kept += 1
        bound += least_ms(rec["batch"], req.attrs["length"])
        device += (k.end - k.start) / 1e6
    log(f"{kernel}: the profiler kept {kept} of {rec['launches'][kernel]} "
        f"launches in the window (the port's launch counter)")
    return 100.0 * bound / device if kept else None
