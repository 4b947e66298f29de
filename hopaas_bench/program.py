"""The port's own spans (``repro_torch.spans``) over a run's measured
window, read against the device trace: the device time of the kernels
launched inside named spans, the idle time under them, and a log of both
split by span.

The port records its spans only while a profiler runs, as a traced
run's ``harness.Tracer`` does.  An untraced run, or a port without
``repro_torch.spans``, gives None here, and so does every reader built
on these.  Spans are matched to kernels by the host clock alone, across
threads: autograd's device thread launches the backward while the
caller waits inside ``step.backward``.

The trace's times are put on the spans' clock first (``clock_shift``):
the harness ties the two clocks through its marker kernel, the
profiler's first launch, and that launch is slow enough (~3 ms on the
H100's host) to leave the tie ~1 ms off, more than many spans last.
"""
from __future__ import annotations

import bisect
from collections import Counter

from .harness import busy_intervals, idle_gaps, log
from .readers import idle_percent, in_window

STEP = frozenset({"step.cast", "step.forward", "step.backward",
                  "step.optimizer"})
MODEL = frozenset({"model.attention", "model.mlp", "model.head"})
# spans that end as soon as a copy to the host returns: the port's loss
# sync, and the prefill cell's own request span (its first tokens' ``tolist``)
SYNCS = ("trainer.sync",)
BENCH_SYNCS = ("request",)
PRIOR_NS = 10_000_000       # the tie is off by less than this
BIN_NS = 50_000
TIGHT_NS = 200_000


def program_spans(rec: dict, names=None) -> list | None:
    """The port's recorded spans (of ``names``, if given) that lie wholly
    inside the window; None where there are none, or no recorder."""
    try:
        from repro_torch import spans
    except ImportError:
        return None
    run = rec["run"]
    got = [s for s in spans.recorded()
           if run.t_open <= s.start and s.end <= run.t_close
           and (names is None or s.name in names)]
    return got or None


def clock_shift(rec: dict) -> int:
    """Ns to add to the trace's times to put them on the spans' clock.

    Each device-to-host copy C that a sync span S (``SYNCS``,
    ``BENCH_SYNCS``) waits on bounds the shift: C ends before the host
    leaves S (an upper bound, S.end - C.end), and C is launched after S
    starts; the next kernel launched after C is launched after the first
    program span that starts once S has ended (lower bounds).  The copies
    are matched to their spans as the densest cluster of S.end - C.end
    within ``PRIOR_NS``.  The shift is the tightest lower bound where it
    lies within ``TIGHT_NS`` of the tightest upper one (launches then
    read at most a launch's latency early), else the upper bound (late
    by the host's return from the copy); 0 where fewer than two copies
    match."""
    if "program_clock_shift" in rec:
        return rec["program_clock_shift"]
    run = rec["run"]
    spans = program_spans(rec) or []
    syncs = ([s for s in spans if s.name in SYNCS]
             + [s for n in BENCH_SYNCS for s in in_window(rec, n)])
    copies = sorted((k for k in run.kernels if "DtoH" in k.name),
                    key=lambda k: k.end)
    ends = [k.end for k in copies]
    pairs = [(s, c) for s in syncs for c in copies[
        bisect.bisect_left(ends, s.end - PRIOR_NS):
        bisect.bisect_right(ends, s.end + PRIOR_NS)]]
    bins = Counter((s.end - c.end) // BIN_NS for s, c in pairs)
    shift = 0
    if bins:
        top = max(bins, key=lambda b: bins[b] + bins[b + 1])
        matched = [(s, c) for s, c in pairs
                   if top * BIN_NS <= s.end - c.end < (top + 2) * BIN_NS]
        if len(matched) >= 2:
            upper = min(s.end - c.end for s, c in matched)
            by_launch = sorted(run.kernels, key=lambda k: k.launch)
            launches = [k.launch for k in by_launch]
            starts = sorted(x.start for x in spans)
            lows = [s.start - c.launch for s, c in matched]
            for s, c in matched:
                i = bisect.bisect_right(launches, c.launch)
                j = bisect.bisect_left(starts, s.end)
                if i < len(launches) and j < len(starts):
                    lows.append(starts[j] - launches[i])
            lower = max(lows)
            shift = lower if 0 <= upper - lower <= TIGHT_NS else upper
            log(f"program: the trace's clock shifted {shift} ns onto the "
                f"spans' (bounds {lower}, {upper} from {len(matched)} "
                f"copies to the host)")
    rec["program_clock_shift"] = shift
    return shift


def _union(spans) -> list[list[int]]:
    """The union of the spans' [start, end) intervals, sorted."""
    merged: list[list[int]] = []
    for s, e in sorted((x.start, x.end) for x in spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _launched_ns(kernels, spans, shift: int = 0) -> int:
    """Device ns of the kernels whose launch (+ ``shift``) lies inside any
    of ``spans`` (anything with ``start`` and ``end`` on the host
    clock)."""
    cover = _union(spans)
    starts = [s for s, _ in cover]
    total = 0
    for k in kernels:
        t = k.launch + shift
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < cover[i][1]:
            total += k.end - k.start
    return total


def _overlap_ns(a: list, b: list) -> int:
    """Length of the overlap of two sorted lists of disjoint intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _gaps(run, shift: int) -> list[tuple[int, int]]:
    """The window's device idle gaps on the spans' clock."""
    t0, t1 = run.t_open - shift, run.t_close - shift
    return [(a + shift, b + shift) for a, b in
            idle_gaps(busy_intervals(run.kernels, t0, t1), t0, t1)]


def launched_ms(rec: dict, names) -> float | None:
    """Device ms of the kernels launched inside the window's spans of
    ``names``."""
    spans, kernels = program_spans(rec, names), rec["run"].kernels
    if spans is None or not kernels:
        return None
    return _launched_ns(kernels, spans, clock_shift(rec)) / 1e6


def idle_ms(rec: dict, names) -> float | None:
    """Ms of the window's device idle time (``harness.idle_gaps``) under
    the window's spans of ``names``."""
    spans, run = program_spans(rec, names), rec["run"]
    if spans is None or not run.kernels:
        return None
    return _overlap_ns(_gaps(run, clock_shift(rec)), _union(spans)) / 1e6


def per(value: float | None, items: list) -> float | None:
    """``value`` over the number of ``items`` (the window's steps or
    requests)."""
    return None if value is None or not items else value / len(items)


def _innermost(spans) -> tuple[list[int], list[str]]:
    """Where the innermost open span changes, as (times, names): the
    span that began last among those open, on any thread; "none" where
    none is open."""
    events = sorted([(s.end, 0, i) for i, s in enumerate(spans)]
                    + [(s.start, 1, i) for i, s in enumerate(spans)])
    open_: set[int] = set()
    times: list[int] = []
    names: list[str] = []
    for n, (t, kind, i) in enumerate(events):
        (open_.add if kind else open_.discard)(i)
        if n + 1 < len(events) and events[n + 1][0] == t:
            continue
        top = max(open_, key=lambda j: (spans[j].start, spans[j].id),
                  default=None)
        name = "none" if top is None else spans[top].name
        if not names or names[-1] != name:
            times.append(t)
            names.append(name)
    return times, names


def _name_at(times: list[int], names: list[str], t: int) -> str:
    i = bisect.bisect_right(times, t) - 1
    return names[i] if i >= 0 else "none"


def _split_interval(times, names, a: int, b: int, into: dict) -> None:
    """Adds [a, b) to ``into`` by the innermost span open over it."""
    i = bisect.bisect_right(times, a) - 1
    at = a
    while at < b:
        end = min(b, times[i + 1] if i + 1 < len(times) else b)
        name = names[i] if i >= 0 else "none"
        into[name] = into.get(name, 0) + end - at
        at, i = end, i + 1


def _fmt(split: dict, total: int) -> str:
    return "; ".join(f"{k} {v / 1e6:.3f} ms ({100 * v / total:.2f}%)"
                     for k, v in sorted(split.items(), key=lambda kv: -kv[1]))


def log_split(rec: dict) -> None:
    """Logs once a run, to standard error: the clock shift, the window's
    device time by the innermost program span open at each launch, the
    share of it the train step's or the prefill's model spans launched,
    the window's idle time by the innermost program span open over it,
    and the program's spans against the benchmark's own (``adamw``,
    ``ask`` and ``tell``, ``init_state``)."""
    if rec.get("program_split_logged"):
        return
    rec["program_split_logged"] = True
    spans, run = program_spans(rec), rec["run"]
    if spans is None or not run.kernels:
        return
    shift = clock_shift(rec)
    kernels = [k for k in run.kernels
               if run.t_open <= k.launch + shift <= run.t_close]
    device = sum(k.end - k.start for k in kernels)
    unknown = sum(k.launch == k.start for k in kernels)
    log(f"program: {unknown} of {len(kernels)} kernels launched in the "
        f"window with no launch record")
    times, names = _innermost(spans)
    by_launch: dict[str, int] = {}
    for k in kernels:
        name = _name_at(times, names, k.launch + shift)
        by_launch[name] = by_launch.get(name, 0) + k.end - k.start
    log(f"program: device time launched in the window {device / 1e6:.3f} ms, "
        f"by innermost span at launch: {_fmt(by_launch, device or 1)}")
    if {s.name for s in spans} & STEP and device:
        got = _launched_ns(kernels, [s for s in spans if s.name in STEP],
                           shift)
        log(f"program: step.* launched {got / 1e6:.3f} ms, "
            f"{100 * got / device:.2f}% of the window's device time")
    whole = _launched_ns(kernels, [s for s in spans
                                   if s.name == "serve.prefill"], shift)
    if whole:
        got = _launched_ns(kernels, [s for s in spans if s.name in MODEL],
                           shift)
        log(f"program: model.* launched {got / 1e6:.3f} ms, "
            f"{100 * got / whole:.2f}% of the {whole / 1e6:.3f} ms launched "
            f"inside serve.prefill")
    idle: dict[str, int] = {}
    for a, b in _gaps(run, shift):
        _split_interval(times, names, a, b, idle)
    total = sum(idle.values())
    window = run.t_close - run.t_open
    log(f"program: idle {total / 1e6:.3f} ms ({100 * total / window:.4f}% of "
        f"the window; the trace's idle share {idle_percent(rec):.4f}%), by "
        f"innermost span open: {_fmt(idle, total or 1)}")
    _compare(rec, spans, kernels, shift)


def _compare(rec: dict, spans: list, kernels: list, shift: int) -> None:
    def named(*names):
        return [s for s in spans if s.name in names]

    def host_ms(group):
        return sum(s.end - s.start for s in group) / 1e6

    def device_ms(group, by=shift):
        return _launched_ns(kernels, group, by) / 1e6 / len(group)

    opt, adamw = named("step.optimizer"), in_window(rec, "adamw")
    if opt and adamw:
        log(f"program: step.optimizer {device_ms(opt):.3f} device ms a span "
            f"({len(opt)}); the benchmark's adamw {device_ms(adamw):.3f} "
            f"({len(adamw)}), {device_ms(adamw, 0):.3f} on the trace's "
            f"clock unshifted, as optim_ms.train reads it")
    client = named("client.ask", "client.tell")
    outer = in_window(rec, "ask") + in_window(rec, "tell")
    if client and outer:
        log(f"program: client.ask + client.tell {host_ms(client):.3f} host ms "
            f"({len(client)}), the benchmark's ask + tell "
            f"{host_ms(outer):.3f} ({len(outer)})")
    init, outer = named("trainer.init"), in_window(rec, "init_state")
    if init and outer:
        log(f"program: trainer.init {host_ms(init):.3f} host ms ({len(init)}), "
            f"the benchmark's init_state {host_ms(outer):.3f} ({len(outer)})")
