"""Planted records for the tests of the readers of the port's own spans
(the metrics whose ``source`` is ``program_span``): spans, kernels and
idle gaps laid out in ms from the window's opening, whose readings are
known.

Each such reader declares beside its ``read`` which record it reads
and the value it reads there: ``PLANTED = ("train", 10.0)`` names
``train_record`` here.  A record another cell's metrics need comes as a
module of its own, ``planted_<kind>.py`` beside this one, whose
``<kind>_record`` is marked with ``stands_for`` like the two here.  The
tests take the metrics from the manifest and name none of them.
"""
from __future__ import annotations

import types

from repro_torch import spans as port_spans

from . import harness

MS = 1_000_000
T0 = 10**15


def stands_for(traffic: str, clock_shift_ns: int):
    """Marks a record: the traffic kind (``traffic/<mix>.json``'s
    ``kind``) of every cell whose metrics read it, and the shift
    ``program.clock_shift`` reads on it once ``late_trace`` has moved its
    trace."""
    def mark(make):
        make.traffic, make.clock_shift_ns = traffic, clock_shift_ns
        return make
    return mark


def find(kind: str):
    """The record named ``kind``: this module's ``<kind>_record``, or that
    of ``planted_<kind>.py`` in the benchmark's folder."""
    make = globals().get(f"{kind}_record")
    if make is None:
        make = getattr(harness.bench_module(f"planted_{kind}.py"),
                       f"{kind}_record")
    return make


def of_metric(name: str):
    """-> (the record the reader of metric ``name`` plants, the value it
    reads there): its module's ``PLANTED``."""
    kind, value = harness.bench_module(f"metrics/{name}.py").PLANTED
    return find(kind), value


def kernel(launch, start, end):
    return harness.Kernel("k", T0 + start * MS, T0 + end * MS,
                          T0 + launch * MS)


class Planter:
    """Spans given in ms from the window's opening, numbered as the
    recorder numbers them."""

    def __init__(self):
        self.spans, self.ids = [], 0

    def add(self, name, start, end, thread=1, **attrs):
        self.ids += 1
        self.spans.append(port_spans.Span(name, self.ids, None, self.ids,
                                          thread, T0 + start * MS,
                                          T0 + end * MS, attrs))


# the copy's launch, 10 us into a trainer.sync, gives the shift, 10 us early
@stands_for("hpo_train", clock_shift_ns=-1_310_000)
def train_record():
    """Two steps of 50 ms.  Per step: batch [0, 5] (a 1-ms copy at 1),
    cast [5, 10] (2 ms at 6), forward [10, 20] (10 ms at 11), backward
    [20, 35] on another thread (15 ms at 21), optimizer [35, 40] (4 ms
    at 36), sync [40, 45], report [45, 50].  Idle under the loop's
    spans: 1 + 3 in the first batch, 11 from the first sync to the
    second copy, 3 after it, 10 at the end.  Sampler calls on the ask
    path of 3 and 5 ms, one precompute of 10."""
    p, kernels = Planter(), []
    for o in (0, 50):
        p.add("trainer.batch", o, o + 5)
        p.add("trainer.step", o + 5, o + 40)
        p.add("step.cast", o + 5, o + 10)
        p.add("step.forward", o + 10, o + 20)
        p.add("step.backward", o + 20, o + 35)
        p.add("step.optimizer", o + 35, o + 40)
        p.add("trainer.sync", o + 40, o + 45)
        p.add("trainer.report", o + 45, o + 50)
        kernels += [kernel(o + 1, o + 1, o + 2), kernel(o + 6, o + 6, o + 8),
                    kernel(o + 11, o + 11, o + 21),
                    kernel(o + 21, o + 21, o + 36),
                    kernel(o + 36, o + 36, o + 40)]
    p.add("sampler.suggest", 20, 23, thread=2, path="ask")
    p.add("sampler.suggest", 70, 75, thread=2, path="ask")
    p.add("sampler.suggest", 80, 90, thread=3, path="precompute")
    # before the window: left out
    p.add("step.cast", -10, -5)
    kernels.insert(0, kernel(-9, -9, -6))
    return p.spans, kernels, {"steps": [{}, {}]}


# the next request's first launch (1 ms into its prefill) is no tight
# bound, so the copies' ends give the shift, 20 us late
@stands_for("prefill", clock_shift_ns=-1_280_000)
def prefill_record():
    """Two requests of 50 ms: prefill [2, 40], its embedding (1 ms at 3),
    attention [5, 15] (10 ms at 6), MLP [15, 30] (12 ms at 16), head
    [30, 38] (4 ms at 31).  Idle under the prefill: 1 + 2 + 3 + 5 a
    request."""
    p, kernels = Planter(), []
    for o in (0, 50):
        p.add("serve.prefill", o + 2, o + 40)
        p.add("model.attention", o + 5, o + 15)
        p.add("model.mlp", o + 15, o + 30)
        p.add("model.head", o + 30, o + 38)
        kernels += [kernel(o + 3, o + 3, o + 4), kernel(o + 6, o + 6, o + 16),
                    kernel(o + 16, o + 16, o + 28),
                    kernel(o + 31, o + 31, o + 35)]
    return p.spans, kernels, {"requests": [{}, {}], "batch": 4}


def record(planted, shift=0):
    """-> (the planted spans, the record a reader reads: a run whose
    window is [``shift``, ``shift`` + 100] ms)."""
    spans, kernels, extra = planted
    run = types.SimpleNamespace(t_open=T0 + shift * MS,
                                t_close=T0 + (shift + 100) * MS,
                                kernels=kernels, spans=harness.Spans())
    return spans, {"run": run, **extra}


def late_trace(planted, late_ms=1.3, host_ms=0.02):
    """The planted record as the harness's trace gives it when its tie of
    the clocks is ``late_ms`` off: every device time that much later,
    and a zero-length copy to the host ending ``host_ms`` before each
    sync span ends (the port's ``trainer.sync``, the benchmark's
    ``request``), which is what puts the trace back on the spans'
    clock."""
    spans, kernels, extra = planted
    ends = [s.end for s in spans if s.name == "trainer.sync"]
    bench = harness.Spans()
    if "requests" in extra:
        for o in (0, 50):
            bench.done.append(harness.Span("request", T0 + o * MS,
                                           T0 + (o + 50) * MS, 1, {}))
            ends.append(T0 + (o + 50) * MS)
    late = int(late_ms * MS)
    moved = [harness.Kernel(k.name, k.start + late, k.end + late,
                            k.launch + late) for k in kernels]
    for e in ends:
        t = e - int(host_ms * MS) + late
        # launched 10 us into a trainer.sync, 0.1 ms before a request ends
        at = e - 5 * MS + MS // 100 if "steps" in extra else e - MS // 10
        moved.append(harness.Kernel("Memcpy DtoH (Device -> Pageable)", t, t,
                                    at + late))
    moved.sort(key=lambda k: k.start)
    return spans, moved, extra, bench
