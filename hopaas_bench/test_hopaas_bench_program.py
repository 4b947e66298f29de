"""The readers of the port's own spans (``program.py`` and the metrics
whose source is ``program_span``): known values on a planted record of
kernels, idle gaps and spans; None, and no error, where the port has no
recorder, recorded nothing, or recorded only outside the window; and a
tiny CPU run of the campaign under a profiler."""
import sys
import types

import pytest
from torch.profiler import ProfilerActivity, profile

import repro_torch
from hopaas_bench import harness, program
from hopaas_bench.testing import tiny_run
from repro_torch import spans as port_spans

MS = 1_000_000
T0 = 10**15
NEW = {m["name"]: m for m in harness.manifest()["per_layer"]
       if m["source"] == "program_span"}
WANT = {"cast_ms.train": 2.0, "forward_ms.train": 10.0,
        "backward_ms.train": 15.0, "loop_idle_ms.train": 14.0,
        "sampler_ms.train": 4.0, "launch_idle_ms.prefill": 11.0,
        "attention_ms.prefill": 10.0, "mlp_ms.prefill": 12.0,
        "head_ms.prefill": 4.0}


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
    spans, kernels, extra = planted
    run = types.SimpleNamespace(t_open=T0 + shift * MS,
                                t_close=T0 + (shift + 100) * MS,
                                kernels=kernels, spans=harness.Spans())
    return spans, {"run": run, **extra}


def planted_for(name):
    return train_record() if name.endswith(".train") else prefill_record()


def test_every_program_span_metric_has_a_planted_value():
    assert set(NEW) == set(WANT)
    for name, m in NEW.items():
        assert m["workloads"] == ["deepseek-7b.hpo_train" if name.endswith(
            ".train") else "deepseek-7b.prefill_mix"]


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_its_planted_value(name, monkeypatch):
    spans, rec = record(planted_for(name))
    monkeypatch.setattr(port_spans, "recorded", lambda: list(spans))
    assert harness.metric_reader(name)(rec) == pytest.approx(WANT[name])


@pytest.mark.parametrize("case", ["no_recorder", "nothing", "outside"])
@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_gives_none_without_spans_in_the_window(name, case,
                                                      monkeypatch):
    spans, rec = record(planted_for(name), shift=200 if case == "outside"
                        else 0)
    if case == "no_recorder":       # a port without repro_torch.spans
        monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
        monkeypatch.delattr(repro_torch, "spans")
    else:
        monkeypatch.setattr(port_spans, "recorded", lambda: (
            [] if case == "nothing" else list(spans)))
    assert harness.metric_reader(name)(rec) is None


@pytest.mark.parametrize("planted,lines", [
    (train_record, ["step.* launched 62.000 ms, 96.88%",
                    "idle 36.000 ms (36.0000% of the window; the trace's idle share 36.0000%)",
                    "trainer.report 10.000 ms"]),
    (prefill_record, ["model.* launched 52.000 ms, 96.30% of the 54.000 ms",
                      "idle 46.000 ms (46.0000% of the window; the trace's idle share 46.0000%)",
                      "none 24.000 ms"]),
])
def test_log_split_splits_device_and_idle_time(planted, lines, monkeypatch,
                                               capsys):
    spans, rec = record(planted())
    monkeypatch.setattr(port_spans, "recorded", lambda: list(spans))
    program.log_split(rec)
    program.log_split(rec)
    err = capsys.readouterr().err
    assert err.count("program: device time launched") == 1
    for line in lines:
        assert line in err, err


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


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_puts_the_trace_on_the_spans_clock(name, monkeypatch):
    spans, kernels, extra, bench = late_trace(planted_for(name))
    _, rec = record((spans, kernels, extra))
    rec["run"].spans = bench
    monkeypatch.setattr(port_spans, "recorded", lambda: list(spans))
    assert harness.metric_reader(name)(rec) == pytest.approx(WANT[name],
                                                             abs=0.05)
    # train: the copy's launch bounds it 10 us early; prefill: the next
    # request's first launch (1 ms into its prefill) is no tight bound, so
    # the copies' ends give it, 20 us late
    assert program.clock_shift(rec) == (-int(1.31 * MS) if name.endswith(
        ".train") else -int(1.28 * MS))


@pytest.mark.parametrize("planted", [train_record, prefill_record])
def test_log_split_idle_sums_to_the_trace_idle(planted, monkeypatch, capsys):
    from hopaas_bench.readers import idle_percent
    spans, kernels, extra, bench = late_trace(planted())
    _, rec = record((spans, kernels, extra))
    rec["run"].spans = bench
    monkeypatch.setattr(port_spans, "recorded", lambda: list(spans))
    program.log_split(rec)
    err = capsys.readouterr().err
    idle = float(err.split("program: idle ")[1].split(" ms")[0])
    assert idle == pytest.approx(idle_percent(rec), rel=0.01)


def test_cpu_campaign_under_a_profiler_reads_its_sampler():
    """The program's spans over a tiny campaign on the CPU: the sampler's
    mean reads positive; the device-time readers find no kernels and
    give None; hiding the recorder leaves every other metric as it read
    and gives None for the new ones."""
    run = tiny_run("deepseek-7b.hpo_train", 2**31 + 91, 0.5)
    run.cell.traffic.update(steps_per_trial=2)
    port_spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = harness.driver("hpo_train").run(run)
    read = {m["name"]: harness.metric_reader(m["name"])(out.record)
            for m in run.cell.per_layer}
    assert read["sampler_ms.train"] > 0
    assert all(read[n] is None for n in NEW if n != "sampler_ms.train"
               and n in read)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "repro_torch.spans", None)
        mp.delattr(repro_torch, "spans")
        out.record.pop("program_split_logged", None)
        hidden = {m["name"]: harness.metric_reader(m["name"])(out.record)
                  for m in run.cell.per_layer}
    for name, value in hidden.items():
        assert value is None if name in NEW else value == read[name], name
    port_spans.clear()
