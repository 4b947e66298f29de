"""The readers of the port's own spans (``program.py`` and the metrics
whose source is ``program_span``): the value each reader declares
(``PLANTED``) on the record it names (``planted.py``); None, and no
error, where the port has no recorder, recorded nothing, or recorded
only outside the window; and a tiny CPU run of the campaign under a
profiler.  The cases follow the manifest: a metric a later change adds
is checked with no test edited."""
import json
import sys

import pytest
from torch.profiler import ProfilerActivity, profile

import repro_torch
from hopaas_bench import harness, planted, program
from hopaas_bench.planted import (late_trace, prefill_record, record,
                                  train_record)
from hopaas_bench.testing import bench_copy, tiny_run
from repro_torch import spans as port_spans

NEW = {m["name"]: m for m in harness.manifest()["per_layer"]
       if m["source"] == "program_span"}
CASES = ["no_recorder", "nothing", "outside"]


def lists_cells_of_its_kind(m):
    """Every cell metric ``m`` lists runs traffic of its record's kind."""
    make, _ = planted.of_metric(m["name"])
    assert m["workloads"], m["name"]
    for cell in m["workloads"]:
        assert harness.load_cell(cell).traffic["kind"] == make.traffic, (
            m["name"], cell)


def reads_its_planted_value(name, monkeypatch):
    make, want = planted.of_metric(name)
    spans, rec = record(make())
    monkeypatch.setattr(port_spans, "recorded", lambda: list(spans))
    assert harness.metric_reader(name)(rec) == pytest.approx(want)


def gives_none(name, case, monkeypatch):
    make, _ = planted.of_metric(name)
    spans, rec = record(make(), shift=200 if case == "outside" else 0)
    if case == "no_recorder":       # a port without repro_torch.spans
        monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
        monkeypatch.delattr(repro_torch, "spans")
    else:
        monkeypatch.setattr(port_spans, "recorded", lambda: (
            [] if case == "nothing" else list(spans)))
    assert harness.metric_reader(name)(rec) is None


def reads_on_the_spans_clock(name, monkeypatch):
    make, want = planted.of_metric(name)
    spans, kernels, extra, bench = late_trace(make())
    _, rec = record((spans, kernels, extra))
    rec["run"].spans = bench
    monkeypatch.setattr(port_spans, "recorded", lambda: list(spans))
    assert harness.metric_reader(name)(rec) == pytest.approx(want, abs=0.05)
    assert program.clock_shift(rec) == make.clock_shift_ns


def test_every_program_span_metric_has_a_planted_value():
    for m in NEW.values():
        lists_cells_of_its_kind(m)


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_reads_its_planted_value(name, monkeypatch):
    reads_its_planted_value(name, monkeypatch)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_gives_none_without_spans_in_the_window(name, case,
                                                      monkeypatch):
    gives_none(name, case, monkeypatch)


ROUTED_RECORD = '''"""The prefill record with a router span of 1 ms inside each request's
MLP, over the MLP's 12-ms launch."""
from hopaas_bench.planted import MS, T0, prefill_record, stands_for
from repro_torch.spans import Span


@stands_for("prefill", clock_shift_ns=-1_280_000)
def routed_record():
    spans, kernels, extra = prefill_record()
    for i, o in enumerate((0, 50), start=100):
        spans.append(Span("model.router", i, None, i, 1, T0 + (o + 16) * MS,
                          T0 + (o + 17) * MS, {}))
    return spans, kernels, extra
'''
ROUTER_READER = '''"""Device time launched inside the port's model.router spans, a request."""
from hopaas_bench.program import launched_ms, per

PLANTED = ("routed", 12.0)


def read(rec):
    return per(launched_ms(rec, {"model.router"}), rec["requests"])
'''


def test_a_new_reader_is_checked_by_its_planted_value(tmp_path, monkeypatch):
    """A metric added as a later change adds one (a reader with its
    ``PLANTED``, a record of its own, a manifest entry) is checked as the
    nine are; listed for a cell of another traffic kind, it fails."""
    bench = bench_copy(tmp_path, monkeypatch)
    (bench / "planted_routed.py").write_text(ROUTED_RECORD)
    (bench / "metrics" / "router_ms.prefill.py").write_text(ROUTER_READER)
    man = harness.manifest()
    entry = {"name": "router_ms.prefill", "unit": "ms", "better": "lower",
             "source": "program_span", "layer": "model",
             "moves": "prefill_tokens_per_s",
             "workloads": ["deepseek-7b.prefill_mix"]}
    man["per_layer"].append(entry)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    assert entry in harness.load_cell("deepseek-7b.prefill_mix").per_layer
    lists_cells_of_its_kind(entry)
    reads_its_planted_value(entry["name"], monkeypatch)
    for case in CASES:
        with pytest.MonkeyPatch.context() as mp:
            gives_none(entry["name"], case, mp)
    reads_on_the_spans_clock(entry["name"], monkeypatch)
    with pytest.raises(AssertionError):
        lists_cells_of_its_kind({**entry, "workloads": [
            "deepseek-7b.hpo_train"]})
    assert planted.of_metric(entry["name"])[0].__name__ == "routed_record"


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


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_puts_the_trace_on_the_spans_clock(name, monkeypatch):
    reads_on_the_spans_clock(name, monkeypatch)


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
