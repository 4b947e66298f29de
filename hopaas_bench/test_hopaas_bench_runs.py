"""Each cell's driver, end to end on the CPU at the smoke sizes: a sound
run is judged correct, and a run with a fault planted under the timed
path is not."""
import pytest

from hopaas_bench import harness
from hopaas_bench.reference.compare import judge
from hopaas_bench.testing import tiny_run

CELLS = [w["name"] for w in harness.manifest()["workloads"]]
FAULTS = {"hpo_train": ("frozen_state", "half_batch", "altered_token",
                       "nan_update"),
          "prefill": ("half_batch", "altered_token")}
SEED = 2**31 + 77


def _judge(name, faults=frozenset(), **traffic):
    run = tiny_run(name, SEED, 0.5, frozenset(faults))
    run.cell.traffic.update(traffic)
    out = harness.driver(run.cell.traffic["kind"]).run(run)
    ok, checks = judge(out.numbers, run.cell.limits["numbers"])
    return ok, checks, out, run


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    ok, checks, out, run = _judge(name)
    assert ok, checks
    assert out.attempted > 0 and out.failed == 0
    assert all(v > 0 for v in out.e2e.values())
    assert run.t_open < run.t_close


@pytest.mark.parametrize("name,fault", [
    (c, f) for c in CELLS
    for f in FAULTS[harness.load_cell(c).traffic["kind"]]])
def test_planted_fault_is_not_correct(name, fault):
    ok, checks, _, _ = _judge(name, {fault})
    assert not ok, checks


@pytest.mark.parametrize("name", CELLS)
def test_per_layer_readers_read_a_cpu_run(name):
    """The readers of the host-clock metrics read a positive number; the
    device-trace ones find nothing to read without a card and return
    None, never 0.  A training cell's first trial ends where the window
    opens, so the window always holds an ask, however slow the host."""
    kind = harness.load_cell(name).traffic
    steps = ({"steps_per_trial": 2} if kind["kind"] == "hpo_train" else {})
    _, _, out, run = _judge(name, **steps)
    for m in run.cell.per_layer:
        value = harness.metric_reader(m["name"])(out.record)
        if m["source"] == "host_clock":
            assert value is not None and value > 0, m["name"]
        else:
            assert value is None, m["name"]
