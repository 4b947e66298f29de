"""The control: the reference computed in fp8 in the program's place.
On the card, at each cell's own size, it has to come out not correct on
three seeds; on the CPU, at the smoke size, its readings have to stand
apart from the program's."""
import time

import pytest
import torch

from hopaas_bench import control, harness
from hopaas_bench.reference.compare import judge
from hopaas_bench.testing import tiny_run

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


def _readings(run) -> dict:
    if run.cell.traffic["kind"] == "hpo_train":
        return control.train_readings(run, True)
    return control.prefill_readings(run, True, 40)


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_apart_from_the_program(name):
    out = _readings(tiny_run(name, 2**31 + 3))
    assert any(out["control"][k] > 3 * out["program"][k] + 1e-4
               for k in out["program"])
    faults = {k: v for k, v in out.items() if k not in ("program",
                                                        "control")}
    for numbers in faults.values():
        assert any(numbers[k] > 3 * out["program"][k] + 1e-4
                   for k in out["program"])


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_at_the_cells_size(name, cuda):
    cell = harness.load_cell(name)
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        run = harness.Run(cell, seed, 0.0, False, cuda, time.time_ns())
        out = _readings(run)
        limits = {k: v for k, v in cell.limits["numbers"].items()
                  if k in out["control"]}
        assert judge(out["program"], limits)[0], out
        assert not judge(out["control"], limits)[0], out
        torch.cuda.empty_cache()
