"""The prefill's attention halves of the blocks (norm, projections, rotary,
flash, output, residual add): device time of the kernels launched inside
the port's ``model.attention`` spans, a window request (ms)."""
from hopaas_bench.program import launched_ms, log_split, per

PLANTED = ("prefill", 10.0)  # the tests: record (planted.py), reading


def read(rec: dict) -> float | None:
    log_split(rec)
    return per(launched_ms(rec, {"model.attention"}), rec["requests"])
