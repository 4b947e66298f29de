"""The train step's cast of the fp32 matrices to bf16: device time of the
kernels launched inside the port's ``step.cast`` spans, a window step
(ms)."""
from hopaas_bench.program import launched_ms, log_split, per

PLANTED = ("train", 2.0)  # the tests: record (planted.py), reading


def read(rec: dict) -> float | None:
    log_split(rec)
    return per(launched_ms(rec, {"step.cast"}), rec["steps"])
