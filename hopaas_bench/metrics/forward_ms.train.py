"""The train step's forward, the loss included: device time of the kernels
launched inside the port's ``step.forward`` spans, a window step (ms)."""
from hopaas_bench.program import launched_ms, log_split, per

PLANTED = ("train", 10.0)  # the tests: record (planted.py), reading


def read(rec: dict) -> float | None:
    log_split(rec)
    return per(launched_ms(rec, {"step.forward"}), rec["steps"])
