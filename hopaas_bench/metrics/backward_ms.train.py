"""The train step's backward, each layer's recomputation included: device
time of the kernels launched inside the port's ``step.backward`` spans,
from any thread, a window step (ms)."""
from hopaas_bench.program import launched_ms, log_split, per

PLANTED = ("train", 15.0)  # the tests: record (planted.py), reading


def read(rec: dict) -> float | None:
    log_split(rec)
    return per(launched_ms(rec, {"step.backward"}), rec["steps"])
