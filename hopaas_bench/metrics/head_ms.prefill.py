"""The prefill's LM head (final norm and head product, at every position):
device time of the kernels launched inside the port's ``model.head``
spans, a window request (ms)."""
from hopaas_bench.program import launched_ms, log_split, per

PLANTED = ("prefill", 4.0)  # the tests: record (planted.py), reading


def read(rec: dict) -> float | None:
    log_split(rec)
    return per(launched_ms(rec, {"model.head"}), rec["requests"])
