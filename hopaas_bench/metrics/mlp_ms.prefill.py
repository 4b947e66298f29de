"""The prefill's MLP halves of the blocks (norm, SwiGLU, residual add):
device time of the kernels launched inside the port's ``model.mlp``
spans, a window request (ms)."""
from hopaas_bench.program import launched_ms, log_split, per

PLANTED = ("prefill", 12.0)  # the tests: record (planted.py), reading


def read(rec: dict) -> float | None:
    log_split(rec)
    return per(launched_ms(rec, {"model.mlp"}), rec["requests"])
