"""The MoE layers' routing and data movement: device time of the kernels
launched inside the port's ``moe.route`` (router, softmax, top-k,
balance loss), ``moe.dispatch`` (the sort by expert, the gather of the
rows) and ``moe.combine`` (the gated rows back to their tokens) spans, a
window step (ms).  The spans cover the forward and the backward's
recompute; their gradient kernels lie under ``step.backward``."""
from hopaas_bench.program import launched_ms, per

PLANTED = ("moe", 3.0)  # the tests: record (planted_moe.py), reading


def read(rec: dict) -> float | None:
    return per(launched_ms(rec, {"moe.route", "moe.dispatch",
                                 "moe.combine"}), rec["steps"])
