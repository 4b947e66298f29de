"""Latent attention's core (scores, softmax, p.v): device time of the
kernels launched inside the port's ``mla.core`` spans, a window step
(ms).  The spans cover the forward and the backward's recompute of each
layer; the core's gradient kernels lie under ``step.backward``."""
from hopaas_bench.program import launched_ms, per

PLANTED = ("moe", 4.0)  # the tests: record (planted_moe.py), reading


def read(rec: dict) -> float | None:
    return per(launched_ms(rec, {"mla.core"}), rec["steps"])
