"""The MoE layers' expert products: device time of the kernels launched
inside the port's ``moe.experts`` (the held routed experts on their
rows) and ``moe.shared`` (the shared experts on every token) spans, a
window step (ms).  The spans cover the forward and the backward's
recompute; the products' gradient kernels lie under ``step.backward``."""
from hopaas_bench.program import launched_ms, per

PLANTED = ("moe", 5.0)  # the tests: record (planted_moe.py), reading


def read(rec: dict) -> float | None:
    return per(launched_ms(rec, {"moe.experts", "moe.shared"}),
               rec["steps"])
