"""The device's idle time inside the prefill call, while the host launches
its kernels: under the port's ``serve.prefill`` spans, a window request
(ms)."""
from hopaas_bench.program import idle_ms, log_split, per

PLANTED = ("prefill", 11.0)  # the tests: record (planted.py), reading


def read(rec: dict) -> float | None:
    log_split(rec)
    return per(idle_ms(rec, {"serve.prefill"}), rec["requests"])
