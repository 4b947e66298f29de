"""The optimizer's device time a step: kernels launched inside the
train step's ``adamw_update`` (ms)."""
from hopaas_bench.harness import containing
from hopaas_bench.readers import in_window


def read(rec: dict) -> float | None:
    spans = in_window(rec, "adamw")
    kernels = rec["run"].kernels
    if not spans or not kernels:
        return None
    total = sum(k.end - k.start for k in kernels
                if containing(spans, k.launch) is not None)
    return total / 1e6 / len(spans) if total else None
