"""Model FLOPs of the window's train steps (forward and backward,
``work.flops``) over the window's span at the bf16 peak (%)."""
from hopaas_bench.readers import mfu_percent
from hopaas_bench.work.flops import train_flops


def read(rec: dict) -> float | None:
    steps = rec["steps"]
    if not steps:
        return None
    T = rec["run"].cell.traffic
    return mfu_percent(rec, len(steps) * train_flops(
        rec["run"].cell.config, T["global_batch"], T["seq_len"]))
