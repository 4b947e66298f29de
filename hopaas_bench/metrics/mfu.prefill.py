"""Model FLOPs of the window's prompts (``work.flops``) over the
window's span at the bf16 peak (%)."""
from hopaas_bench.readers import mfu_percent
from hopaas_bench.work.flops import forward_flops


def read(rec: dict) -> float | None:
    conf = rec["run"].cell.config
    return mfu_percent(rec, sum(forward_flops(conf, rec["batch"], r["length"])
                                for r in rec["requests"]))
