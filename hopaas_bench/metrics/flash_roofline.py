"""The flash attention kernel's share of its roofline at each request's
shape (%)."""
from hopaas_bench.readers import roofline_percent
from hopaas_bench.work.bounds import flash_ms


def read(rec: dict) -> float | None:
    c = rec["run"].cell.config
    return roofline_percent(
        rec, "flash", "flash_fwd_wgmma_kernel",
        lambda b, L: flash_ms(b, L, c["n_heads"], c["n_kv_heads"],
                              c["head_dim"]))
