"""How unevenly the router loads the experts this card holds: the
trials' ``moe.pairs`` counters (each held expert's (token, k) pairs by
MoE layer, counted on the device in the forward and recorded under that
name by the port's ``trainer.counts`` span at a trial's end) summed over
the window's trials, the largest (layer, expert) count over their mean.
1 is an even load; the card's expert products wait on the most loaded
expert in a deployment's all-to-all.  A trial cut by the window's close records no
load inside it."""
from hopaas_bench.program import program_spans

PLANTED = ("moe", 1.6)  # the tests: record (planted_moe.py), reading


def read(rec: dict) -> float | None:
    loads = [s.attrs["moe.pairs"] for s in
             program_spans(rec, {"trainer.counts"}) or ()
             if "moe.pairs" in s.attrs]
    if not loads:
        return None
    cells = [sum(c) for c in zip(*(
        [v for row in pairs for v in row] for pairs in loads))]
    mean = sum(cells) / len(cells)
    return max(cells) / mean if mean else None
