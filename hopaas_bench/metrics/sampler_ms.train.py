"""The service's sampler on the ask path: host time of the port's
``sampler.suggest`` spans whose ``path`` is "ask", a mean over those in
the window (ms)."""
from hopaas_bench.program import program_spans

PLANTED = ("train", 4.0)  # the tests: record (planted.py), reading


def read(rec: dict) -> float | None:
    asks = [s for s in program_spans(rec, {"sampler.suggest"}) or ()
            if s.attrs.get("path") == "ask"]
    return sum(s.end - s.start for s in asks) / 1e6 / len(asks) if asks else None
