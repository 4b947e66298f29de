"""The device's idle time while the trainer's loop holds the host outside
the step: under the port's ``trainer.init``, ``trainer.batch``,
``trainer.sync`` and ``trainer.report`` spans, a window step (ms)."""
from hopaas_bench.program import idle_ms, log_split, per

LOOP = {"trainer.init", "trainer.batch", "trainer.sync", "trainer.report"}

PLANTED = ("train", 14.0)  # the tests: record (planted.py), reading


def read(rec: dict) -> float | None:
    log_split(rec)
    return per(idle_ms(rec, LOOP), rec["steps"])
