"""The trainer's set-up of a trial: from the ask's reply to the call of
the trial's first step (the trainer's construction, ``init_train_state``
and the first batch), for the trials asked inside the window (ms)."""
from hopaas_bench.readers import in_window


def read(rec: dict) -> float | None:
    run, steps = rec["run"], in_window(rec, "step")
    out = []
    for t in rec["trials"]:
        if not run.t_open <= t["asked"] <= run.t_close:
            continue
        first = next((s.start for s in steps if s.start >= t["asked"]), None)
        if first is not None:
            out.append((first - t["asked"]) / 1e6)
    return sum(out) / len(out) if out else None
