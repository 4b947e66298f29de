"""The service as a trial's worker meets it: host time of the client's
ask and tell inside the window, over the trials asked there (ms)."""
from hopaas_bench.readers import in_window


def read(rec: dict) -> float | None:
    asks, tells = in_window(rec, "ask"), in_window(rec, "tell")
    if not asks:
        return None
    return sum(s.end - s.start for s in asks + tells) / 1e6 / len(asks)
