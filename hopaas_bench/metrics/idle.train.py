"""The device's idle share of the window, from the trace (%)."""
from hopaas_bench.readers import idle_percent as read  # noqa: F401
