"""The 95th percentile of every request's time in the window, from the step's
start to its read-back, in ms (``statistics.quantiles``, inclusive method)."""

import statistics

UNIT = "ms"
LAYER = "end to end"
MOVES = "request_ms_p95"


def read(record):
    times = record.window.request_s
    if len(times) < 2:
        return None
    return statistics.quantiles(times, n=100, method="inclusive")[94] * 1e3
