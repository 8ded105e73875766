"""The share of the profiled stretch of the window (first request's start
to last one's end) in which no device operation runs: 1 - the union of
their intervals on the timeline, %."""

from portbench import devtrace


def compute(record):
    p = record["profile"]
    if p is None or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - devtrace.busy_s(p) / p.window_s)
