"""The engine call's share of its roofline, %: the counted least time of
the work inside the engine's span (``counts.service_call``: the rollout,
and the slabs' draws where the engine draws them) over the device time of
every operation that the span launched, whatever implements it, in the
profiled stretch of the window."""

from portbench import devtrace


def compute(record):
    p = record["profile"]
    if p is None:
        return None
    calls = len(devtrace.spans_named(p, "engine"))
    dev = devtrace.device_s_within(p, "engine")
    if not calls or dev <= 0:
        return None
    return 100.0 * calls * record["cost"]["engine_s"] / dev
