"""Device ms a call of the draws kernel (``draws_kernel*``: the streaming
lowering's boundary pass and every slab's draws) takes, from the profiled
stretch of the window: its device time over the calls profiled.  Nothing
where the cell does not lower by slabs."""

from portbench import devtrace


def compute(record):
    p = record["profile"]
    if p is None or not devtrace.spans_named(p, "lower_stream"):
        return None
    calls = len(devtrace.spans_named(p, "request"))
    ms = sum(1e3 * (e - s) for name, s, e in p.device
             if "draws_kernel" in name and s >= p.start and e <= p.end)
    return ms / calls if calls and ms > 0 else None
