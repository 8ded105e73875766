"""Readers of the program's own spans and counters (``repro_torch.obs``).

The program records spans and its ``host_syncs`` counter while
torch.profiler runs, that is over a traced run's profiled stretch and at
no other time; ``obs.report()`` gives the figures a call over what it
recorded.  A program without ``repro_torch.obs`` (one older than its
spans) gives nothing to read: each function here then returns None, as
it does where the cell's calls never open the span.
"""

from __future__ import annotations


def report():
    """``repro_torch.obs.report()`` over the profiled stretch, or None
    where the program has no recorder or recorded no call."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    rep = obs.report()
    return rep if rep["calls"] else None


def device_ms(span: str):
    """Device ms a call of the spans named ``span``: the stream's time
    between each span's two events, summed over the call's spans of the
    name, the median over the profiled calls that have one."""
    rep = report()
    if rep is None or span not in rep["spans"]:
        return None
    return rep["spans"][span]["device_ms"]


def counter(name: str):
    """Counter ``name`` a call (the median over the profiled calls)."""
    rep = report()
    return None if rep is None else rep.get(name)
