"""One torch.profiler window, read back as intervals on one clock.

The harness profiles a stretch of a traced run's window and hands the
metric readers a ``Profile``: the device's operations (kernels, copies,
fills) and the benchmark's own spans (``portbench.<name>`` annotations
around the calls into each layer), each as (name, start, end) in
seconds, and the host's operations for labelling the device's idle gaps.
The reductions here are plain functions of those lists.
"""

from __future__ import annotations

import bisect
import dataclasses
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime")
SPAN_PREFIX = "portbench."


@dataclasses.dataclass
class Profile:
    device: list  # (name, start_s, end_s), sorted by start
    spans: list  # (span name without the prefix, start_s, end_s)
    host: list  # (name, start_s, end_s) on the spans' thread, by start
    start: float  # the traced window: the first request's start ...
    end: float  # ... to the last one's end

    @property
    def window_s(self) -> float:
        return self.end - self.start


def from_chrome_trace(path: str) -> Profile:
    """Read ``export_chrome_trace``'s file: complete events in µs."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, spans, host = [], [], []
    span_tid = None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        iv = (float(e["ts"]) * 1e-6, (float(e["ts"]) + float(e["dur"])) * 1e-6)
        if cat in DEVICE_CATS:
            dev.append((name, *iv))
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans.append((name[len(SPAN_PREFIX):], *iv))
            span_tid = e.get("tid")
        elif cat in HOST_CATS:
            host.append((name, *iv, e.get("tid")))
    host = [h[:3] for h in host if h[3] == span_tid]
    return make_profile(dev, spans, host)


def make_profile(device, spans, host) -> Profile:
    """A Profile whose window runs from the first request span's start to
    the last one's end (the whole lists where there is no request)."""
    device, spans, host = (sorted(x, key=lambda e: e[1])
                           for x in (device, spans, host))
    req = [s for s in spans if s[0] == "request"] or spans or device
    start = min(s[1] for s in req) if req else 0.0
    end = max(s[2] for s in req) if req else 0.0
    return Profile(device=device, spans=spans, host=host, start=start,
                   end=end)


def _merged(intervals, lo, hi):
    """Sorted, merged intervals clipped to [lo, hi]."""
    out = []
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_s(p: Profile) -> float:
    """Seconds of the window in which some device operation ran: the
    union of their intervals."""
    return sum(e - s for s, e in _merged(p.device, p.start, p.end))


def idle_gaps(p: Profile) -> list:
    """(start, end) of each stretch of the window with no device
    operation running."""
    gaps, t = [], p.start
    for s, e in _merged(p.device, p.start, p.end):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if p.end > t:
        gaps.append((t, p.end))
    return gaps


def spans_named(p: Profile, name: str) -> list:
    return [s for s in p.spans if s[0] == name]


def device_s_within(p: Profile, name: str, match: str = "") -> float:
    """Device seconds of the operations (whose name holds ``match``) that
    start inside a span ``name``: a span is synchronize-bracketed, so
    everything it launched runs inside it."""
    spans = spans_named(p, name)
    starts = [s[1] for s in spans]
    total = 0.0
    for op, s, e in p.device:
        if match not in op:
            continue
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s <= spans[i][2]:
            total += e - s
    return total


def device_ops(p: Profile, k: int = 10) -> list:
    """[[name, seconds], ...]: the device operations that took the most
    time in the window, summed by name."""
    by = {}
    for op, s, e in p.device:
        s, e = max(s, p.start), min(e, p.end)
        if e > s:
            by[op] = by.get(op, 0.0) + (e - s)
    return [[n, v] for n, v in sorted(by.items(), key=lambda x: -x[1])[:k]]


def _innermost(intervals, starts, t, reach=256):
    """The latest-starting interval that holds t (None if none of the
    ``reach`` intervals starting last before t does)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - reach, -1), -1):
        if intervals[j][2] >= t:
            return intervals[j]
    return None


def labelled_gaps(p: Profile, k: int = 10) -> list:
    """[[label, seconds], ...]: the window's idle time summed by what the
    host was doing meanwhile, "<span>/<host op>" at each gap's middle (the
    innermost of each; "-" where none), the largest k."""
    s_starts = [s[1] for s in p.spans]
    h_starts = [h[1] for h in p.host]
    by = {}
    for s, e in idle_gaps(p):
        mid = 0.5 * (s + e)
        span = _innermost(p.spans, s_starts, mid)
        op = _innermost(p.host, h_starts, mid)
        label = f"{span[0] if span else '-'}/{op[0] if op else '-'}"
        by[label] = by.get(label, 0.0) + (e - s)
    return [[n, v] for n, v in sorted(by.items(), key=lambda x: -x[1])[:k]]
