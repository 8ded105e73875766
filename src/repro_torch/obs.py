"""The port's own tracing: spans and a host-sync counter on the OnAlgo
service path.

It records while ``torch.profiler`` runs, and at no other time: tracing
on means the profiler is on.  With the profiler off, ``span`` returns a
shared null context and ``host_sync`` returns at once, after one check
(``torch._C._autograd._profiler_enabled``, a fraction of a microsecond):
no clock is read, no CUDA event made, nothing appended.

A span records its name, its parent, the id of its call (every span
under one root, such as one ``simulate_service`` call's ``service``,
shares it), the host clock at open and close (``time.perf_counter``,
with no synchronize) and, where CUDA is initialized, a pair of timing
events recorded on the current stream; it also opens a
``torch.profiler.record_function("repro_torch.<name>")`` range, so each
span lies on the profiler's timeline beside the device operations.
Nothing synchronizes inside a span: a slab loop that never waits for the
card still never waits.  Spans are kept in memory up to ``MAX_SPANS``;
later ones are counted as dropped.

The span tree of a service call (the names the benchmark reads):

    service                simulate_service, one a call
      lower                compile_service / compile_service_streaming
        draws              the workload draws (the streamed boundary pass)
        quantize           the gathers, the risk-adjusted gain, quantization
        on_copy            the (T, N) arrival matrix read back
      engine               simulate_chunked / simulate_chunked_stream
        rollout            the K1 / K2 call, the plain tail
        series             admission and the accounting series
        slab               one a slab of the stream: draws, quantize,
                           rollout and series under it
      fold                 service_metrics
      release              the materialized lowering's arrays freed (the
                           host copy of the arrival matrix among them)

``host_sync(nbytes, site)`` counts a place where the host waits for the
card (a read back, or a host array's blocking copy to the card, which
``upload`` makes and counts), into the innermost open span's call; on
the CPU the same places are counted, though nothing waits there.  ``report()`` synchronizes once and returns
the figures a call; ``reset()`` forgets everything recorded.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import statistics
import threading
import time

import numpy as np
import torch

PREFIX = "repro_torch."
MAX_SPANS = 1 << 16

_enabled = torch._C._autograd._profiler_enabled
_clock = time.perf_counter
_OFF = contextlib.nullcontext()
_local = threading.local()  # .stack: the thread's open spans
_ids = itertools.count(1)
_spans = []  # every recorded span, in order of opening
_syncs = []  # (call id, innermost span name, site, bytes)
_dropped = 0


class _Span:
    __slots__ = ("name", "id", "parent", "call", "start", "end", "events",
                 "counts", "launches", "_range")

    def __init__(self, name, counts):
        stack = _stack()
        top = stack[-1] if stack else None
        self.name, self.id = name, next(_ids)
        self.parent = None if top is None else top.id
        self.call = self.id if top is None else top.call
        self.counts, self.launches = counts, None
        self.end = self.events = None
        self.start = 0.0

    def __enter__(self):
        _stack().append(self)
        _spans.append(self)
        self._range = torch.profiler.record_function(PREFIX + self.name)
        self._range.__enter__()
        if self.counts is not None:
            self.launches = self.counts()
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        self.end = _clock()
        if self.events is not None:
            self.events[1].record()
        if self.counts is not None:
            after = self.counts()
            self.launches = {k: n - self.launches.get(k, 0)
                             for k, n in after.items()
                             if n != self.launches.get(k, 0)}
        self._range.__exit__(*exc)
        _stack().pop()
        return False


def _stack():
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def span(name: str, counts=None):
    """A context manager that records span ``name`` while the profiler
    runs (a shared null context otherwise).  ``counts``: a callable
    returning {name: count} (``kernels.ops.launch_counts``), whose change
    over the span is recorded with it."""
    if not _enabled():
        return _OFF
    global _dropped
    if len(_spans) >= MAX_SPANS:
        _dropped += 1
        return _OFF
    return _Span(name, counts)


def spanned(name: str, counts=None):
    """Decorator: each call of the function runs inside ``span(name,
    counts)`` (the function alone where the profiler is off)."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned_call(*args, **kwargs):
            if not _enabled():
                return fn(*args, **kwargs)
            with span(name, counts):
                return fn(*args, **kwargs)
        return spanned_call
    return wrap


def host_sync(nbytes: int, site: str):
    """Count one place where the host waits for the card, moving
    ``nbytes`` bytes, named ``site``, into the innermost open span's
    call (while the profiler runs; nothing otherwise)."""
    if not _enabled():
        return
    stack = _stack()
    top = stack[-1] if stack else None
    if len(_syncs) < MAX_SPANS:
        _syncs.append((None if top is None else top.call,
                       None if top is None else top.name, site,
                       int(nbytes)))


def upload(x, device, dtype=None) -> torch.Tensor:
    """``torch.tensor(x, dtype=dtype, device=device)``, counted by
    ``host_sync`` as a blocking copy to the card (it waits for the
    card's stream)."""
    t = torch.tensor(np.asarray(x), dtype=dtype, device=device)
    host_sync(nbytes(t), "upload")
    return t


def nbytes(*tensors) -> int:
    """Bytes of ``tensors``' elements."""
    return sum(t.numel() * t.element_size() for t in tensors)


def reset():
    """Forget every recorded span and sync."""
    global _dropped
    _spans.clear()
    _syncs.clear()
    _dropped = 0


def _device_ms(s) -> float:
    if s.events is None:
        return 1e3 * (s.end - s.start)
    return s.events[0].elapsed_time(s.events[1])


def records() -> list:
    """The closed spans as dicts (name, id, parent, call, start and end on
    the host clock in s, device_ms), in order of opening; synchronizes
    once where a span holds events."""
    closed = [s for s in _spans if s.end is not None]
    if any(s.events is not None for s in closed):
        torch.cuda.synchronize()
    return [{"name": s.name, "id": s.id, "parent": s.parent,
             "call": s.call, "start": s.start, "end": s.end,
             "device_ms": _device_ms(s), "launches": s.launches}
            for s in closed]


def report() -> dict:
    """The recorded figures a call (a call: the spans under one root):

      calls      the number of calls;
      spans      {name: {calls, host_ms, device_ms, self_device_ms}}: the
                 spans of the name a call (mean), and the median over the
                 calls that have it of their sum a call: host ms, device
                 ms (the stream's time between the span's two events; the
                 host clock where there are none), and device ms less
                 that of the span's children;
      host_syncs, host_sync_bytes
                 the median a call; ``host_syncs_by_site`` {site: mean a
                 call}; ``host_syncs_by_span`` {innermost span: mean};
      launches   {kernel: mean a call} from the spans given ``counts``;
      dropped    spans not recorded past ``MAX_SPANS``.

    Synchronizes once (``records``)."""
    recs = records()
    child_ms = {}
    for r in recs:
        if r["parent"] is not None:
            child_ms[r["parent"]] = (child_ms.get(r["parent"], 0.0)
                                     + r["device_ms"])
    calls = sorted({r["call"] for r in recs})
    per = {c: {} for c in calls}  # call -> name -> [n, host, dev, self]
    launches = {}
    for r in recs:
        acc = per[r["call"]].setdefault(r["name"], [0, 0.0, 0.0, 0.0])
        acc[0] += 1
        acc[1] += 1e3 * (r["end"] - r["start"])
        acc[2] += r["device_ms"]
        acc[3] += r["device_ms"] - child_ms.get(r["id"], 0.0)
        for k, n in (r["launches"] or {}).items():
            launches[k] = launches.get(k, 0) + n
    names = sorted({n for by in per.values() for n in by})
    n_calls = max(len(calls), 1)
    spans = {}
    for name in names:
        rows = [by[name] for by in per.values() if name in by]
        spans[name] = {
            "calls": sum(r[0] for r in rows) / n_calls,
            "host_ms": statistics.median(r[1] for r in rows),
            "device_ms": statistics.median(r[2] for r in rows),
            "self_device_ms": statistics.median(r[3] for r in rows)}
    syncs = {c: [0, 0] for c in calls}
    by_site, by_span = {}, {}
    for call, where, site, n in _syncs:
        if call not in syncs:
            continue  # outside every recorded call
        syncs[call][0] += 1
        syncs[call][1] += n
        by_site[site] = by_site.get(site, 0) + 1
        by_span[where] = by_span.get(where, 0) + 1
    a_call = lambda counts: {k: n / n_calls for k, n in counts.items()}
    return {"calls": len(calls), "spans": spans,
            "host_syncs": (statistics.median(s[0] for s in syncs.values())
                           if calls else 0),
            "host_sync_bytes": (statistics.median(
                s[1] for s in syncs.values()) if calls else 0),
            "host_syncs_by_site": a_call(by_site),
            "host_syncs_by_span": a_call(by_span),
            "launches": a_call(launches), "dropped": _dropped}
