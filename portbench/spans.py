"""The benchmark's own spans around the calls into each layer of the
program: in a traced run, each entry point a client names is wrapped to
synchronize, read the host clock and open a ``portbench.<span>``
annotation (the profiler's window sees it) around its call.  The
program itself is not touched; the wrappers go with the run's last request.
An entry point that was wrapped and never called ends the run: the program
no longer passes through it, and the metrics of its span would go silent.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import time

import torch

from portbench.devtrace import SPAN_PREFIX


class Spans:
    """Host-clock durations by span name, and the wrapping."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        self._sync()
        t = time.perf_counter()
        with torch.profiler.record_function(SPAN_PREFIX + name):
            try:
                yield
            finally:
                self._sync()
        self.seconds.setdefault(name, []).append(time.perf_counter() - t)

    def _wrap(self, name, fn, calls, key):
        @functools.wraps(fn)
        def spanned(*a, **kw):
            calls[key] += 1
            with self.span(name):
                return fn(*a, **kw)
        return spanned

    @contextlib.contextmanager
    def around(self, entries):
        """Wrap each (span, module, attribute) of ``entries`` while open;
        on leaving, exit naming any of them that was never called."""
        saved, calls = [], {}
        try:
            for name, mod, attr in entries:
                m = importlib.import_module(mod)
                key = f"{mod}.{attr}"
                calls[key] = 0
                saved.append((m, attr, getattr(m, attr)))
                setattr(m, attr, self._wrap(name, getattr(m, attr), calls,
                                            key))
            yield self
        finally:
            for m, attr, fn in reversed(saved):
                setattr(m, attr, fn)
        never = [key for key, n in calls.items() if n == 0]
        if never:
            raise SystemExit(f"portbench: {never} wrapped for their spans "
                             "and never called")
