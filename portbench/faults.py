"""Faults planted in the timed path, to show that the check sees them: a
run with one of them comes out not correct.  One for each fault a batch
service cell can have: a step that leaves its state unchanged, half of
the fleet left out with the means taken over the rest, and an answer
altered where it is produced.  (One card: there is no exchange between
chips to leave out.)

    with planted("half_fleet"):
        harness.run_cell(...)

The faults replace module attributes of the program while the block is
open; the CPU tests and ``calibrate.py`` (at a cell's own size on the
card) use them.
"""

from __future__ import annotations

import contextlib
import dataclasses


def state_unchanged(patch):
    """Every rollout step leaves the duals where they were (step 0)."""
    from repro_torch.kernels import ops
    for name in ("onalgo_chunked", "onalgo_tiled"):
        fn = getattr(ops, name)

        def frozen(*a, _fn=fn, **kw):
            a = list(a)
            a[9] = 0.0  # a: a_t = 0, no ascent
            if kw.get("run") is not None:
                kw["run"] = None  # its step tables hold the true rule
            return _fn(*a, **kw)
        patch(ops, name, frozen)


def half_fleet(patch):
    """The fold sees half of the devices' series, scaled up to the fleet."""
    from repro_torch.core import fleet

    def head(x, keep):  # the first ``keep`` devices, as the kernels take
        return x[:, :keep].contiguous()
    for name in ("simulate_chunked", "simulate_chunked_stream"):
        fn = getattr(fleet, name)

        def half(*a, _fn=fn, _name=name, **kw):
            a = list(a)
            if _name == "simulate_chunked":
                tr = a[0]
                keep = tr.j_idx.shape[1] // 2
                a[0] = dataclasses.replace(tr, j_idx=head(tr.j_idx, keep),
                                           d_local=head(tr.d_local, keep))
                a[2] = dataclasses.replace(a[2], B=a[2].B[:keep])
                ov = kw["overlay"]
                kw["overlay"] = type(ov)(*(head(getattr(ov, f.name), keep)
                                           for f in dataclasses.fields(ov)))
            else:
                src, N = a[0], a[2]
                keep = N // 2

                def source(t0, L, _src=src):
                    j, ov = _src(t0, L)
                    return head(j, keep), type(ov)(*(
                        head(getattr(ov, f.name), keep)
                        for f in dataclasses.fields(ov)))
                a[0], a[2] = source, keep
                a[4] = dataclasses.replace(a[4], B=a[4].B[:keep])
            series, final = _fn(*a, **kw)
            return ({k: v * (2.0 if k not in ("mu", "lam_norm") else 1.0)
                     for k, v in series.items()}, final)
        patch(fleet, name, half)


def answer_altered(patch):
    """One more offload in one slot, where the series are folded."""
    from repro_torch.serve import compile as sc
    fn = sc.service_metrics

    def altered(sim, series):
        series = dict(series)
        off = series["offloads"].clone()
        off[0] += 1.0
        series["offloads"] = off
        return fn(sim, series)
    patch(sc, "service_metrics", altered)


FAULTS = {f.__name__: f for f in (state_unchanged, half_fleet,
                                  answer_altered)}


@contextlib.contextmanager
def planted(name: str):
    """The fault ``name`` in place while the block is open."""
    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)
    try:
        FAULTS[name](patch)
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)
