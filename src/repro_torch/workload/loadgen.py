"""Closed-loop load generator for the live serving gateway.

Port of ``repro/workload/loadgen.py``.  Plays the role of the fleet: walks
the counter-addressed streaming service workload slot by slot and emits,
per slot, the *wave* of device reports a live cloudlet would receive —
the ids of the devices whose arrival chain fired, with the raw
``(o, h, w)`` values each device observes.  Everything below is the v1
counter-based RNG contract (``StreamingService.slab_cols`` →
``StreamingWorkload.slab_cols``, held against the full-width draws), so
the arrival stream equals what ``compile_service`` materializes, and a
gateway replay of these waves reproduces the batch ``fleet.simulate``
decisions exactly.

Column addressing is first-class: a generator can own just the device
range ``[n0, n0 + n_cols)`` (one instance per reporting shard, like real
devices), generating O(slab * n_cols) work per slab, equal to slicing a
full-width generator.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class Wave:
    """One slot's device reports: ``idx`` (R,) absolute device ids (a
    device appears at most once), ``o/h/w`` (R,) raw observed values."""

    t: int
    idx: np.ndarray
    o: np.ndarray
    h: np.ndarray
    w: np.ndarray

    @property
    def size(self) -> int:
        return int(self.idx.shape[0])


class ServiceLoadGen:
    """Wave source over a :class:`~repro_torch.serve.compile.StreamingService`.

    Slabs of ``slab`` slots are generated on the service's device (one
    draws call from counters) and cached on the host; ``wave(t)`` cuts
    slot ``t``'s reporting devices out of the cached slab.  ``n0`` /
    ``n_cols`` restrict the generator to a device column range, with
    absolute ids in the emitted waves.  ``prefetch=True`` enqueues slab
    t0 + slab as soon as slab t0 is on the host, so a sequential walk
    overlaps the next slab's draws with serving this one's waves (the
    waves are the same either way).
    """

    def __init__(self, service, *, slab: int = 64, n0: int = 0,
                 n_cols: Optional[int] = None, prefetch: bool = False):
        self.service = service
        self.T = int(service.sim.T)
        self.N = int(service.sim.num_devices)
        if not 0 <= n0 < self.N:
            raise ValueError(f"n0={n0} outside fleet [0, {self.N})")
        self.n0 = int(n0)
        self.n_cols = int(n_cols) if n_cols is not None else self.N - n0
        if n0 + self.n_cols > self.N:
            raise ValueError("column range exceeds the fleet")
        self.slab = int(slab)
        self.prefetch = bool(prefetch)
        self._t0 = -1  # cached slab start (aligned to slab)
        self._on = self._o = self._h = self._w = None
        self._next_t0 = -1  # prefetched slab start (on the device)
        self._next = None

    def _dispatch_slab(self, t0: int):
        """Enqueue slab [t0, t0+L) on the device; returns its (j, overlay)
        tensors (not yet copied to the host)."""
        length = min(self.slab, self.T - t0)
        return self.service.slab_cols(t0, length, self.n0, self.n_cols)

    def _ensure_slab(self, t: int) -> int:
        """Cache the slab covering slot ``t``; return its start."""
        t0 = (t // self.slab) * self.slab
        if t0 != self._t0:
            if t0 == self._next_t0:
                j, ov = self._next  # already enqueued
            else:
                j, ov = self._dispatch_slab(t0)
            self._next, self._next_t0 = None, -1
            # j > 0 <=> arrival: the state space reserves index 0 for null
            self._on = (j > 0).cpu().numpy()
            host = lambda x: x.float().cpu().numpy()
            self._o, self._h, self._w = host(ov.o), host(ov.h), host(ov.w)
            self._t0 = t0
            if self.prefetch and t0 + self.slab < self.T:
                self._next = self._dispatch_slab(t0 + self.slab)
                self._next_t0 = t0 + self.slab
        return t0

    def wave(self, t: int) -> Wave:
        """The reports for slot ``t`` (an empty wave when no device in
        this generator's column range has an arrival)."""
        if not 0 <= t < self.T:
            raise ValueError(f"slot {t} outside horizon [0, {self.T})")
        r = t - self._ensure_slab(t)
        mask = self._on[r]
        cols = np.flatnonzero(mask)
        return Wave(t=t, idx=(self.n0 + cols).astype(np.int32),
                    o=self._o[r][mask], h=self._h[r][mask],
                    w=self._w[r][mask])

    def waves(self, t0: int = 0,
              slots: Optional[int] = None) -> Iterator[Wave]:
        """Iterate waves for slots [t0, t0 + slots) (to the horizon's
        end by default)."""
        end = self.T if slots is None else min(self.T, t0 + slots)
        for t in range(t0, end):
            yield self.wave(t)
