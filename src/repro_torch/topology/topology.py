"""Multi-cloudlet topology: device <-> cloudlet association + capacities.

Port of ``repro/topology/topology.py``.  The paper's OnAlgo couples the
whole fleet through ONE cloudlet capacity constraint (a scalar dual mu).
A deployment with ``K`` cloudlets has K capacities ``H_k`` and a device
-> cloudlet association that may shift over time (mobility, handover,
failover).  A :class:`Topology` describes that layer:

  * ``assoc``: ``(N,)`` int32 for a static placement, or ``(T, N)``
    int32 when devices move; ``assoc[t, n] = k`` means device n offloads
    to cloudlet k at slot t.
  * ``H_k``: ``(K,)`` float32 per-cloudlet average capacities.  The
    scalar dual mu becomes a ``(K,)`` vector: device n is priced by
    ``mu[assoc[t, n]]`` and each cloudlet's dual ascends on the load of
    the devices associated with it.

``K == 1`` is the paper's single-cloudlet problem: every engine runs it
as the scalar-mu path, so ``Topology.uniform(1, N, H)`` reproduces a run
without a topology bit for bit (``H_k[0] == H`` exactly).

A mobility walk may also be carried in streaming form
(``mobility_walk(streaming=True)``): a :class:`StreamingAssoc` holds the
association entering each ROW_BLOCK-aligned block and regenerates any
slab on demand (the draws kernel), equal to the materialized walk.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.workload import streams


def _capacities(K: int, H, device) -> torch.Tensor:
    """(K,) float32 capacities from a scalar total (split evenly, in
    float32, so ``H / 1 == H`` exactly) or a (K,) array."""
    if not isinstance(H, torch.Tensor):
        H = torch.from_numpy(np.asarray(H, np.float32))
    H = H.to(device=device, dtype=torch.float32)
    if H.ndim == 0:
        return torch.full((K,), float(H / K), dtype=torch.float32,
                          device=device)
    if tuple(H.shape) != (K,):
        raise ValueError(f"H_k shape {tuple(H.shape)} != ({K},)")
    return H


class _LoweredOnRead:
    """A data descriptor for ``StreamingAssoc.entry``: the value given at
    construction, or, where that is None, the walk's boundary states
    lowered at the first read (``StreamingAssoc._lower``) and kept."""

    def __set_name__(self, owner, name):
        self.key = "_" + name

    def __get__(self, obj, owner=None):
        if obj is None:
            return None  # the field's default: lowered at the first read
        if obj.__dict__[self.key] is None:
            obj.__dict__[self.key] = obj._lower()
        return obj.__dict__[self.key]

    def __set__(self, obj, value):
        obj.__dict__[self.key] = value


@dataclasses.dataclass(kw_only=True, repr=False)
class StreamingAssoc:
    """A mobility walk lowered to a slab-addressable form.

    Holds the association ENTERING each ROW_BLOCK-aligned block; any slab
    [t0, t0 + length) is regenerated from its first block's boundary state
    by one draws call, from O(length * N) work, equal to slicing the
    (T, N) walk (integer holds, no float re-association).  A
    :class:`Topology` carries it in place of a dense ``assoc``;
    ``shape`` / ``ndim`` mimic the dense map, so the Topology's accessors
    are unchanged.

    Built with ``entry=None`` (``Topology.mobility_walk(streaming=True)``)
    the walk is lowered where it is first read, on ``at``: inside the run
    that uses it, so its cost lands in that run's ``walk`` span."""

    # (n_blocks, N) int32: held assoc entering block b; None until read
    entry: Optional[torch.Tensor] = _LoweredOnRead()
    p_handover: float  # a float32 value
    seed: int
    T: int
    N: int
    K: int
    at: Optional[torch.device] = None  # where a walk not yet lowered lowers

    ndim = 2  # quacks like the (T, N) map it lowers

    @property
    def shape(self):
        return (self.T, self.N)

    @property
    def lowered(self) -> bool:
        return self.__dict__["_entry"] is not None

    @property
    def device(self) -> torch.device:
        return self.entry.device if self.lowered else resolve_device(self.at)

    def _proc(self):
        from repro_torch.kernels.draws import WalkProcess
        return WalkProcess(seed=self.seed, N=self.N, K=self.K,
                           p_handover=self.p_handover)

    def _lower(self) -> torch.Tensor:
        return _walk_entry(self._proc(), self.T, self.device)

    def replace(self, **changes) -> "StreamingAssoc":
        """``dataclasses.replace`` that leaves a walk not yet lowered so."""
        changes.setdefault("entry", self.__dict__["_entry"])
        return dataclasses.replace(self, **changes)

    @obs.spanned("assoc")
    def slab(self, t0: int, length: int) -> torch.Tensor:
        """(length, N) int32 association for slots [t0, t0 + length)."""
        from repro_torch.kernels import ops

        RB = streams.ROW_BLOCK
        t0, length = int(t0), int(length)
        if not (0 <= t0 and length >= 1 and t0 + length <= self.T):
            raise ValueError(f"assoc slab [{t0}, {t0} + {length}) outside "
                             f"the walk's horizon [0, {self.T})")
        b0, off = divmod(t0, RB)
        nb = (off + length - 1) // RB + 1
        (assoc,) = ops.draws(self._proc(), b0, nb, (self.entry[b0],),
                             off=off, length=length, device=self.device)
        return assoc

    def to(self, device) -> "StreamingAssoc":
        if not self.lowered:
            return self.replace(at=torch.device(device))
        return self.replace(entry=self.entry.to(device))


@obs.spanned("walk")
def _walk_entry(proc, T: int, device) -> torch.Tensor:
    """The held association entering each of the walk's blocks,
    (ceil(T / ROW_BLOCK), N) int32: one draws call in boundary form."""
    from repro_torch.kernels import ops

    (entry,) = ops.draws(proc, 0, -(-T // streams.ROW_BLOCK),
                         boundary=True, device=device)
    return entry


def lower_mobility_walk(seed, K: int, N: int, T: int, p_handover, *,
                        device=None) -> StreamingAssoc:
    """Lower a mobility walk to streaming form on ``device`` (None ->
    cuda) now: one draws call in boundary form records the held
    association entering every block, (ceil(T / ROW_BLOCK), N), never the
    (T, N) walk.  ``Topology.mobility_walk(streaming=True)`` leaves the
    same lowering to the walk's first read."""
    walk = _unlowered_walk(seed, K, N, T, p_handover, resolve_device(device))
    return walk.replace(entry=walk._lower())


def _unlowered_walk(seed, K, N, T, p_handover, device) -> StreamingAssoc:
    return StreamingAssoc(p_handover=float(np.float32(p_handover)),
                          seed=int(seed), T=T, N=N, K=K, at=device)


@dataclasses.dataclass
class Topology:
    """K cloudlets serving an N-device fleet.

    assoc: (N,) int32 static, or (T, N) int32 time-varying association
      (values in [0, K)).
    H_k: (K,) float32 per-cloudlet average capacity.  Its constructors accept
      a scalar total capacity and split it evenly.
    K: cloudlet count.

    The constructors take ``device`` (None -> cuda, as every entry point of the
    port); engines move a topology to their own device.
    """

    assoc: torch.Tensor
    H_k: torch.Tensor
    K: int

    @property
    def N(self) -> int:
        return self.assoc.shape[-1]

    @property
    def time_varying(self) -> bool:
        return self.assoc.ndim == 2

    @property
    def T(self):
        """Horizon of a time-varying association map (None when static)."""
        return self.assoc.shape[0] if self.time_varying else None

    @property
    def streaming(self) -> bool:
        """True when the association is a slab-addressable walk."""
        return isinstance(self.assoc, StreamingAssoc)

    def to(self, device) -> "Topology":
        return Topology(assoc=self.assoc.to(device),
                        H_k=self.H_k.to(device), K=self.K)

    def assoc_at(self, t0: int, length: int) -> torch.Tensor:
        """(length, N) association for slots [t0, t0 + length): a slice of
        a time-varying map, the static map broadcast (a view), or a
        streaming walk's slab regenerated from its block states."""
        if not self.time_varying:
            return self.assoc.expand(length, self.N)
        if self.streaming:
            return self.assoc.slab(t0, length)
        return self.assoc[t0:t0 + length]

    def prefix(self, T: int) -> "Topology":
        """The topology restricted to slots [0, T)."""
        if not self.time_varying or self.assoc.shape[0] == T:
            return self
        assoc = (self.assoc.replace(T=T) if self.streaming
                 else self.assoc[:T])
        return Topology(assoc=assoc, H_k=self.H_k, K=self.K)

    # --- constructors -----------------------------------------------------

    @staticmethod
    def uniform(K: int, N: int, H, *, device=None) -> "Topology":
        """Static round-robin placement: device n -> cloudlet n % K."""
        dev = resolve_device(device)
        assoc = (torch.arange(N, dtype=torch.int32, device=dev) % K).to(
            torch.int32)
        return Topology(assoc=assoc, H_k=_capacities(K, H, dev), K=K)

    @staticmethod
    def nearest_zone(K: int, N: int, H, *, device=None) -> "Topology":
        """Static contiguous zones: device n -> cloudlet n * K // N (the
        geographic layout: neighbours share a server)."""
        dev = resolve_device(device)
        n = torch.arange(N, dtype=torch.int64, device=dev)
        assoc = (n * K // N).to(torch.int32)
        return Topology(assoc=assoc, H_k=_capacities(K, H, dev), K=K)

    @staticmethod
    def hotspot(K: int, N: int, H, hot_frac: float = 0.5, hot: int = 0, *,
                device=None) -> "Topology":
        """Static skewed placement: the first ``hot_frac`` of the fleet
        crowds cloudlet ``hot``; the rest spread round-robin over the
        remaining cloudlets."""
        if K < 2:
            raise ValueError("hotspot needs K >= 2 cloudlets")
        dev = resolve_device(device)
        n = torch.arange(N, dtype=torch.int64, device=dev)
        n_hot = int(N * hot_frac)
        others = (hot + 1 + (n % (K - 1))) % K
        assoc = torch.where(n < n_hot, hot, others).to(torch.int32)
        return Topology(assoc=assoc, H_k=_capacities(K, H, dev), K=K)

    @staticmethod
    def mobility_walk(K: int, N: int, T: int, H, p_handover: float = 0.05,
                      seed: int = 0, streaming: bool = False, *,
                      device=None) -> "Topology":
        """Time-varying association from a counter-addressed random walk.

        Each slot, each device hands over to a uniformly random cloudlet
        with probability ``p_handover`` (it may redraw its current one)
        and otherwise stays; the initial placement is :meth:`uniform`'s.
        The draws are the workload layer's v1 streams (``STREAM_TOPOLOGY``),
        so the walk equals the reference's bit for bit and is
        horizon-extensible; one draws call (the kernel on the card).
        ``streaming=True`` carries a :class:`StreamingAssoc` instead: the
        same realization, block boundary states only, any slab regenerated
        on demand; peak memory O(T / ROW_BLOCK * N), not O(T * N).  Its
        boundary states are lowered at their first read (the run that uses
        the walk pays for them, in its ``walk`` span).
        """
        from repro_torch.kernels import ops
        from repro_torch.kernels.draws import WalkProcess

        dev = resolve_device(device)
        if streaming:
            return Topology(
                assoc=_unlowered_walk(seed, K, N, T, p_handover, dev),
                H_k=_capacities(K, H, dev), K=K)
        proc = WalkProcess(seed=int(seed), N=N, K=K,
                           p_handover=float(np.float32(p_handover)))
        (assoc,) = ops.draws(proc, 0, -(-T // streams.ROW_BLOCK), length=T,
                             device=dev)
        return Topology(assoc=assoc, H_k=_capacities(K, H, dev), K=K)

    def failover(self, down, k_down: int) -> "Topology":
        """Re-associate cloudlet ``k_down``'s devices while it is down.

        ``down`` is a (T,) bool outage mask; during down slots every device
        pointing at ``k_down`` fails over to a surviving cloudlet (spread
        round-robin) and returns when the cloudlet comes back."""
        if self.K < 2:
            raise ValueError("failover needs K >= 2 cloudlets")
        dev = self.assoc.device
        if not isinstance(down, torch.Tensor):
            down = torch.from_numpy(np.asarray(down, bool))
        down = down.to(device=dev, dtype=torch.bool)
        T = down.shape[0]
        base = self.assoc_at(0, T)
        n = torch.arange(self.N, dtype=torch.int64, device=dev)
        alt = ((k_down + 1 + (n % (self.K - 1))) % self.K).to(torch.int32)
        assoc = torch.where(down[:, None] & (base == k_down), alt[None, :],
                            base)
        return Topology(assoc=assoc.to(torch.int32), H_k=self.H_k, K=self.K)


def validate_topology(topology, T: int, N: int) -> None:
    """Check a topology against a rollout's (T, N): fleet size, horizon
    coverage of a time-varying map, the H_k shape, and association ids in
    [0, K) (out-of-range ids would make the engines silently disagree)."""
    if topology is None:
        return
    if topology.N != N:
        raise ValueError(
            f"topology is built for N={topology.N} devices, rollout has "
            f"N={N}")
    if topology.time_varying and topology.assoc.shape[0] < T:
        raise ValueError(
            f"time-varying association covers {topology.assoc.shape[0]} "
            f"slots, rollout needs {T}")
    if tuple(topology.H_k.shape) != (topology.K,):
        raise ValueError(
            f"H_k shape {tuple(topology.H_k.shape)} != ({topology.K},)")
    ids = topology.assoc
    if topology.streaming:
        # slabs draw cloudlets in [0, K) by construction; the boundary
        # states are the only stored ids, so checking them (and K) covers
        # the whole walk
        if topology.assoc.K != topology.K:
            raise ValueError(
                f"streaming association draws over K={topology.assoc.K} "
                f"cloudlets, topology has K={topology.K}")
        ids = topology.assoc.entry
    if ids.numel():
        lo, hi = (int(x) for x in torch.aminmax(ids))
        if lo < 0 or hi >= topology.K:
            raise ValueError(
                f"association ids must lie in [0, K={topology.K}); map "
                f"contains [{lo}, {hi}]")
