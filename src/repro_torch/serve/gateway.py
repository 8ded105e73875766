"""Live serving gateway: OnAlgo as a persistent online service.

Port of ``repro/serve/gateway.py``.  Every other engine replays a horizon
it already knows.  The gateway runs the paper's deployment loop: devices
*report* their current observation ``(o, h, w)`` as requests arrive, the
cloudlet ticks Algorithm 1 once per slot over whatever reports came in,
and streams the offload/admit decisions back — no future knowledge.

Two layers:

  :class:`GatewayCore` — the synchronous algorithm surface.  A wave of
  device reports is padded to a size bucket, copied to the device in one
  transfer, scattered into fleet-shaped ``(N,)`` buffers, quantized with
  the same :func:`~repro_torch.serve.admission.quantize_states_device`
  the batch lowering uses, and rolled through one OnAlgo slot
  (:func:`repro_torch.core.onalgo.step` + per-slot cloudlet admission,
  with per-cloudlet duals when a :class:`~repro_torch.topology.Topology`
  is attached).  On the card a scalar-dual slot's policy and reductions
  are the single-slot kernel (K3, one launch a tick); a K > 1 topology
  takes the plain route, as the slot loop does.  The tick runs eagerly;
  the persistent state (duals and visit counts) is updated in place at
  dispatch, in stream order.
  Non-reporting devices scatter to ``j = 0`` (null) and every consumer
  masks by ``task``, so a tick equals the same slot of
  ``fleet.simulate(..., overlay=..., enforce_slot_capacity=True)`` (with
  ``use_kernel`` on the card) bit for bit.

  :class:`LiveGateway` — the asynchronous host loop, a depth-bounded wave
  pipeline.  Chunks of reports queue (bounded); the dispatcher drains
  them into one wave (one slot), dispatches it via
  :meth:`GatewayCore.tick_async` WITHOUT waiting for its decisions, and
  forms the next wave while a resolver task materializes the in-flight
  decisions in dispatch order.  ``max_in_flight`` bounds the depth
  (default 2; 1 is the sequential loop bit for bit); the decision stream
  is the same at every depth.  A full queue sheds a chunk, and a wave
  whose estimated completion would blow the latency SLO is answered with
  local-execution fallback (offload nobody), touching no state.

Wave contract: a wave IS one OnAlgo slot.  Each device appears at most
once per wave; devices that do not report are null-state (no task) for
that slot, exactly like a ``False`` arrival in the batch workload.

On a mesh (``GatewayCore(mesh=..., device_axis=...)``, torch.distributed,
one process a shard) every rank runs the same core and receives every
wave: it holds lam and the visit counts of its N/S devices (mu and the
slot counter are replicated), steps its own columns (K3 on the card)
with the capacity load all-reduced over the axis, and all-gathers the
offload vector, so that admission and the reply are global and the same
on every rank: two collectives a tick, issued in tick order.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import re
import threading
import time
from collections import deque
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import baselines as bl
from repro_torch.core import onalgo
from repro_torch.core.collectives import gather_cols, shards_of
from repro_torch.core.fleet import _shard_inputs, _validate_shards
from repro_torch.core.onalgo import OnAlgoParams, StepRule
from repro_torch.core.state_space import RhoEstimator
from repro_torch.serve.admission import quantize_states_device
from repro_torch.serve.engine import WaveBuckets
from repro_torch.topology import Topology, validate_topology

def default_buckets(num_devices: int, base: int = 64) -> Tuple[int, ...]:
    """Geometric wave-size buckets: ``base`` doubling up to N.

    Doubling keeps the shape count at O(log(N / base)) while padding waste
    stays under 2x.
    """
    if num_devices <= base:
        return (num_devices,)
    out = []
    b = base
    while b < num_devices:
        out.append(b)
        b *= 2
    out.append(num_devices)
    return tuple(out)


class _RhoInPlace(RhoEstimator):
    """The gateway's visit counts, advanced in place: the reference
    donates its state's buffers to the jitted tick, where the functional
    ``RhoEstimator.update`` would copy the (N, M) counts every slot.  The
    same values: one count a device is incremented."""

    def update(self, j_idx: torch.Tensor) -> "_RhoInPlace":
        rows = torch.arange(self.counts.shape[0], device=self.counts.device)
        self.counts[rows, j_idx.long()] += 1.0
        return _RhoInPlace(counts=self.counts, t=self.t + 1)


@dataclasses.dataclass
class GatewayCoreStats:
    ticks: int = 0
    reports: int = 0
    compiled_buckets: set = dataclasses.field(default_factory=set)

    @property
    def compiles(self) -> int:
        return len(self.compiled_buckets)


@dataclasses.dataclass
class PendingTick:
    """A dispatched-but-unresolved gateway tick.

    Returned by :meth:`GatewayCore.tick_async`: the decisions are being
    copied into pinned host buffers behind the tick on the device's
    stream, and ``ready`` (a CUDA event recorded after that copy; None on
    the CPU, where the tick ran synchronously) says when they have
    landed.  The core's persistent state has already advanced — resolving
    late (or never) cannot change any decision.
    """

    off_p: torch.Tensor  # padded (bucket,) offload decisions, host
    adm_p: torch.Tensor  # padded (bucket,) admitted decisions, host
    n_reports: int  # R — the unpadded wave size
    bucket: int  # padded wave bucket of this tick
    first_compile: bool  # True when this was the bucket's first tick
    dispatched_at: float  # perf_counter at dispatch end (EMA bookkeeping)
    ready: Optional[torch.cuda.Event] = None

    def done(self) -> bool:
        """Whether the decisions have landed (never waits)."""
        return self.ready is None or self.ready.query()

    def resolve(self) -> Tuple[np.ndarray, np.ndarray]:
        """Wait for the decisions (the tick's event only); returns
        (offload, admitted) bool arrays aligned with the wave's idx."""
        if self.ready is not None:
            self.ready.synchronize()
        off = self.off_p.numpy()[: self.n_reports].copy()
        adm = self.adm_p.numpy()[: self.n_reports].copy()
        return off, adm


class GatewayCore:
    """The gateway's synchronous algorithm surface (one tick = one slot).

    Args:
      space: the pool-calibrated :class:`~repro_torch.core.state_space.StateSpace`
        behind the value tables — reports are quantized as the batch
        lowering quantizes them.
      tables/params/rule: the fleet-engine contract pieces
        (``CompiledService`` / ``StreamingService`` carry them; see
        :meth:`for_service`); the tick runs on their device.
      num_devices: fleet size N (decisions are fleet-shaped internally).
      topology: optional multi-cloudlet :class:`Topology` — K-vector duals
        (K > 1) and per-cloudlet admission, as in
        ``fleet.simulate(topology=...)``.  A time-varying association is
        indexed by the gateway's own slot counter; a streaming walk is
        regenerated one ROW_BLOCK of slots at a time.
      buckets: wave-size buckets (default :func:`default_buckets`).
      mesh / device_axis: a ``DeviceMesh`` on the tables' device type
        (``launch.mesh``): the persistent state is sharded over
        ``device_axis``, each rank holding its N/S devices' lam and
        counts; every rank must make the same calls (ticks, warmup) in
        the same order, since each tick issues two collectives; the
        decisions are unchanged.
      enforce_slot_capacity: apply per-slot cloudlet admission to the
        offload decisions (the live cloudlet's semantics; default True).
      est_alpha: EMA factor of the per-bucket tick-latency estimate behind
        :class:`LiveGateway`'s SLO check.
    """

    def __init__(self, space, tables, params: OnAlgoParams, rule: StepRule,
                 num_devices: int, *, topology: Optional[Topology] = None,
                 buckets=None, mesh=None, device_axis: str = "data",
                 enforce_slot_capacity: bool = True,
                 est_alpha: float = 0.25):
        self.device = params.B.device
        dev = self.device
        self.space = space
        self.tables = tuple(t.to(dev) for t in tables)
        self.params = params
        self.rule = rule
        self.N = int(num_devices)
        self.M = int(self.tables[0].shape[-1])
        self.enforce_slot_capacity = bool(enforce_slot_capacity)
        self.buckets = WaveBuckets(tuple(buckets) if buckets is not None
                                   else default_buckets(self.N))
        if self.buckets.buckets[-1] < self.N:
            raise ValueError("largest bucket must cover the fleet "
                             f"({self.buckets.buckets[-1]} < N={self.N})")
        # this rank's devices: all of them, or its shard of the mesh axis
        self._shards = None
        self._cols = slice(0, self.N)
        self._tables_l, self._params_l = self.tables, params
        if mesh is not None:
            self._shards = shards_of(mesh, device_axis, dev)
            _validate_shards(self.N, self._shards, device_axis)
            self._cols = self._shards.cols(self.N)
            self._tables_l, self._params_l = _shard_inputs(
                self._shards, self.N, self.tables, params)
        if topology is not None:
            if topology.assoc.shape[-1] != self.N:
                raise ValueError(
                    f"topology association covers {topology.assoc.shape[-1]}"
                    f" devices, gateway serves N={self.N}")
            # full validation (H_k shape, id range) at construction — the
            # tick would otherwise silently drop out-of-range load
            validate_topology(topology, 0, self.N)
            topology = topology.to(dev)
        self.topology = topology
        self._topo_k = (topology if topology is not None and topology.K > 1
                        else None)
        # the single-slot kernel (K3) on the card for a scalar dual; the
        # plain route on the CPU and for K-vector duals
        self._use_kernel = dev.type == "cuda" and self._topo_k is None
        self._assoc_blk = None
        self._assoc_b0 = -1
        self.slots = 0  # host-side slot counter (== state.rho.t)
        self.stats = GatewayCoreStats()
        # Two-component latency model, per bucket: dispatch (host pad +
        # enqueue, measured sync-free inside tick_async) and resolve
        # (device execution + transfer, measured as the *marginal* busy
        # time when pending ticks are resolved in dispatch order).
        self._est_dispatch_ms: dict = {}
        self._est_resolve_ms: dict = {}
        self._est_alpha = float(est_alpha)
        self._last_resolved_at = float("-inf")
        self._state = self._fresh_state()

    def _fresh_state(self):
        """Zero duals and counts of this rank's devices; the counts
        advance in place (:class:`_RhoInPlace`)."""
        state = onalgo.init_state(
            self._cols.stop - self._cols.start, self.M,
            K=None if self._topo_k is None else self.topology.K,
            device=self.device)
        state.rho = _RhoInPlace(counts=state.rho.counts, t=0)
        return state

    @classmethod
    def for_service(cls, service, **kw) -> "GatewayCore":
        """Build a core from a ``CompiledService`` / ``StreamingService``
        (both carry space/tables/params/rule + the fleet size); the core
        runs on the service's device."""
        return cls(service.space, service.tables, service.params,
                   service.rule, service.sim.num_devices, **kw)

    @classmethod
    def for_sim(cls, sim, pool, *, gain_source=None, device=None,
                **kw) -> "GatewayCore":
        """Build a core straight from (SimConfig, pool) under any
        :class:`~repro_torch.gain.GainSource`, on ``device`` (None ->
        cuda) — the gateway analogue of
        ``simulate_service(gain_source=...)``.  The source resolves once,
        at compile, into the space/tables the tick consumes; table and
        overlay sources keep the decision stream equal to the batch
        engines' replay."""
        from repro_torch.serve.compile import compile_service_streaming
        service = compile_service_streaming(sim, pool,
                                            gain_source=gain_source,
                                            device=device)
        return cls.for_service(service, **kw)

    # ------------------------------------------------------------------
    def _tick(self, state, wave: torch.Tensor, bucket: int, assoc, H_k):
        """One slot on the device: ``wave`` (4, bucket) int32, rows idx
        and the float32 bits of o, h, w; pads carry idx = N.  Returns
        (new state, offload (bucket,), admitted (bucket,))."""
        N, dev = self.N, self.device
        idx = wave[0].long()
        vals = wave[1:].view(torch.float32)
        # scatter into (N + 1,) buffers: the pads land in the extra slot,
        # which is cut off (the reference's mode="drop")
        full = torch.zeros((3, N + 1), dtype=torch.float32, device=dev)
        full[:, idx] = vals
        # index_fill_ takes the value as a kernel argument (``task[idx] =
        # True`` copies a host scalar up, which waits for the card)
        task = torch.zeros((N + 1,), dtype=torch.bool,
                           device=dev).index_fill_(0, idx, True)
        o_f, h_f, w_f = full[0, :N], full[1, :N], full[2, :N]
        task = task[:N]
        # this rank's devices step; non-reporting ones quantize to j = 0,
        # as a False arrival
        c = self._cols
        j = quantize_states_device(self.space, o_f[c], h_f[c], w_f[c],
                                   task[c])
        kw = dict(use_kernel=self._use_kernel)
        if self._topo_k is not None:
            kw = dict(assoc=assoc[c], H_k=H_k)
        new, off = onalgo.step(
            state, j, o_f[c], h_f[c], w_f[c], task[c], self._tables_l,
            self._params_l, self.rule, **kw,
            axis_name=None if self._shards is None else self._shards.group)
        if self._shards is not None:  # every rank decides for the fleet
            off = gather_cols(off, self._shards)
        # the persistent duals take the slot's values in place (the counts
        # already advanced there); the next tick, on the same stream,
        # reads them after these writes
        state.lam.copy_(new.lam)
        state.mu.copy_(new.mu)
        state.rho = new.rho
        if not self.enforce_slot_capacity:
            adm = off
        elif self.topology is not None:
            adm = bl.admit_by_capacity_topo(off, h_f, assoc, H_k)
        else:
            adm = bl.admit_by_capacity(off, h_f, self.params.H)
        # gather the wave's decisions back (pads clamp to device N - 1 and
        # are cut off on the host: the reference's mode="clip")
        at = idx.clamp_max(N - 1)
        return state, off[at], adm[at]

    def _slot_assoc(self):
        """(assoc, H_k) device args for the current slot (None without a
        topology; a time-varying map is indexed by the slot counter)."""
        topo = self.topology
        if topo is None:
            return None, None
        if topo.time_varying:
            horizon = topo.assoc.shape[0]
            if self.slots >= horizon:
                raise ValueError(
                    f"time-varying association covers {horizon} slots, "
                    f"gateway is at slot {self.slots}")
            if topo.streaming:
                from repro_torch.workload.streams import ROW_BLOCK
                b0 = self.slots // ROW_BLOCK
                if b0 != self._assoc_b0:
                    L = min(ROW_BLOCK, horizon - b0 * ROW_BLOCK)
                    self._assoc_blk = topo.assoc.slab(b0 * ROW_BLOCK, L)
                    self._assoc_b0 = b0
                return (self._assoc_blk[self.slots - b0 * ROW_BLOCK],
                        topo.H_k)
            return topo.assoc[self.slots], topo.H_k
        return topo.assoc, topo.H_k

    def _upload(self, idx, o, h, w, bucket: int) -> torch.Tensor:
        """The padded wave as one (4, bucket) int32 tensor on the device:
        staged in pinned host memory and copied up without waiting
        (PyTorch's host allocator keeps the staging block until the copy
        has run)."""
        on_card = self.device.type == "cuda"
        host = torch.empty((4, bucket), dtype=torch.int32,
                           pin_memory=on_card)
        buf = host.numpy()
        R = idx.shape[0]
        buf[0, :R] = idx
        buf[0, R:] = self.N
        vals = buf[1:].view(np.float32)
        vals[:, R:] = 0.0
        for row, x in enumerate((o, h, w)):
            vals[row, :R] = np.asarray(x, np.float32).reshape(-1)
        return host.to(self.device, non_blocking=True)

    # ------------------------------------------------------------------
    def tick_async(self, idx, o, h, w) -> "PendingTick":
        """Dispatch one OnAlgo slot WITHOUT waiting for its decisions.

        Same wave contract as :meth:`tick`.  On the card this enqueues the
        wave's upload, the slot and the decisions' copy into pinned host
        buffers, records an event and returns: nothing here waits for the
        device.  The persistent state advances at dispatch; the next
        tick, on the same stream, reads it after this one's writes.

        The host-side dispatch cost feeds the per-bucket *dispatch* EMA on
        warm ticks; the *resolve* EMA is fed only by
        :meth:`resolve_timed` / :meth:`tick`.  On the CPU the slot runs
        inside this call, so the dispatch EMA carries the execution and
        the resolve EMA only the copy: the two still sum to the wall time.
        """
        t_start = time.perf_counter()
        idx = np.asarray(idx, np.int32).reshape(-1)
        R = idx.shape[0]
        if R > self.N:
            raise ValueError(f"wave of {R} reports exceeds fleet N={self.N}")
        bucket = self.buckets.bucket_len(R)
        assoc, H_k = self._slot_assoc()
        wave = self._upload(idx, o, h, w, bucket)
        self._state, off, adm = self._tick(self._state, wave, bucket,
                                           assoc, H_k)
        on_card = self.device.type == "cuda"
        out = torch.empty((2, bucket), dtype=torch.bool,
                          pin_memory=on_card)
        out.copy_(torch.stack([off, adm]), non_blocking=on_card)
        ready = None
        if on_card:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        first = bucket not in self.stats.compiled_buckets
        self.stats.compiled_buckets.add(bucket)
        self.slots += 1
        self.stats.ticks += 1
        self.stats.reports += R
        dispatched_at = time.perf_counter()
        if not first:
            self._ema(self._est_dispatch_ms, bucket,
                      (dispatched_at - t_start) * 1e3)
        return PendingTick(off_p=out[0], adm_p=out[1], n_reports=R,
                           bucket=bucket, first_compile=first,
                           dispatched_at=dispatched_at, ready=ready)

    def resolve_timed(self, pending: PendingTick
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Materialize a pending tick's decisions and feed the per-bucket
        *resolve* EMA (warm ticks only).

        The resolve component is the tick's MARGINAL device busy time: from
        the later of its dispatch and the previous resolve's completion, to
        its own completion, so each pipelined wave is charged its own
        execution, not the queue wait behind earlier waves.  FIFO
        contract: resolve pending ticks in dispatch order.
        """
        off, adm = pending.resolve()
        done = time.perf_counter()
        start = max(pending.dispatched_at, self._last_resolved_at)
        self._last_resolved_at = done
        if not pending.first_compile:
            self._ema(self._est_resolve_ms, pending.bucket,
                      (done - start) * 1e3)
        return off, adm

    def tick(self, idx, o, h, w) -> Tuple[np.ndarray, np.ndarray]:
        """One OnAlgo slot over a wave of device reports.

        idx: (R,) int32 device ids (each at most once); o/h/w: (R,)
        float32 raw observed values.  R = 0 is a valid (empty) slot — rho
        and the duals still advance, like a no-arrival slot in the batch
        replay.  Returns (offload, admitted) bool arrays aligned with
        ``idx``; waits for the decisions and feeds both latency EMAs.
        """
        return self.resolve_timed(self.tick_async(idx, o, h, w))

    # ------------------------------------------------------------------
    def _ema(self, table: dict, bucket: int, dt_ms: float) -> None:
        prev = table.get(bucket)
        table[bucket] = (dt_ms if prev is None else
                         prev + self._est_alpha * (dt_ms - prev))

    def _bucket_est(self, table: dict, bucket: int) -> float:
        """Bucket's EMA; conservative fallback to the worst known bucket;
        0 when nothing is known yet."""
        est = table.get(bucket)
        if est is not None:
            return est
        return max(table.values(), default=0.0)

    def bucket_len(self, n_reports: int) -> int:
        return self.buckets.bucket_len(n_reports)

    def estimate_ms(self, n_reports: int,
                    in_flight_ms: float = 0.0) -> float:
        """Estimated arrival-to-decisions wall time for a wave of
        ``n_reports`` dispatched now: its dispatch estimate + its resolve
        estimate + ``in_flight_ms`` of device work already dispatched
        ahead of it."""
        bucket = self.buckets.bucket_len(n_reports)
        return (self._bucket_est(self._est_dispatch_ms, bucket)
                + self._bucket_est(self._est_resolve_ms, bucket)
                + float(in_flight_ms))

    def estimate_resolve_ms(self, n_reports: int) -> float:
        """The resolve (device) component alone — what a wave queued
        behind this one will wait on."""
        return self._bucket_est(self._est_resolve_ms,
                                self.buckets.bucket_len(n_reports))

    def seed_estimate(self, n_reports: int, ms: float,
                      dispatch_ms: float = 0.0) -> None:
        """Preset the latency estimate for a bucket (operational
        warm-start, or fault injection in the SLO tests).  ``ms`` seeds
        the resolve component; the dispatch component defaults to 0 so
        ``estimate_ms`` returns ``ms`` exactly."""
        bucket = self.buckets.bucket_len(n_reports)
        self._est_resolve_ms[bucket] = float(ms)
        self._est_dispatch_ms[bucket] = float(dispatch_ms)

    def seed_from_trajectory(self, path, config: Optional[str] = None
                             ) -> float:
        """Bulk :meth:`seed_estimate`: warm-start every bucket's resolve
        EMA from a JSON list of trajectory rows (``{"bench": "gateway",
        "config": "N<n>...", "p50_ms": ...}``), so a cold gateway does not
        serve its first waves with ``estimate_ms == 0``.

        Picks the latest gateway row whose fleet size (``N<n>`` in its
        config) is nearest to this core's N — or exactly ``config`` — and
        seeds its ``p50_ms`` into every bucket with no live estimate yet
        (measured EMAs are never clobbered).  Returns the seeded ms.
        """
        with open(path) as f:
            rows = json.load(f)
        rows = [r for r in rows if r.get("bench") == "gateway"
                and r.get("p50_ms") is not None]
        if config is not None:
            rows = [r for r in rows if r.get("config") == config]
        else:
            sized = []
            for r in rows:
                m = re.match(r"N(\d+)", r.get("config", ""))
                if m:
                    sized.append((abs(np.log(int(m.group(1)) / self.N)), r))
            if sized:
                best = min(d for d, _ in sized)
                rows = [r for d, r in sized if d == best]
        if not rows:
            raise ValueError(f"no gateway row with a p50_ms in {path!r}"
                             + (f" for config {config!r}" if config
                                else ""))
        ms = float(rows[-1]["p50_ms"])  # the trajectory's newest point
        for bucket in self.buckets.buckets:
            self._est_resolve_ms.setdefault(bucket, ms)
        return ms

    def warmup(self, n_reports=None, buckets=None, *,
               background: bool = False):
        """Take first-call costs off the serve path.

        Runs one all-pad tick per target bucket against a THROWAWAY state:
        on a fresh machine the first builds the single-slot kernel's
        library (K3), and every bucket's shapes go through the allocator
        once.  The core's state, slot counter and latency EMAs are
        untouched, but the buckets are marked warm, so the first real wave
        per bucket votes in the EMAs and no build stall masquerades as an
        SLO violation.

        ``n_reports`` (an int or iterable of expected wave sizes) or
        ``buckets`` (explicit sizes) narrow the target set; default is the
        whole ladder.  ``background=True`` runs in a daemon thread and
        returns it; otherwise returns the list of bucket sizes warmed.
        """
        if n_reports is not None and buckets is not None:
            raise ValueError("pass n_reports or buckets, not both")
        if background:
            th = threading.Thread(
                target=self.warmup, daemon=True,
                kwargs=dict(n_reports=n_reports, buckets=buckets))
            th.start()
            return th
        sizes = (self.buckets.buckets if n_reports is None
                 and buckets is None else
                 np.atleast_1d(n_reports if buckets is None else buckets))
        targets = sorted({self.buckets.bucket_len(int(s)) for s in sizes})
        if not targets:
            return targets
        state = self._fresh_state()
        assoc, H_k = self._slot_assoc()
        empty = np.zeros((0,), np.float32)
        for bucket in targets:
            wave = self._upload(np.zeros((0,), np.int32), empty, empty,
                                empty, bucket)
            state, _, _ = self._tick(state, wave, bucket, assoc, H_k)
            self.stats.compiled_buckets.add(bucket)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return targets

    @property
    def mu(self) -> np.ndarray:
        """Current capacity dual(s) — () scalar or (K,). Waits."""
        return self._state.mu.cpu().numpy()

    @property
    def state(self):
        """The persistent OnAlgoState (duals + rho); on a mesh, this
        rank's shard (its N/S devices' lam and counts).  Treat as
        read-only: the next tick updates its tensors in place."""
        return self._state


# ----------------------------------------------------------------------
#  Async host loop
# ----------------------------------------------------------------------

@dataclasses.dataclass
class WaveReply:
    """Per-chunk decision reply.

    ``fallback`` marks graceful degradation: the chunk was answered with
    local execution (offload nobody) because the queue was full or the
    wave would have missed its latency deadline; ``t`` is then -1 and no
    algorithm state was touched.
    """

    t: int  # gateway slot that decided this chunk (-1: fallback)
    offload: np.ndarray
    admitted: np.ndarray
    fallback: bool
    latency_ms: float


class LatencyReservoir:
    """Fixed-size uniform sample of a latency stream (Vitter's Algorithm
    R): O(capacity) memory however long the soak, every appended value
    equally likely to be retained.  Deterministically seeded; ``len()`` is
    the TOTAL number of latencies recorded, not the sample size.
    """

    __slots__ = ("capacity", "count", "_size", "_buf", "_rng")

    def __init__(self, capacity: int = 4096, seed: int = 0x5EED):
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        self.capacity = int(capacity)
        self.count = 0  # total appended
        self._size = 0  # retained (== min(count, capacity))
        self._buf = np.empty((self.capacity,), np.float64)
        self._rng = np.random.RandomState(seed)

    def append(self, ms: float) -> None:
        if self._size < self.capacity:
            self._buf[self._size] = ms
            self._size += 1
        else:
            j = self._rng.randint(0, self.count + 1)
            if j < self.capacity:
                self._buf[j] = ms
        self.count += 1

    def __len__(self) -> int:
        return self.count

    def __bool__(self) -> bool:
        return self.count > 0

    def sample(self) -> np.ndarray:
        """The retained sample (a copy)."""
        return self._buf[: self._size].copy()

    def percentile(self, q: float) -> float:
        if not self._size:
            return float("nan")
        return float(np.percentile(self._buf[: self._size], q))


@dataclasses.dataclass
class GatewayStats:
    waves: int = 0
    chunks: int = 0
    reports: int = 0
    fallback_waves: int = 0
    shed_chunks: int = 0
    max_queue_seen: int = 0
    # pipeline occupancy, sampled at dispatch entry: the deepest
    # dispatch-to-resolve backlog seen, and how many waves entered
    # dispatch while an earlier wave was still unresolved
    max_in_flight_seen: int = 0
    overlapped_waves: int = 0
    latencies_ms: LatencyReservoir = dataclasses.field(
        default_factory=LatencyReservoir)

    def percentile(self, q: float) -> float:
        return self.latencies_ms.percentile(q)

    def summary(self) -> dict:
        return {
            "waves": self.waves,
            "chunks": self.chunks,
            "reports": self.reports,
            "fallback_waves": self.fallback_waves,
            "shed_chunks": self.shed_chunks,
            "max_queue_seen": self.max_queue_seen,
            "max_in_flight_seen": self.max_in_flight_seen,
            "overlapped_waves": self.overlapped_waves,
            "latency_count": len(self.latencies_ms),
            "p50_ms": self.percentile(50.0),
            "p99_ms": self.percentile(99.0),
        }


class _Chunk:
    __slots__ = ("idx", "o", "h", "w", "fut", "t_arrival")

    def __init__(self, idx, o, h, w, fut, t_arrival):
        self.idx, self.o, self.h, self.w = idx, o, h, w
        self.fut, self.t_arrival = fut, t_arrival


class _InFlight:
    """One dispatched wave riding the pipeline, awaiting resolution."""

    __slots__ = ("pending", "chunks", "n", "slot", "resolve_est_ms")

    def __init__(self, pending, chunks, n, slot, resolve_est_ms):
        self.pending, self.chunks, self.n = pending, chunks, n
        self.slot, self.resolve_est_ms = slot, resolve_est_ms


class LiveGateway:
    """Async serving loop around a :class:`GatewayCore` — a depth-bounded
    wave pipeline.

    Submitted chunks queue (bounded by ``max_queue``); the dispatcher
    drains queued chunks into one wave — one OnAlgo slot — dispatches it
    via :meth:`GatewayCore.tick_async`, and goes back to forming the next
    wave while a resolver task materializes in-flight decisions in
    dispatch order and completes each chunk's future with its slice.  At
    most ``max_in_flight`` waves sit between dispatch and resolution
    (default 2; ``1`` is the strictly sequential loop).  Dispatch order
    is the slot order, so the decision stream is the same at every depth.

    SLO semantics: if the latency estimate — dispatch + the resolve
    backlog already in flight + the wave's own resolve — says the wave
    would finish past ``earliest_arrival + slo_ms``, every chunk in it
    gets a local-execution fallback reply instead of being dispatched;
    a full queue sheds new chunks the same way at submit time.

    ``coalesce=False`` disables micro-batch merging — every chunk is its
    own wave/slot: the closed-loop replay contract, so a pipelined run
    over one-chunk-per-slot submissions equals the batch engines at any
    depth.

    Use as ``async with LiveGateway(core) as gw: ...`` or call
    :meth:`start` / :meth:`stop` explicitly.
    """

    def __init__(self, core: GatewayCore, *, slo_ms: float = 50.0,
                 max_queue: int = 64, max_wave: Optional[int] = None,
                 max_in_flight: int = 2, coalesce: bool = True,
                 clock=time.monotonic):
        if max_in_flight < 1:
            raise ValueError(f"max_in_flight must be >= 1, "
                             f"got {max_in_flight}")
        self.core = core
        self.slo_ms = float(slo_ms)
        self.max_queue = int(max_queue)
        self.max_wave = int(max_wave) if max_wave is not None else core.N
        self.max_in_flight = int(max_in_flight)
        self.coalesce = bool(coalesce)
        self.stats = GatewayStats()
        self._clock = clock
        self._chunks: deque = deque()
        self._in_flight: deque = deque()
        self._wakeup: Optional[asyncio.Event] = None
        self._pipe: Optional[asyncio.Queue] = None
        self._slots_free: Optional[asyncio.Semaphore] = None
        self._task = None
        self._resolver = None
        self._closing = False

    async def __aenter__(self) -> "LiveGateway":
        self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    def start(self) -> None:
        if self._task is not None:
            raise RuntimeError("gateway already started")
        self._closing = False
        self._wakeup = asyncio.Event()
        self._pipe = asyncio.Queue()
        self._slots_free = asyncio.Semaphore(self.max_in_flight)
        loop = asyncio.get_running_loop()
        self._resolver = loop.create_task(self._resolve_loop())
        self._task = loop.create_task(self._serve())

    async def stop(self) -> None:
        """Drain the queue and the in-flight pipe, then stop."""
        self._closing = True
        self._wakeup.set()
        await self._task
        self._pipe.put_nowait(None)  # after the last dispatched wave
        await self._resolver
        self._task = self._resolver = None

    def _fallback_reply(self, n: int, t_arrival: float) -> WaveReply:
        zeros = np.zeros((n,), bool)
        return WaveReply(t=-1, offload=zeros, admitted=zeros.copy(),
                         fallback=True,
                         latency_ms=(self._clock() - t_arrival) * 1e3)

    async def submit(self, idx, o, h, w) -> WaveReply:
        """Submit one chunk of device reports; resolves with its slice of
        the wave's decisions (or a fallback reply under overload).  An
        empty chunk is valid and still drives a slot tick."""
        if self._task is None:
            raise RuntimeError("gateway not started")
        now = self._clock()
        if len(self._chunks) >= self.max_queue:
            self.stats.shed_chunks += 1
            return self._fallback_reply(len(np.atleast_1d(idx)), now)
        fut = asyncio.get_running_loop().create_future()
        self._chunks.append(_Chunk(np.asarray(idx, np.int32).reshape(-1),
                                   o, h, w, fut, now))
        self.stats.max_queue_seen = max(self.stats.max_queue_seen,
                                        len(self._chunks))
        self._wakeup.set()
        return await fut

    async def _serve(self) -> None:
        """Dispatcher half of the pipeline: drain -> SLO check ->
        dispatch.  Never waits on a wave's decisions — only on a free
        pipe slot."""
        loop = asyncio.get_running_loop()
        while True:
            if not self._chunks:
                if self._closing:
                    return
                self._wakeup.clear()
                if self._chunks or self._closing:
                    continue  # raced with submit()/stop()
                await self._wakeup.wait()
                continue
            # depth bound: wait until fewer than max_in_flight waves sit
            # between dispatch and resolution (chunks arriving meanwhile
            # coalesce into a bigger wave below)
            await self._slots_free.acquire()
            wave = [self._chunks.popleft()]
            n = wave[0].idx.shape[0]
            if self.coalesce:
                while (self._chunks and
                       n + self._chunks[0].idx.shape[0] <= self.max_wave):
                    c = self._chunks.popleft()
                    wave.append(c)
                    n += c.idx.shape[0]
            earliest = min(c.t_arrival for c in wave)
            backlog_ms = sum(r.resolve_est_ms for r in self._in_flight)
            est_s = self.core.estimate_ms(n, in_flight_ms=backlog_ms) / 1e3
            if self._clock() + est_s > earliest + self.slo_ms / 1e3:
                # fallback BEFORE dispatch: the algorithm state is
                # untouched even with waves queued behind this one
                for c in wave:
                    c.fut.set_result(
                        self._fallback_reply(c.idx.shape[0], c.t_arrival))
                self.stats.fallback_waves += 1
                self.stats.chunks += len(wave)
                self._slots_free.release()  # nothing entered the pipe
                continue
            idx = np.concatenate([c.idx for c in wave])
            o = np.concatenate([np.asarray(c.o, np.float32).reshape(-1)
                                for c in wave])
            h = np.concatenate([np.asarray(c.h, np.float32).reshape(-1)
                                for c in wave])
            w = np.concatenate([np.asarray(c.w, np.float32).reshape(-1)
                                for c in wave])
            slot = self.core.slots
            # occupancy is sampled at dispatch ENTRY (on the CPU the tick
            # runs inside the dispatch, and its predecessor may resolve
            # meanwhile)
            depth = len(self._in_flight) + 1
            self.stats.max_in_flight_seen = max(
                self.stats.max_in_flight_seen, depth)
            if depth > 1:
                self.stats.overlapped_waves += 1
            # dispatch in the default executor so submitters keep
            # enqueueing (that forms the next micro-batch); the await also
            # serializes dispatches, which keeps the state in slot order
            pending = await loop.run_in_executor(
                None, self.core.tick_async, idx, o, h, w)
            rec = _InFlight(pending, wave, n, slot,
                            self.core.estimate_resolve_ms(n))
            self._in_flight.append(rec)
            self._pipe.put_nowait(rec)

    async def _resolve_loop(self) -> None:
        """Resolver half: materialize in-flight waves in dispatch order
        and complete their chunk futures, concurrently with the
        dispatcher."""
        loop = asyncio.get_running_loop()
        while True:
            rec = await self._pipe.get()
            if rec is None:
                return
            off, adm = await loop.run_in_executor(
                None, self.core.resolve_timed, rec.pending)
            self._in_flight.popleft()  # rec — the pipe is FIFO
            self._slots_free.release()
            done = self._clock()
            self.stats.waves += 1
            self.stats.chunks += len(rec.chunks)
            self.stats.reports += int(rec.n)
            lo = 0
            for c in rec.chunks:
                hi = lo + c.idx.shape[0]
                lat = (done - c.t_arrival) * 1e3
                self.stats.latencies_ms.append(lat)
                c.fut.set_result(WaveReply(
                    t=rec.slot, offload=off[lo:hi], admitted=adm[lo:hi],
                    fallback=False, latency_ms=lat))
                lo = hi


async def drive_closed_loop(gateway: LiveGateway, loadgen, t0: int = 0,
                            slots: Optional[int] = None) -> list:
    """Closed-loop driver: submit one workload slot's wave, await its
    decisions, advance — each gateway wave is exactly one workload slot,
    so the decision stream replays ``fleet.simulate`` bit for bit."""
    replies = []
    for wv in loadgen.waves(t0, slots):
        replies.append(await gateway.submit(wv.idx, wv.o, wv.h, wv.w))
    return replies


def run_closed_loop(core: GatewayCore, loadgen, t0: int = 0,
                    slots: Optional[int] = None, warmup: bool = False,
                    **gateway_kw):
    """Sync wrapper: serve a closed-loop replay of ``loadgen`` through a
    fresh :class:`LiveGateway`; returns (replies, stats).  ``warmup=True``
    runs :meth:`GatewayCore.warmup` before the loop starts."""
    if warmup:
        core.warmup()

    async def _run():
        async with LiveGateway(core, **gateway_kw) as gw:
            replies = await drive_closed_loop(gw, loadgen, t0, slots)
            return replies, gw.stats

    return asyncio.run(_run())


async def drive_pipelined_loop(gateway: LiveGateway, loadgen,
                               t0: int = 0,
                               slots: Optional[int] = None,
                               window: Optional[int] = None) -> list:
    """Pipelined driver: keep up to ``window`` slot-waves outstanding
    (submitted, decisions not yet returned) instead of awaiting each
    reply — the submission pattern that fills the gateway's pipeline.
    ``window`` defaults to the gateway's ``max_in_flight`` + 1.  With a
    ``coalesce=False`` gateway each wave is exactly one workload slot, so
    the decision stream replays ``fleet.simulate`` bit for bit at any
    depth.  Returns replies in slot order.
    """
    loop = asyncio.get_running_loop()
    window = (gateway.max_in_flight + 1 if window is None
              else int(window))
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    gate = asyncio.Semaphore(window)
    replies: dict = {}
    tasks = []

    async def _one(i, wv):
        try:
            replies[i] = await gateway.submit(wv.idx, wv.o, wv.h, wv.w)
        finally:
            gate.release()

    for i, wv in enumerate(loadgen.waves(t0, slots)):
        await gate.acquire()
        tasks.append(loop.create_task(_one(i, wv)))
    await asyncio.gather(*tasks)
    return [replies[i] for i in range(len(tasks))]


def run_pipelined_loop(core: GatewayCore, loadgen, t0: int = 0,
                       slots: Optional[int] = None,
                       window: Optional[int] = None,
                       warmup: bool = False, **gateway_kw):
    """Sync wrapper around :func:`drive_pipelined_loop`; returns
    (replies, stats).  The gateway defaults to ``coalesce=False`` (each
    wave one workload slot: the replay contract)."""
    gateway_kw.setdefault("coalesce", False)
    if warmup:
        core.warmup()

    async def _run():
        async with LiveGateway(core, **gateway_kw) as gw:
            replies = await drive_pipelined_loop(gw, loadgen, t0, slots,
                                                 window)
            return replies, gw.stats

    return asyncio.run(_run())


async def drive_open_loop(gateway: LiveGateway, loadgen, rate_hz: float,
                          t0: int = 0,
                          slots: Optional[int] = None) -> list:
    """Open-loop driver: submit one workload slot's wave every
    ``1 / rate_hz`` seconds WITHOUT awaiting the previous decision.
    Below saturation this behaves like the closed loop with idle gaps;
    past it the queue grows, slot-waves merge into bigger micro-batches,
    and the SLO machinery sheds load.  Returns replies in submission
    order.
    """
    loop = asyncio.get_running_loop()
    period = 1.0 / float(rate_hz)
    tasks = []
    next_t = loop.time()
    for wv in loadgen.waves(t0, slots):
        now = loop.time()
        if now < next_t:
            await asyncio.sleep(next_t - now)
        next_t += period
        tasks.append(asyncio.ensure_future(
            gateway.submit(wv.idx, wv.o, wv.h, wv.w)))
    return list(await asyncio.gather(*tasks))


def run_open_loop(core: GatewayCore, loadgen, rate_hz: float, t0: int = 0,
                  slots: Optional[int] = None, warmup: bool = False,
                  **gateway_kw):
    """Sync wrapper around :func:`drive_open_loop`; returns (replies,
    stats)."""
    if warmup:
        core.warmup()

    async def _run():
        async with LiveGateway(core, **gateway_kw) as gw:
            replies = await drive_open_loop(gw, loadgen, rate_hz, t0,
                                            slots)
            return replies, gw.stats

    return asyncio.run(_run())
