"""Compile the end-to-end service simulation to the core fleet contract.

Port of the materialized lowering of ``repro/serve/compile.py``: a
``(SimConfig, PrecomputedPool)`` pair becomes the ``(Trace, tables,
params)`` contract of the fleet engines plus a ``RawOverlay`` of raw
per-slot values, all on one device:

  * the image stream, Markov channel and bursty arrivals come from the
    workload layer (``repro_torch.workload``), bit-identical to the JAX
    package's v1 counter-based draws;
  * raw (o, h, w) values are quantized into the pool-calibrated state
    space => the (T, N) ``Trace``;
  * raw values and each sampled image's local/cloudlet correctness ride
    in the overlay (decisions and accounting use them; rho uses the
    quantized index).

At fleet scale the (T, N) arrays themselves are the ceiling:
``compile_service_streaming`` lowers the same run to a
:class:`StreamingService` whose ``slab(t0, L)`` produces any horizon
slab, trace and overlay, bit-identical to the materialized arrays, from
O(L * N) work, for ``fleet.simulate_chunked_stream``.

Runs eagerly (no jit): the workload draws are one call of the draws
kernel (``kernels/draws.py``) in both lowerings, the value lowering (the
gathers and the quantization) one call of the lower_values kernel
(``kernels/lower_values.py``) through per-rate and per-image records
that its ``value_tables`` resolves once per compile.  A ``gain_source``
(``repro_torch.gain``) resolves once per compile into the (phi_hat,
sigma) tables behind the value lowering and the state space calibrated
to them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.fleet import RawOverlay, Trace
from repro_torch.core.onalgo import OnAlgoParams, StepRule
from repro_torch.core.state_space import StateSpace
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.lower_values import ValueTables, value_tables
from repro_torch.workload import (StreamingWorkload,
                                  generate_service_workload,
                                  lower_service_workload,
                                  validate_rng_version)

@dataclasses.dataclass
class CompiledService:
    """A service run lowered to the fleet-engine contract, on one device.

    ``trace`` / ``tables`` / ``params`` / ``overlay`` feed
    ``fleet.simulate(..., overlay=...)`` or ``fleet.simulate_chunked``
    verbatim; ``space`` is the calibrated state space behind
    ``trace.j_idx``; ``on`` is the realized (T, N) arrival matrix.
    """

    sim: "SimConfig"  # noqa: F821 — defined in simulator.py
    space: StateSpace
    trace: Trace
    tables: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    params: OnAlgoParams
    overlay: RawOverlay
    on: np.ndarray
    gain_source: object = None

    @property
    def rule(self) -> StepRule:
        return StepRule.inv_sqrt(self.sim.step_a)

    def simulate_args(self):
        """Positional args for ``fleet.simulate(trace, tables, params, ...)``."""
        return self.trace, self.tables, self.params


@obs.spanned("quantize")
def _lower_values(wl, values: ValueTables, on_override):
    """The value lowering of a realized workload through the compile's
    tables (``ops.lower_values``: one kernel on the card, the eager
    per-element gathers and quantization on the CPU).

    Returns (on, j_idx, o, h, w, correct_local, correct_cloud, d_local);
    ``on_override`` replaces the generated arrivals when not None."""
    on = wl.on if on_override is None else on_override
    return (on, *ops.lower_values(on, wl.img, wl.rates, values))


def _compile_v1(seed, T, N, pool_size, num_rates, burst_len, mean_gap,
                values, on_override, *, device):
    """The whole v1 lowering: counter-based workload generation, then the
    value lowering, on ``device``."""
    wl = generate_service_workload(seed, T, N, pool_size, num_rates,
                                   burst_len, mean_gap, device=device)
    return _lower_values(wl, values, on_override)


@obs.spanned("inputs")
def _service_inputs(sim, pool, gain_source=None, *, device):
    """Validated contract, calibrated space, the value lowering's
    ``value_tables`` (float32 device pool arrays, the float32 scalar
    knobs v_risk and zeta penalty, and their records), params and the
    number of rates.

    ``gain_source`` (a :class:`~repro_torch.gain.GainSource`, a name, or
    None for the pool's own tables) picks the per-image (phi_hat, sigma)
    tables of the value lowering and the state space calibrated to them,
    resolved once here on ``device``; cycles, correctness and d_local
    always come from the pool.  None resolves through ``TableGain()``,
    the pool's own float32 tables."""
    from repro_torch.gain.source import as_gain_source
    from repro_torch.serve.simulator import RATES, power_of_rate

    validate_rng_version(sim.rng_version)
    f32 = lambda x: obs.upload(x, device, torch.float32)
    gt, space = as_gain_source(gain_source).resolve(pool, sim, device=device)
    phi = gt.phi_hat.to(device=device, dtype=torch.float32)
    sig = gt.sigma.to(device=device, dtype=torch.float32)
    S = len(pool.phi_hat)
    if tuple(phi.shape) != (S,) or tuple(sig.shape) != (S,):
        raise ValueError(
            f"gain source resolved tables of shape {tuple(phi.shape)}/"
            f"{tuple(sig.shape)}; pool has ({S},) images")
    arrays = (f32(power_of_rate(RATES)), f32(pool.cycles), phi, sig,
              f32(pool.d_local), f32(pool.local_correct),
              f32(pool.cloud_correct))
    params = OnAlgoParams(
        B=torch.full((sim.num_devices,), float(np.float32(sim.B_n)),
                     dtype=torch.float32, device=device),
        H=f32(np.float32(sim.H)))
    knobs = (float(np.float32(sim.v_risk)),
             float(np.float32(sim.zeta * (sim.d_tr + sim.d_pr_cloud))))
    return space, value_tables(space, *arrays, *knobs), params, len(RATES)


@obs.spanned("lower")
def compile_service(sim, pool, on: Optional[np.ndarray] = None, *,
                    gain_source=None, device=None) -> CompiledService:
    """Lower (SimConfig, PrecomputedPool) to a :class:`CompiledService` on
    ``device`` (None -> cuda).

    ``on``: optional (T, N) bool arrival matrix overriding the built-in
    bursty traffic.  ``gain_source``: optional
    :class:`~repro_torch.gain.GainSource` (or "table" / "overlay")
    supplying the per-image (phi_hat, sigma) tables (None = the pool's
    own, bit for bit)."""
    dev = resolve_device(device)
    N, T = sim.num_devices, sim.T
    S = len(pool.local_correct)
    space, values, params, num_rates = _service_inputs(
        sim, pool, gain_source, device=dev)

    on_dev = None
    if on is not None:
        on = np.asarray(on, bool)
        if on.shape != (T, N):
            raise ValueError(f"arrival matrix shape {on.shape} != {(T, N)}")
        on_dev = obs.upload(on, dev)

    on_dev, j, o_raw, h_raw, w_raw, c_local, c_cloud, d_loc = _compile_v1(
        sim.seed, T, N, S, num_rates, tuple(sim.burst_len), sim.mean_gap,
        values, on_dev, device=dev)
    trace = Trace(j_idx=j, d_local=d_loc)
    overlay = RawOverlay(o=o_raw, h=h_raw, w=w_raw, correct_local=c_local,
                         correct_cloud=c_cloud)
    tables = space.tables(dev)
    with obs.span("on_copy"):
        obs.host_sync(obs.nbytes(on_dev), "on_copy")
        on_host = on_dev.cpu().numpy()
    return CompiledService(sim=sim, space=space, trace=trace, tables=tables,
                           params=params, overlay=overlay, on=on_host,
                           gain_source=gain_source)


def _slab_pair(lowered):
    _, j, o_raw, h_raw, w_raw, c_local, c_cloud, _ = lowered
    return j, RawOverlay(o=o_raw, h=h_raw, w=w_raw, correct_local=c_local,
                         correct_cloud=c_cloud)


@dataclasses.dataclass
class StreamingService:
    """A service run lowered to slab-addressable (streaming) form.

    Instead of (T, N) trace and overlay arrays it holds the
    :class:`~repro_torch.workload.StreamingWorkload` boundary states and
    the device pool tables; ``slab(t0, L)`` produces the ``(j_idx,
    RawOverlay)`` slab for any [t0, t0 + L), bit-identical to the same
    slices of ``compile_service``'s arrays: the ``source`` contract of
    ``fleet.simulate_chunked_stream``.  Peak memory: O(L * N), never
    O(T * N)."""

    sim: "SimConfig"  # noqa: F821 — defined in simulator.py
    space: StateSpace
    tables: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    params: OnAlgoParams
    wl: StreamingWorkload
    values: ValueTables
    gain_source: object = None

    @property
    def rule(self) -> StepRule:
        return StepRule.inv_sqrt(self.sim.step_a)

    def slab(self, t0: int, length: int):
        """(j_idx (L, N) int32, RawOverlay slab) for [t0, t0 + length):
        one draws call, then the value lowering."""
        return _slab_pair(_lower_values(self.wl.slab(t0, length),
                                        self.values, None))

    def slab_cols(self, t0: int, length: int, n0: int, n_cols: int):
        """Device columns [n0, n0 + n_cols) of ``slab(t0, length)``,
        bit-identical to slicing it, from O(length * n_cols) work (the
        reference's ``source_cols`` contract; the gateway's load generator
        reads it, ``workload.loadgen``)."""
        return _slab_pair(_lower_values(
            self.wl.slab_cols(t0, length, n0, n_cols), self.values, None))


@obs.spanned("lower")
def compile_service_streaming(sim, pool, *, gain_source=None,
                              device=None) -> StreamingService:
    """Lower (SimConfig, PrecomputedPool) to a :class:`StreamingService` on
    ``device`` (None -> cuda).

    The only O(T)-sized work is the boundary pass of the workload lowering
    (one draws call, (ceil(T / 64), N) output); nothing (T, N)-sized is
    built.  Arrival overrides need the materialized path
    (``compile_service``); ``gain_source`` as there."""
    dev = resolve_device(device)
    space, values, params, num_rates = _service_inputs(
        sim, pool, gain_source, device=dev)
    wl = lower_service_workload(sim.seed, sim.T, sim.num_devices,
                                len(pool.local_correct), num_rates,
                                tuple(sim.burst_len), sim.mean_gap,
                                device=dev)
    return StreamingService(sim=sim, space=space, tables=space.tables(dev),
                            params=params, wl=wl, values=values,
                            gain_source=gain_source)


@obs.spanned("fold")
def service_metrics(sim, series) -> dict:
    """Fold fleet-engine series into the service-tier aggregate metrics
    (the reference's keys and float arithmetic, on host copies)."""
    def s(key):  # one read back a key
        x = series[key].detach()
        obs.host_sync(obs.nbytes(x), "fold")
        return x.cpu().numpy()

    tasks_raw = float(np.sum(s("tasks")))
    tasks = max(tasks_raw, 1.0)
    admits = float(np.sum(s("admits")))
    delay = sim.d_pr_dev * tasks_raw + (sim.d_tr + sim.d_pr_cloud) * admits
    mu_seq = s("mu")
    return {
        "accuracy": float(np.sum(s("correct"))) / tasks,
        "offload_frac": float(np.sum(s("offloads"))) / tasks,
        "admit_frac": admits / tasks,
        "avg_power_per_dev": (float(np.sum(s("power")))
                              / (sim.num_devices * sim.T)),
        "avg_load": float(np.sum(s("load"))) / sim.T,
        "avg_delay_ms": 1e3 * delay / tasks,
        "tasks": tasks,
        "mu_final": (float(mu_seq[-1])
                     if sim.algo == "onalgo" and mu_seq.size else 0.0),
    }
