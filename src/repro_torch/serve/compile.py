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
kernel (``kernels/draws.py``) in both lowerings, the gathers and the
quantization plain PyTorch.  A ``gain_source`` (``repro_torch.gain``)
resolves once per compile into the (phi_hat, sigma) tables behind the
value lowering and the state space calibrated to them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.fleet import RawOverlay, Trace
from repro_torch.core.onalgo import (OnAlgoParams, StepRule,
                                     risk_adjusted_gain)
from repro_torch.core.state_space import StateSpace
from repro_torch.device import resolve_device
from repro_torch.serve.admission import level_grid, quantize_states_device
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


def _lower_values(wl, space, on_override, o_levels, cycles, phi_hat,
                  sigma, d_local, corr_local, corr_cloud, v_risk,
                  zeta_pen):
    """Raw-value gathers + quantization for a realized workload.

    Returns (on, j_idx, o, h, w, correct_local, correct_cloud, d_local);
    ``zeta_pen`` is the P3 delay penalty (0 leaves w unchanged);
    ``on_override`` replaces the generated arrivals when not None."""
    on = wl.on if on_override is None else on_override
    img = wl.img.long()
    o_raw = o_levels[wl.rates.long()]
    h_raw = cycles[img]
    w_raw = risk_adjusted_gain(phi_hat[img], sigma[img], v_risk)
    w_raw = torch.clamp(w_raw - zeta_pen, 0.0, 1.0)
    j = quantize_states_device(space, o_raw, h_raw, w_raw, on)
    return (on, j, o_raw, h_raw, w_raw, corr_local[img], corr_cloud[img],
            d_local[img])


def _compile_v1(seed, T, N, pool_size, num_rates, burst_len, mean_gap,
                space, on_override, o_levels, cycles, phi_hat, sigma,
                d_local, corr_local, corr_cloud, v_risk, zeta_pen, *,
                device):
    """The whole v1 lowering: counter-based workload generation, raw-value
    gathers and state quantization, on ``device``."""
    wl = generate_service_workload(seed, T, N, pool_size, num_rates,
                                   burst_len, mean_gap, device=device)
    return _lower_values(wl, space, on_override, o_levels, cycles, phi_hat,
                         sigma, d_local, corr_local, corr_cloud, v_risk,
                         zeta_pen)


def _service_inputs(sim, pool, gain_source=None, *, device):
    """Validated contract, calibrated space, float32 device pool arrays,
    params and the float32 scalar knobs (v_risk, zeta penalty).

    ``gain_source`` (a :class:`~repro_torch.gain.GainSource`, a name, or
    None for the pool's own tables) picks the per-image (phi_hat, sigma)
    tables of the value lowering and the state space calibrated to them,
    resolved once here on ``device``; cycles, correctness and d_local
    always come from the pool.  None resolves through ``TableGain()``,
    the pool's own float32 tables."""
    from repro_torch.gain.source import as_gain_source
    from repro_torch.serve.simulator import RATES, power_of_rate

    validate_rng_version(sim.rng_version)
    f32 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32,
                                 device=device)
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
        H=torch.tensor(float(np.float32(sim.H)), dtype=torch.float32,
                       device=device))
    knobs = (float(np.float32(sim.v_risk)),
             float(np.float32(sim.zeta * (sim.d_tr + sim.d_pr_cloud))))
    return space, arrays, params, knobs, len(RATES)


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
    space, arrays, params, knobs, num_rates = _service_inputs(
        sim, pool, gain_source, device=dev)

    on_dev = None
    if on is not None:
        on = np.asarray(on, bool)
        if on.shape != (T, N):
            raise ValueError(f"arrival matrix shape {on.shape} != {(T, N)}")
        on_dev = torch.from_numpy(on).to(dev)

    on_dev, j, o_raw, h_raw, w_raw, c_local, c_cloud, d_loc = _compile_v1(
        sim.seed, T, N, S, num_rates, tuple(sim.burst_len), sim.mean_gap,
        space, on_dev, *arrays, *knobs, device=dev)
    trace = Trace(j_idx=j, d_local=d_loc)
    overlay = RawOverlay(o=o_raw, h=h_raw, w=w_raw, correct_local=c_local,
                         correct_cloud=c_cloud)
    return CompiledService(sim=sim, space=space, trace=trace,
                           tables=space.tables(dev), params=params,
                           overlay=overlay, on=on_dev.cpu().numpy(),
                           gain_source=gain_source)


def _service_slab(wl: StreamingWorkload, space, t0: int, length: int,
                  o_levels, cycles, phi_hat, sigma, d_local, corr_local,
                  corr_cloud, v_risk, zeta_pen):
    """From counters to a service slab: workload slab (one draws call) ->
    gathers -> quantization, slots [t0, t0 + length)."""
    return _lower_values(wl.slab(t0, length), space, None,
                         o_levels, cycles, phi_hat, sigma, d_local,
                         corr_local, corr_cloud, v_risk, zeta_pen)


def _service_slab_cols(wl: StreamingWorkload, space, t0: int, length: int,
                       n0: int, n_cols: int, o_levels, cycles, phi_hat,
                       sigma, d_local, corr_local, corr_cloud, v_risk,
                       zeta_pen):
    """Column-addressed form of ``_service_slab``: only device columns
    [n0, n0 + n_cols), bit-identical to slicing the full-width slab."""
    return _lower_values(wl.slab_cols(t0, length, n0, n_cols), space, None,
                         o_levels, cycles, phi_hat, sigma, d_local,
                         corr_local, corr_cloud, v_risk, zeta_pen)


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
    arrays: tuple  # (o_levels, cycles, phi_hat, sigma, d_local, cl, cc)
    knobs: tuple  # (v_risk, zeta_pen) float32 values
    gain_source: object = None

    @property
    def rule(self) -> StepRule:
        return StepRule.inv_sqrt(self.sim.step_a)

    def slab(self, t0: int, length: int):
        """(j_idx (L, N) int32, RawOverlay slab) for [t0, t0 + length)."""
        return _slab_pair(_service_slab(self.wl, self.space, t0, length,
                                        *self.arrays, *self.knobs))

    def slab_cols(self, t0: int, length: int, n0: int, n_cols: int):
        """Device columns [n0, n0 + n_cols) of ``slab(t0, length)``,
        bit-identical to slicing it, from O(length * n_cols) work (the
        reference's ``source_cols`` contract; the gateway's load generator
        reads it, ``workload.loadgen``)."""
        return _slab_pair(_service_slab_cols(
            self.wl, self.space, t0, length, n0, n_cols, *self.arrays,
            *self.knobs))


def compile_service_streaming(sim, pool, *, gain_source=None,
                              device=None) -> StreamingService:
    """Lower (SimConfig, PrecomputedPool) to a :class:`StreamingService` on
    ``device`` (None -> cuda).

    The only O(T)-sized work is the boundary pass of the workload lowering
    (one draws call, (ceil(T / 64), N) output); nothing (T, N)-sized is
    built.  Arrival overrides need the materialized path
    (``compile_service``); ``gain_source`` as there."""
    dev = resolve_device(device)
    space, arrays, params, knobs, num_rates = _service_inputs(
        sim, pool, gain_source, device=dev)
    wl = lower_service_workload(sim.seed, sim.T, sim.num_devices,
                                len(pool.local_correct), num_rates,
                                tuple(sim.burst_len), sim.mean_gap,
                                device=dev)
    for levels in (space.o_levels, space.h_levels, space.w_levels):
        # upload the grids before any slab (keyed by the indexed device)
        level_grid(tuple(levels), params.B.device)
    return StreamingService(sim=sim, space=space, tables=space.tables(dev),
                            params=params, wl=wl, arrays=arrays,
                            knobs=knobs, gain_source=gain_source)


def service_metrics(sim, series) -> dict:
    """Fold fleet-engine series into the service-tier aggregate metrics
    (the reference's keys and float arithmetic, on host copies)."""
    s = lambda key: series[key].detach().cpu().numpy()
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
