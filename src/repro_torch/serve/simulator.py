"""End-to-end edge-analytics simulator: the paper's testbed in software.

Port of ``repro/serve/simulator.py``.  A fleet of N camera devices runs a
local classifier and gain predictor; the offloading policy (OnAlgo or a
baseline) sends tasks to a cloudlet that admits them under its per-slot
capacity.  ``simulate_service`` lowers the run with ``compile_service``
(or, with ``materialize=False``, ``compile_service_streaming``) and
rolls it through a fleet engine on the card (``device=None``).

The pool is an input: ``make_scenario`` builds the paper's (a weak device
classifier and a strong cloudlet classifier trained on a synthetic
dataset, a gain predictor calibrated on them, their test-set outputs as
the pool, ``build_pool``), ``synthetic_pool`` a deterministic one without
training, or any ``PrecomputedPool`` of numpy arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch import obs
from repro_torch.core.state_space import StateSpace

RATES = np.array([10.0, 25.0, 40.0])  # Mbps (testbed operating points)

def power_of_rate(r):
    """Paper Fig. 2b fitted curve (Watts)."""
    return -0.00037 * r**2 + 0.0214 * r + 0.1277


@dataclasses.dataclass
class SimConfig:
    num_devices: int = 4
    T: int = 2000
    B_n: float = 0.08  # W average power budget
    H: float = 2 * 441e6  # cycles/slot cloudlet capacity
    v_risk: float = 0.5  # risk aversion v_n in eq. (1)
    burst_len: tuple = (5, 10)
    mean_gap: float = 8.0
    seed: int = 0
    algo: str = "onalgo"  # onalgo | ato | rco | ocos | local | cloud
    ato_theta: float = 0.85
    step_a: float = 0.5
    num_w_levels: int = 8
    zeta: float = 0.0  # P3 delay weight (0 = accuracy only)
    rng_version: int = 1  # workload RNG contract (1: counter-based streams)
    # paper-measured delays (seconds)
    d_tr: float = 0.157e-3
    d_pr_cloud: float = 0.191e-3
    d_pr_dev: float = 2.537e-3


@dataclasses.dataclass
class PrecomputedPool:
    """Per-test-image precomputations shared across slots/devices."""

    local_correct: np.ndarray  # (S,)
    cloud_correct: np.ndarray  # (S,)
    d_local: np.ndarray  # (S,) local top-1 confidence
    phi_hat: np.ndarray  # (S,) predicted gain
    sigma: np.ndarray  # (S,) predictor confidence
    cycles: np.ndarray  # (S,) cloudlet cycles per image


def pool_fingerprint(pool: "PrecomputedPool") -> tuple:
    """Content hash of the pool arrays (the key of ``pool_space``'s cache,
    so in-place recalibration of a pool never serves stale data)."""
    return tuple(hash(np.asarray(x).tobytes())
                 for x in (pool.cycles, pool.phi_hat, pool.sigma,
                           pool.d_local, pool.local_correct,
                           pool.cloud_correct))


def build_pool(data, pair, predictor, seed: int = 0) -> PrecomputedPool:
    """The pool of ``data``'s test set: each image's local and cloudlet
    correctness under ``pair`` (a ``data.synthetic.ClassifierPair``), the
    local top-1 confidence, ``predictor``'s (phi_hat, sigma) from the
    local probabilities, and cloudlet cycles drawn from ``seed``."""
    from repro_torch.data.predictor import _numpy
    rng = np.random.default_rng(seed)
    lp = _numpy(pair.local_probs(data.x_test))
    cp = _numpy(pair.cloud_probs(data.x_test))
    y = data.y_test
    phi, sigma = predictor.predict(lp)
    cycles = np.clip(rng.normal(441e6, 90e6, len(y)), 150e6, None)
    return PrecomputedPool(
        local_correct=(lp.argmax(-1) == y).astype(np.float64),
        cloud_correct=(cp.argmax(-1) == y).astype(np.float64),
        d_local=lp.max(-1),
        phi_hat=phi, sigma=sigma, cycles=cycles)


def calibrated_space(phi_hat: np.ndarray, sigma: np.ndarray,
                     num_w: int = 8, v_risk: float = 0.5) -> StateSpace:
    """State space calibrated to a per-image gain-table pair: the w grid
    covers the realized gain distribution up to its 0.999 quantile
    (paper footnote 5)."""
    w_all = np.clip(np.asarray(phi_hat, np.float64)
                    - v_risk * np.asarray(sigma, np.float64), 0.0, 1.0)
    w_hi = max(float(np.quantile(w_all, 0.999)), 0.1)
    return StateSpace(
        o_levels=tuple(power_of_rate(RATES).tolist()),
        h_levels=(441e6 - 90e6, 441e6, 441e6 + 90e6),
        w_levels=tuple(np.linspace(0.0, w_hi, num_w).tolist()),
    )


def pool_space(pool: "PrecomputedPool", num_w: int = 8,
               v_risk: float = 0.5) -> StateSpace:
    """Pool-calibrated quantized state space, cached per (num_w, v_risk)
    on the pool object under its content fingerprint."""
    fp = pool_fingerprint(pool)
    cache = getattr(pool, "_space_cache", None)
    if cache is None or cache[0] != fp:
        cache = pool._space_cache = (fp, {})
    cache = cache[1]
    key = (num_w, v_risk)
    if key not in cache:
        cache[key] = calibrated_space(pool.phi_hat, pool.sigma,
                                      num_w=num_w, v_risk=v_risk)
    return cache[key]


def make_scenario(kind: str, seed: int = 0, *, device=None):
    """(data, pair, predictor, pool) for 'easy' (MNIST-like) or 'hard'
    (CIFAR-like): the classifiers trained on ``device`` (None -> cuda),
    the predictor calibrated on the first 5000 training samples."""
    from repro_torch.data.predictor import calibrate
    from repro_torch.data.synthetic import build_scenario
    data, pair = build_scenario(kind, seed=seed, device=device)
    predictor = calibrate(pair, data.x_train[:5000], data.y_train[:5000])
    pool = build_pool(data, pair, predictor, seed=seed)
    return data, pair, predictor, pool


def synthetic_pool(S: int = 64, seed: int = 0) -> PrecomputedPool:
    """A deterministic synthetic pool — no classifier training needed
    (local ~60% right, cloudlet ~85%, modest predicted gains)."""
    rng = np.random.default_rng(seed)
    return PrecomputedPool(
        local_correct=(rng.random(S) < 0.6).astype(np.float64),
        cloud_correct=(rng.random(S) < 0.85).astype(np.float64),
        d_local=rng.uniform(0.3, 1.0, S),
        phi_hat=rng.uniform(0.0, 0.3, S),
        sigma=rng.uniform(0.0, 0.1, S),
        cycles=np.clip(rng.normal(441e6, 90e6, S), 150e6, None))


def _launch_counts() -> dict:
    from repro_torch.kernels import ops
    return ops.launch_counts()


@obs.spanned("service", counts=_launch_counts)
def simulate_service(sim: SimConfig, pool: PrecomputedPool,
                     on: Optional[np.ndarray] = None, *,
                     engine: str = "scan", chunk: int = 16,
                     block_n: Optional[int] = None, mesh=None,
                     device_axis: str = "data", materialize: bool = True,
                     slab: Optional[int] = None, topology=None,
                     topo_binned: Optional[bool] = None,
                     pipelined: Optional[bool] = None,
                     gain_source=None, device=None) -> dict:
    """Run T slots of the service on ``device`` (None -> cuda); returns the
    aggregate metrics.

    Power is consumed on transmission; accuracy comes from the cloudlet
    only for admitted tasks (per-slot capacity enforced for every policy);
    other tasks score the local classifier's result.

      engine="scan"     ``fleet.simulate``: the slot loop, any algo;
      engine="chunked"  ``fleet.simulate_chunked``: the fused rollout
                        kernels (K1; ``block_n`` routes the tiled K2);
                        onalgo / local / cloud;
      engine="sharded"  ``fleet.simulate_sharded``: the slot loop over the
                        fleet sharded on ``mesh``'s ``device_axis``, one
                        process a shard (every rank calls this with the
                        same arguments and gets the same metrics); N must
                        be a multiple of the shard count; onalgo / local /
                        cloud.  ``mesh=None`` is the current process
                        group's 1-D mesh over ``device_axis``, or a world
                        of one where none exists (``launch.mesh``); the
                        mesh must be on the run's device type.

    ``materialize=False`` switches the chunked and sharded engines to the
    STREAMING lowering (``compile_service_streaming``): no (T, N) trace or overlay
    is built; each ``slab`` (default 16 * chunk) slots of workload are
    generated on the device from counters (the draws kernel) inside the
    engine's loop (``fleet.simulate_chunked_stream``) and dropped after
    their accounting folds, so peak memory does not grow with T, and the
    metrics equal the materialized run's at the same ``chunk``.  The
    sharded stream (``fleet.simulate_sharded_stream``, ``slab`` default
    256) has each rank draw only its own device columns
    (``StreamingService.slab_cols``).
    ``pipelined`` names the reference's choice of walk; the port has one
    walk, which never waits for the card inside its slab loop, so it
    changes nothing.  The scan engine and arrival overrides need
    the materialized arrays and are rejected.

    ``topology``: a multi-cloudlet :class:`~repro_torch.topology.Topology`
    (checked by ``validate_topology`` before compiling): the capacity
    dual becomes a (K,) vector (K1-topo / K2-topo on the chunked engine)
    and admission runs per cloudlet under H_k.  Build it with total
    capacity ``sim.H``; ``Topology.uniform(1, N, sim.H)`` reproduces the
    scalar path's metrics exactly.  ``topo_binned`` (None / True / False)
    names the reference's TPU reduction layout; one kernel serves both
    here, so it changes nothing (the scan engine ignores it).

    ``gain_source``: a :class:`~repro_torch.gain.GainSource` (or "table" /
    "overlay"), resolved once per compile into the per-image gain tables
    and their calibrated space (None = the pool's own tables); every
    engine and lowering takes it.

    ``mesh`` and ``device_axis`` act only with ``engine="sharded"``, and
    ``slab`` only with ``materialize=False``, as in the reference.
    """
    from repro_torch.core.fleet import (simulate, simulate_chunked,
                                        simulate_chunked_stream,
                                        simulate_sharded,
                                        simulate_sharded_stream)
    from repro_torch.serve.compile import (compile_service,
                                           compile_service_streaming,
                                           service_metrics)
    from repro_torch.topology import validate_topology

    if engine not in ("scan", "chunked", "sharded"):
        raise ValueError(f"unknown engine {engine!r}; "
                         "expected scan | chunked | sharded")
    if engine == "sharded" and mesh is None:
        from repro_torch.launch.mesh import default_mesh
        mesh = default_mesh(device_axis, device)
    validate_topology(topology, sim.T, sim.num_devices)

    if not materialize:
        if engine == "scan":
            raise ValueError(
                "materialize=False streams workload slabs per chunk; the "
                "scan engine needs the whole horizon — use "
                "engine='chunked' or 'sharded'")
        if on is not None:
            raise ValueError(
                "materialize=False generates arrivals on device; an "
                "arrival-matrix override needs materialize=True")
        cs = compile_service_streaming(sim, pool, gain_source=gain_source,
                                       device=device)
        if engine == "chunked":
            series, _ = simulate_chunked_stream(
                cs.slab, sim.T, sim.num_devices, cs.tables, cs.params,
                cs.rule, chunk=chunk, slab=slab, block_n=block_n,
                algo=sim.algo, enforce_slot_capacity=True,
                topology=topology, topo_binned=topo_binned,
                device=cs.params.B.device)
        else:
            series, _ = simulate_sharded_stream(
                cs.slab, sim.T, sim.num_devices, cs.tables, cs.params,
                cs.rule, mesh, device_axis=device_axis, slab=slab,
                algo=sim.algo, enforce_slot_capacity=True,
                topology=topology, source_cols=cs.slab_cols,
                pipelined=pipelined, device=cs.params.B.device)
        return service_metrics(sim, series)

    cs = compile_service(sim, pool, on, gain_source=gain_source,
                         device=device)
    dev = cs.params.B.device
    if engine == "scan":
        series, _ = simulate(*cs.simulate_args(), cs.rule, algo=sim.algo,
                             ato_theta=sim.ato_theta,
                             enforce_slot_capacity=True, overlay=cs.overlay,
                             topology=topology, device=dev)
    elif engine == "chunked":
        series, _ = simulate_chunked(*cs.simulate_args(), cs.rule,
                                     chunk=chunk, block_n=block_n,
                                     algo=sim.algo, overlay=cs.overlay,
                                     enforce_slot_capacity=True,
                                     topology=topology,
                                     topo_binned=topo_binned, device=dev)
    else:
        series, _ = simulate_sharded(*cs.simulate_args(), cs.rule, mesh,
                                     device_axis=device_axis, algo=sim.algo,
                                     overlay=cs.overlay,
                                     enforce_slot_capacity=True,
                                     topology=topology, device=dev)
    metrics = service_metrics(sim, series)
    with obs.span("release"):  # the lowering's arrays, the host copy of on
        del cs, series
    return metrics
