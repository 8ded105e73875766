"""The port's live serving gateway and load generator against the JAX
package's batch replay.

The oracle is the reference's ``fleet.simulate(collect_decisions=True,
enforce_slot_capacity=True)`` on its full-width workload — not the
reference's gateway, whose bit-identity tests are red (ROADMAP.md C1: its
column-ranged draws disagree with full-width ones).  The port's load
generator draws from ``StreamingService.slab_cols``, held against the
full-width draws (tests/test_torch_streaming.py), so its replay must equal
the batch decisions exactly: through ``tick``, ``tick_async``, the closed
loop and the pipelined loop at every depth, and under a topology (static,
time-varying, streamed).  Plus the SLO fallback, shedding, the latency
reservoir and the trajectory warm start, as tests/test_gateway.py holds
them.
"""

import asyncio
import json
import time

import numpy as np
import pytest

from repro.core import fleet as ref_fleet
from repro.serve import compile as ref_compile
from repro.serve import simulator as ref_sim
from repro.topology import Topology as RefTopology
from repro_torch import interop
from repro_torch.core import fleet
from repro_torch.gain import (ModelGain, fit_ridge_gain, oracle_pool,
                              synthetic_gain_problem)
from repro_torch.serve.compile import (compile_service,
                                       compile_service_streaming)
from repro_torch.serve.gateway import (GatewayCore, LatencyReservoir,
                                       LiveGateway, default_buckets,
                                       drive_closed_loop, run_closed_loop,
                                       run_open_loop, run_pipelined_loop)
from repro_torch.serve.simulator import SimConfig, synthetic_pool
from repro_torch.topology import Topology
from repro_torch.workload import ServiceLoadGen

CPU = "cpu"
N, T = 6, 100
CFG = dict(num_devices=N, T=T, seed=3)


@pytest.fixture(scope="module")
def batch():
    """The reference's batch scan replay: (T, N) offload / admit masks."""
    cs = ref_compile.compile_service(ref_sim.SimConfig(**CFG),
                                     ref_sim.synthetic_pool())
    series, _ = ref_fleet.simulate(cs.trace, cs.tables, cs.params, cs.rule,
                                   overlay=cs.overlay,
                                   enforce_slot_capacity=True,
                                   collect_decisions=True)
    return (np.asarray(series["offload_mask"]),
            np.asarray(series["admit_mask"]))


@pytest.fixture(scope="module")
def streaming():
    return compile_service_streaming(SimConfig(**CFG), synthetic_pool(),
                                     device=CPU)


def _replay_ticks(core, loadgen, slots, use_async=False):
    off = np.zeros((slots, core.N), bool)
    adm = np.zeros_like(off)
    for wv in loadgen.waves(0, slots):
        if use_async:
            o, a = core.tick_async(wv.idx, wv.o, wv.h, wv.w).resolve()
        else:
            o, a = core.tick(wv.idx, wv.o, wv.h, wv.w)
        off[wv.t, wv.idx] = o
        adm[wv.t, wv.idx] = a
    return off, adm


def _masks_from_replies(replies, loadgen, slots, n):
    off = np.zeros((slots, n), bool)
    adm = np.zeros_like(off)
    for t, r in enumerate(replies):
        assert not r.fallback and r.t == t
        wv = loadgen.wave(t)
        off[t, wv.idx] = r.offload
        adm[t, wv.idx] = r.admitted
    return off, adm


@pytest.mark.parametrize("use_async", [False, True], ids=["tick",
                                                          "tick_async"])
def test_tick_replay_matches_reference_batch(batch, streaming, use_async):
    """A tick a workload slot == the reference's batch scan, offload and
    admit masks exactly; tick_async + resolve is the same stream; the
    duals and counts stay in their buffers."""
    core = GatewayCore.for_service(streaming)
    buffers = [x.data_ptr() for x in (core.state.lam, core.state.mu,
                                      core.state.rho.counts)]
    got = _replay_ticks(core, ServiceLoadGen(streaming), T, use_async)
    assert np.array_equal(got[0], batch[0])
    assert np.array_equal(got[1], batch[1])
    assert core.slots == T == core.stats.ticks == core.state.rho.t
    # the persistent state was updated in place
    assert buffers == [x.data_ptr() for x in (
        core.state.lam, core.state.mu, core.state.rho.counts)]


def test_closed_loop_matches_reference_batch(batch, streaming):
    core = GatewayCore.for_service(streaming)
    lg = ServiceLoadGen(streaming)
    replies, stats = run_closed_loop(core, lg, warmup=True, slo_ms=1e9)
    got = _masks_from_replies(replies, lg, T, N)
    assert np.array_equal(got[0], batch[0])
    assert np.array_equal(got[1], batch[1])
    assert stats.waves == T and stats.fallback_waves == 0
    assert stats.max_in_flight_seen == 1
    assert len(stats.latencies_ms) == T


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_pipelined_depths_match_reference_batch(batch, streaming, depth):
    """The pipelined loop at every depth gives the batch decisions."""
    core = GatewayCore.for_service(streaming)
    lg = ServiceLoadGen(streaming, prefetch=True)
    replies, stats = run_pipelined_loop(core, lg, max_in_flight=depth,
                                        slo_ms=1e9)
    got = _masks_from_replies(replies, ServiceLoadGen(streaming), T, N)
    assert np.array_equal(got[0], batch[0])
    assert np.array_equal(got[1], batch[1])
    assert stats.fallback_waves == 0 and stats.shed_chunks == 0
    assert 1 <= stats.max_in_flight_seen <= depth


@pytest.mark.parametrize("kind", ["hotspot", "walk", "streamed walk"])
def test_topology_path_matches_batch(kind):
    """K = 3 cloudlets: per-cloudlet duals and admission.  A static
    hotspot and a time-varying walk (the reference's, carried over) equal
    the reference's batch scan; a streamed walk (regenerated one
    ROW_BLOCK at a time) equals the port's batch scan on the same walk
    materialized."""
    n, t = 8, 80
    cfg = dict(num_devices=n, T=t, seed=6)
    H = ref_sim.SimConfig(**cfg).H
    if kind == "streamed walk":
        topo = Topology.mobility_walk(3, n, t, H, p_handover=0.1, seed=2,
                                      streaming=True, device=CPU)
        dense = Topology(assoc=topo.assoc_at(0, t), H_k=topo.H_k, K=3)
        cs = compile_service(SimConfig(**cfg), synthetic_pool(), device=CPU)
        series, _ = fleet.simulate(*cs.simulate_args(), cs.rule,
                                   overlay=cs.overlay, topology=dense,
                                   enforce_slot_capacity=True,
                                   collect_decisions=True, device=CPU)
        want = [series[k].numpy() for k in ("offload_mask", "admit_mask")]
    else:
        rtopo = (RefTopology.hotspot(3, n, H) if kind == "hotspot" else
                 RefTopology.mobility_walk(3, n, t, H, p_handover=0.1,
                                           seed=2))
        topo = interop.topology_from(rtopo, device=CPU)
        rcs = ref_compile.compile_service(ref_sim.SimConfig(**cfg),
                                          ref_sim.synthetic_pool())
        series, _ = ref_fleet.simulate(rcs.trace, rcs.tables, rcs.params,
                                       rcs.rule, overlay=rcs.overlay,
                                       topology=rtopo,
                                       enforce_slot_capacity=True,
                                       collect_decisions=True)
        want = [np.asarray(series[k]) for k in ("offload_mask",
                                                "admit_mask")]
    st = compile_service_streaming(SimConfig(**cfg), synthetic_pool(),
                                   device=CPU)
    core = GatewayCore.for_service(st, topology=topo)
    got = _replay_ticks(core, ServiceLoadGen(st, slab=32), t)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert core.mu.shape == (3,)


def test_column_owned_loadgens_concatenate_to_full_width(streaming):
    """Generators owning device ranges emit, together, the full-width
    generator's waves (ids absolute, values equal); prefetch changes
    nothing."""
    full = ServiceLoadGen(streaming, slab=16)
    parts = [ServiceLoadGen(streaming, slab=16, n0=0, n_cols=2),
             ServiceLoadGen(streaming, slab=16, n0=2, n_cols=3,
                            prefetch=True),
             ServiceLoadGen(streaming, slab=16, n0=5)]
    for t in range(T):
        want = full.wave(t)
        got = [p.wave(t) for p in parts]
        for key in ("idx", "o", "h", "w"):
            assert np.array_equal(np.concatenate([getattr(g, key)
                                                  for g in got]),
                                  getattr(want, key)), (t, key)
    with pytest.raises(ValueError, match="outside fleet"):
        ServiceLoadGen(streaming, n0=N)
    with pytest.raises(ValueError, match="exceeds the fleet"):
        ServiceLoadGen(streaming, n0=4, n_cols=3)
    with pytest.raises(ValueError, match="outside horizon"):
        full.wave(T)


def test_empty_wave_advances_and_oversized_wave_rejected(streaming):
    core = GatewayCore.for_service(streaming)
    empty = np.zeros((0,), np.float32)
    off, adm = core.tick(np.zeros((0,), np.int32), empty, empty, empty)
    assert off.shape == adm.shape == (0,)
    assert core.slots == 1 and core.state.rho.t == 1
    ids = np.arange(N + 1, dtype=np.int32)
    with pytest.raises(ValueError, match="exceeds fleet"):
        core.tick(ids, ids * 0.0, ids * 0.0, ids * 0.0)


def test_warmup_leaves_state_and_marks_buckets(streaming):
    core = GatewayCore(streaming.space, streaming.tables, streaming.params,
                       streaming.rule, N, buckets=(2, 4, N))
    assert core.warmup(n_reports=3) == [4]
    assert core.warmup() == [2, 4, N]
    assert core.slots == 0 and core.state.rho.t == 0
    assert core.stats.compiles == 3 and not core._est_resolve_ms
    th = core.warmup(background=True)
    th.join()
    with pytest.raises(ValueError, match="not both"):
        core.warmup(n_reports=1, buckets=[1])
    assert default_buckets(1000) == (64, 128, 256, 512, 1000)
    assert default_buckets(10) == (10,)
    with pytest.raises(ValueError, match="largest bucket"):
        GatewayCore(streaming.space, streaming.tables, streaming.params,
                    streaming.rule, N, buckets=(2,))
    # a mesh is a DeviceMesh (four ranks: tests/test_torch_distributed.py)
    with pytest.raises(TypeError, match="DeviceMesh"):
        GatewayCore.for_service(streaming, mesh=object())


def test_for_sim_accepts_all_sources():
    probs, gains = synthetic_gain_problem(S=128, seed=0)
    pool = oracle_pool(probs, gains)
    sim = SimConfig(num_devices=4, T=40, seed=1)
    ridge = ModelGain(fit_ridge_gain(probs, gains, device=CPU), probs)
    for src in (None, "table", "overlay", ridge):
        core = GatewayCore.for_sim(sim, pool, gain_source=src, device=CPU)
        assert core.N == 4
    # a ridge source's gateway replays the batch engine on its tables
    core = GatewayCore.for_sim(sim, pool, gain_source=ridge, device=CPU)
    cs = compile_service(sim, pool, gain_source=ridge, device=CPU)
    series, _ = fleet.simulate(*cs.simulate_args(), cs.rule,
                               overlay=cs.overlay, enforce_slot_capacity=True,
                               collect_decisions=True, device=CPU)
    st = compile_service_streaming(sim, pool, gain_source=ridge, device=CPU)
    got = _replay_ticks(core, ServiceLoadGen(st), sim.T)
    assert np.array_equal(got[0], series["offload_mask"].numpy())


def test_slo_fallback_instead_of_missed_deadline(streaming):
    """A wave whose latency estimate blows the SLO gets local-execution
    fallback and leaves the state untouched; ticking then resumes."""
    core = GatewayCore.for_service(streaming)
    lg = ServiceLoadGen(streaming)

    async def run():
        async with LiveGateway(core, slo_ms=50.0) as gw:
            wv = lg.wave(0)
            ok = await gw.submit(wv.idx, wv.o, wv.h, wv.w)
            core.seed_estimate(wv.size, 10_000.0)  # the slow wave
            slow = await gw.submit(wv.idx, wv.o, wv.h, wv.w)
            core.seed_estimate(wv.size, 0.0)
            again = await gw.submit(wv.idx, wv.o, wv.h, wv.w)
            return ok, slow, again, gw.stats

    ok, slow, again, stats = asyncio.run(run())
    assert not ok.fallback and ok.t == 0
    assert slow.fallback and slow.t == -1
    assert not slow.offload.any() and not slow.admitted.any()
    assert not again.fallback and again.t == 1  # state never ticked
    assert stats.fallback_waves == 1
    assert core.slots == 2


def test_full_queue_sheds_with_fallback(streaming):
    """A slow dispatch and a tiny queue: excess chunks are shed at submit
    with fallback replies, queued ones merge into waves, every future
    resolves."""
    core = GatewayCore.for_service(streaming)
    real_async = core.tick_async

    def slow_async(idx, o, h, w):
        time.sleep(0.05)
        return real_async(idx, o, h, w)

    core.tick_async = slow_async
    lg = ServiceLoadGen(streaming)

    async def run():
        async with LiveGateway(core, slo_ms=60_000.0, max_queue=2) as gw:
            waves = [lg.wave(t) for t in range(10)]
            return (await asyncio.gather(
                *[gw.submit(w.idx, w.o, w.h, w.w) for w in waves]),
                gw.stats)

    replies, stats = asyncio.run(asyncio.wait_for(run(), 60))
    assert len(replies) == 10
    assert sum(r.fallback for r in replies) >= 1 and stats.shed_chunks >= 1
    assert any(not r.fallback for r in replies)
    assert stats.max_queue_seen <= 2


def test_closed_loop_driver_and_open_loop(streaming):
    """drive_closed_loop keeps one slot a wave; an open loop far below
    saturation serves every wave."""
    core = GatewayCore.for_service(streaming)
    lg = ServiceLoadGen(streaming)

    async def run():
        async with LiveGateway(core, slo_ms=1e9) as gw:
            return await drive_closed_loop(gw, lg, 0, 10)

    replies = asyncio.run(run())
    assert [r.t for r in replies] == list(range(10))
    replies, stats = run_open_loop(GatewayCore.for_service(streaming),
                                   ServiceLoadGen(streaming), rate_hz=500.0,
                                   slots=12, slo_ms=1e9)
    assert len(replies) == 12 and not any(r.fallback for r in replies)
    assert stats.reports == sum(lg.wave(t).size for t in range(12))
    with pytest.raises(ValueError, match="max_in_flight"):
        LiveGateway(core, max_in_flight=0)


def test_latency_reservoir():
    r = LatencyReservoir(capacity=64, seed=1)
    assert not r and np.isnan(r.percentile(50))
    for i in range(1000):
        r.append(float(i))
    assert len(r) == 1000 and r.sample().shape == (64,)
    assert 200 < r.percentile(50) < 800
    again = LatencyReservoir(capacity=64, seed=1)
    for i in range(1000):
        again.append(float(i))
    assert np.array_equal(again.sample(), r.sample())
    with pytest.raises(ValueError):
        LatencyReservoir(capacity=1)


def test_seed_from_trajectory(tmp_path, streaming):
    """The nearest fleet size's newest p50 seeds every bucket without a
    live estimate; measured EMAs are kept."""
    rows = [{"bench": "gateway", "config": "N8_x", "p50_ms": 1.5},
            {"bench": "gateway", "config": "N8_y", "p50_ms": 2.5},
            {"bench": "gateway", "config": "N4096", "p50_ms": 9.0},
            {"bench": "other", "config": "N6", "p50_ms": 7.0}]
    path = tmp_path / "rows.json"
    path.write_text(json.dumps(rows))
    core = GatewayCore.for_service(streaming)
    core._est_resolve_ms[N] = 0.25
    assert core.seed_from_trajectory(path) == 2.5
    assert core._est_resolve_ms[N] == 0.25
    assert core.seed_from_trajectory(path, config="N4096") == 9.0
    with pytest.raises(ValueError, match="no gateway row"):
        core.seed_from_trajectory(path, config="N1")
