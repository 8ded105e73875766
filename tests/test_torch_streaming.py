"""The port's streaming engine against the JAX package (ROADMAP A5).

The workload's and the mobility walk's streaming lowerings (boundary
states and slabs), the streaming service's slabs, the chunked-stream
engine (against the reference's sequential and pipelined walks) and
``simulate_service(materialize=False)``, each against the reference on
numpy inputs at small sizes; the reference runs as its own tests run it (Pallas in interpret
mode on the CPU).  On the CPU the port runs the plain versions: the draws
kernel's is the eager streams code.  Bars: draws and slabs bit for bit;
engine decisions and admits exactly, duals, mu and lam-norm rtol 1e-5 /
atol 1e-6; service metrics rel 2e-5 / abs 1e-5 (the reference's
cross-engine bar, tests/test_serve.py).  Also the rollout wrappers'
checks made once per run (``onalgo_step.RolloutRun``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import fleet as ref_fleet
from repro.serve import compile as ref_compile
from repro.serve import simulator as ref_sim
from repro.topology import Topology as RefTopology
from repro.workload import streaming as ref_streaming
from repro_torch import interop
from repro_torch.core import fleet
from repro_torch.kernels import onalgo_step as k
from repro_torch.kernels import ops
from repro_torch.serve.compile import (compile_service,
                                       compile_service_streaming)
from repro_torch.serve.simulator import (SimConfig, simulate_service,
                                         synthetic_pool)
from repro_torch.topology import Topology
from repro_torch.workload import (generate_service_workload,
                                  lower_service_workload, streams)

CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-6
# N=13 and T=203: neither divides a tile, a chunk or a block; the capacity
# binds (mu > 0) from the first slab on
CFG = dict(num_devices=13, T=203, B_n=0.06, H=1.2 * 441e6, seed=4)
METRICS = ("accuracy", "offload_frac", "admit_frac", "avg_power_per_dev",
           "avg_load", "avg_delay_ms", "tasks", "mu_final")
EXACT = ("offloads", "admits", "tasks")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --------------------------------------------------------------------------
# the workload's streaming lowering

@pytest.fixture(scope="module")
def workloads():
    """Port and reference lowerings of one (seed, T=203, N=11) workload,
    and the port's materialized workload."""
    args = (5, 203, 11, 64, 3)
    return (lower_service_workload(*args, device=CPU),
            ref_streaming.lower_service_workload(*args),
            generate_service_workload(*args, device=CPU))


def test_boundary_states_match_reference(workloads):
    got, ref, _ = workloads
    assert got.on_entry.shape == (4, 11) and got.on_entry.dtype == torch.bool
    np.testing.assert_array_equal(_np(got.on_entry), _np(ref.on_entry))
    np.testing.assert_array_equal(_np(got.rate_entry), _np(ref.rate_entry))


@pytest.mark.parametrize("t0,length,aligned", [
    (0, 64, True), (0, 64, False), (64, 64, True), (17, 64, False),
    (139, 64, False), (192, 11, True)])
def test_slab_matches_reference_and_materialized(workloads, t0, length,
                                                 aligned):
    """Any start: the reference's aligned and unaligned paths both equal
    the port's one slab."""
    got, ref, full = workloads
    slab = got.slab(t0, length)
    want = ref.slab(t0, length, aligned=aligned)
    for name in ("on", "img", "rates"):
        np.testing.assert_array_equal(_np(getattr(slab, name)),
                                      _np(getattr(want, name)), name)
        np.testing.assert_array_equal(
            _np(getattr(slab, name)),
            _np(getattr(full, name))[t0:t0 + length], name)


@pytest.mark.parametrize("t0,length,n0,n_cols", [
    (0, 64, 0, 4), (17, 100, 3, 8), (130, 73, 10, 1)])
def test_slab_cols_equal_full_width_slice(workloads, t0, length, n0,
                                          n_cols):
    got = workloads[0]
    cols = got.slab_cols(t0, length, n0, n_cols)
    full = got.slab(t0, length)
    for name in ("on", "img", "rates"):
        np.testing.assert_array_equal(
            _np(getattr(cols, name)),
            _np(getattr(full, name))[:, n0:n0 + n_cols], name)


def test_column_counters_past_two_to_the_32():
    """At N = 2^25 the flat counter (r * C + c) * N + n passes 2^32 from
    row 32 on: the column form splits it into (hi, lo) words as jax's
    partitionable layout does (checked against the scalar threefry on
    Python ints; the card test holds the kernel to this plain version)."""
    N, n0, C = 2 ** 25, 2 ** 25 - 3, 4
    u = streams.uniform_block_range(7, streams.STREAM_SERVICE, 2, 1, N, C,
                                    n0=n0, n_cols=3, device=CPU)
    key = streams.fold_in(streams.stream_key(7, streams.STREAM_SERVICE), 2)
    for r, c, dn in ((0, 0, 0), (31, 3, 2), (32, 0, 1), (63, 3, 2)):
        i = (r * C + c) * N + n0 + dn
        x0, x1 = streams.threefry2x32(*key, i >> 32, i & 0xFFFFFFFF)
        bits = np.uint32(((x0 ^ x1) >> 9) | 0x3F800000)
        want = bits.view(np.float32) - np.float32(1.0)
        assert i >= 2 ** 32 or r < 32
        assert u[c, r, dn].item() == want


# --------------------------------------------------------------------------
# the mobility walk's streaming lowering

@pytest.mark.parametrize("t0,length", [(0, 64), (5, 100), (64, 139),
                                       (200, 3)])
def test_streaming_assoc_matches_reference_and_dense(t0, length):
    args = (6, 9, 203)
    kw = dict(H=4.0, p_handover=0.1, seed=3)
    got = Topology.mobility_walk(*args, streaming=True, device=CPU, **kw)
    dense = Topology.mobility_walk(*args, device=CPU, **kw)
    ref = RefTopology.mobility_walk(*args, streaming=True, **kw)
    slab = got.assoc_at(t0, length)
    assert slab.dtype == torch.int32 and slab.shape == (length, 9)
    np.testing.assert_array_equal(_np(slab), _np(ref.assoc_at(t0, length)))
    np.testing.assert_array_equal(_np(slab), _np(dense.assoc_at(t0, length)))
    np.testing.assert_array_equal(_np(got.assoc.entry), _np(ref.assoc.entry))


def test_streaming_assoc_validates_like_reference():
    topo = Topology.mobility_walk(6, 9, 203, H=4.0, streaming=True,
                                  device=CPU)
    assert topo.prefix(100).T == 100 and topo.prefix(100).streaming
    bad = dataclasses.replace(topo, K=5, H_k=topo.H_k[:5])
    with pytest.raises(ValueError, match="draws over K=6"):
        fleet.validate_topology(bad, 203, 9)
    entry = topo.assoc.entry.clone()
    entry[1, 2] = 6
    bad = dataclasses.replace(topo, assoc=dataclasses.replace(
        topo.assoc, entry=entry))
    with pytest.raises(ValueError, match=r"contains \[0, 6\]"):
        fleet.validate_topology(bad, 203, 9)


# --------------------------------------------------------------------------
# the streaming service lowering

@pytest.fixture(scope="module")
def services():
    sim = SimConfig(**CFG)
    return (compile_service_streaming(sim, synthetic_pool(), device=CPU),
            compile_service(sim, synthetic_pool(), device=CPU),
            ref_compile.compile_service_streaming(
                ref_sim.SimConfig(**CFG), ref_sim.synthetic_pool()))


@pytest.mark.parametrize("t0,length,form", [
    (0, 64, "slab"), (0, 64, "aligned"), (40, 100, "slab"),
    (128, 75, "aligned"), (9, 50, "cols")])
def test_service_slab_matches_materialized_and_reference(services, t0,
                                                         length, form):
    got, mat, ref = services
    if form == "cols":
        j, ov = got.slab_cols(t0, length, 2, 7)
        rj, rov = ref.slab(t0, length)
        cols = slice(2, 9)
    else:
        j, ov = got.slab(t0, length)
        rj, rov = (ref.slab_aligned if form == "aligned"
                   else ref.slab)(t0, length)
        cols = slice(None)
    rows = slice(t0, t0 + length)
    np.testing.assert_array_equal(_np(j), _np(mat.trace.j_idx)[rows, cols])
    np.testing.assert_array_equal(_np(j), _np(rj)[:, cols])
    for name in ("o", "h", "w", "correct_local", "correct_cloud"):
        np.testing.assert_array_equal(
            _np(getattr(ov, name)), _np(getattr(mat.overlay, name))[rows,
                                                                    cols])
        np.testing.assert_array_equal(_np(getattr(ov, name)),
                                      _np(getattr(rov, name))[:, cols])


# --------------------------------------------------------------------------
# the chunked-stream engine

def _topologies(kind, sim, ref):
    N, T = sim.num_devices, sim.T
    if kind is None:
        return None
    if kind == "static4":
        return (RefTopology.hotspot(4, N, sim.H) if ref
                else Topology.hotspot(4, N, sim.H, device=CPU))
    kw = dict(p_handover=0.1, seed=3, streaming=True)
    return (RefTopology.mobility_walk(5, N, T, sim.H, **kw) if ref
            else Topology.mobility_walk(5, N, T, sim.H, device=CPU, **kw))


def _ref_run(services, algo, block_n, topo, t0=0, state0=None,
             pipelined=False):
    ref_cs = services[2]
    sim = ref_sim.SimConfig(**dict(CFG, algo=algo))
    return ref_fleet.simulate_chunked_stream(
        ref_cs.slab, sim.T, sim.num_devices, ref_cs.tables, ref_cs.params,
        ref_cs.rule, chunk=16, slab=64, block_n=block_n, algo=algo,
        enforce_slot_capacity=True, topology=_topologies(topo, sim, True),
        pipelined=pipelined, t0=t0, state0=state0)


def _port_run(services, algo, block_n, topo, t0=0, state0=None, T=None):
    cs = services[0]
    sim = SimConfig(**dict(CFG, algo=algo))
    return fleet.simulate_chunked_stream(
        cs.slab, sim.T if T is None else T, sim.num_devices, cs.tables,
        cs.params, cs.rule, chunk=16, slab=64, block_n=block_n, algo=algo,
        enforce_slot_capacity=True, topology=_topologies(topo, sim, False),
        t0=t0, state0=state0, device=CPU)


def _assert_series(got, want, rows=slice(None)):
    assert set(got) == set(want)
    for key in want:
        g, w = _np(got[key]), _np(want[key])[rows]
        if key in EXACT:
            np.testing.assert_array_equal(g, w, key)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=key)


@pytest.mark.parametrize("algo,block_n,topo", [
    ("onalgo", None, None), ("onalgo", 8, None), ("local", None, None),
    ("cloud", None, None), ("onalgo", None, "static4"),
    ("onalgo", 8, "walk")])
def test_chunked_stream_matches_reference(services, algo, block_n, topo):
    """Against the reference's chunked stream (green)."""
    want, ref_final = _ref_run(services, algo, block_n, topo)
    seq, final = _port_run(services, algo, block_n, topo)
    _assert_series(seq, want)
    if algo == "onalgo":
        if topo is None:
            assert float(seq["mu"][-1]) > 0  # the capacity binds
        np.testing.assert_array_equal(_np(final.rho.counts),
                                      _np(ref_final.rho.counts))
        np.testing.assert_allclose(_np(final.lam), _np(ref_final.lam),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("pipelined", [False, True])
def test_chunked_stream_resumes(services, pipelined):
    """t0 / state0: [64, T) resumed from the state after 64 slots equals
    the same span of a full run, bit for bit, and the reference's, walked
    sequentially or pipelined (the port has one walk)."""
    full, _ = _port_run(services, "onalgo", None, None)
    _, mid = _port_run(services, "onalgo", None, None, T=64)
    counts = mid.rho.counts.clone()
    got, _ = _port_run(services, "onalgo", None, None, t0=64, state0=mid)
    assert torch.equal(mid.rho.counts, counts)  # the caller's state stays
    for key in full:
        assert torch.equal(got[key], full[key][64:]), key
    want, _ = _ref_run(services, "onalgo", None, None, pipelined=pipelined)
    _assert_series(got, want, rows=slice(64, None))
    with pytest.raises(ValueError, match="rho.t"):
        _port_run(services, "onalgo", None, None, t0=32, state0=mid)


def test_chunked_stream_rejects_bad_slab(services):
    with pytest.raises(ValueError, match="multiple of chunk"):
        fleet.simulate_chunked_stream(
            services[0].slab, 203, 13, services[0].tables,
            services[0].params, services[0].rule, chunk=16, slab=40,
            device=CPU)


# --------------------------------------------------------------------------
# simulate_service(materialize=False)

@pytest.mark.parametrize("kw", [
    dict(slab=64), dict(block_n=8, pipelined=True, slab=64)])
def test_service_streaming_matches_reference(kw):
    got = simulate_service(SimConfig(**CFG), synthetic_pool(),
                           engine="chunked", materialize=False,
                           device=CPU, **kw)
    want = ref_sim.simulate_service(ref_sim.SimConfig(**CFG),
                                    ref_sim.synthetic_pool(),
                                    engine="chunked", materialize=False,
                                    **kw)
    assert set(got) == set(want)
    for key in METRICS:
        assert got[key] == pytest.approx(want[key], rel=2e-5, abs=1e-5), key
    mat = simulate_service(SimConfig(**CFG), synthetic_pool(),
                           engine="chunked", device=CPU,
                           **{k: v for k, v in kw.items()
                              if k not in ("pipelined", "slab")})
    assert got == mat  # streaming equals materialized at the same chunk


@pytest.mark.parametrize("kw,match", [
    (dict(engine="scan"), "scan engine needs the whole horizon"),
    (dict(engine="chunked", on=np.ones((203, 13), bool)),
     "arrival-matrix override needs materialize=True")])
def test_service_streaming_rejects(kw, match):
    with pytest.raises(ValueError, match=match):
        simulate_service(SimConfig(**CFG), synthetic_pool(),
                         materialize=False, device=CPU, **kw)
    with pytest.raises(ValueError, match=match):
        ref_sim.simulate_service(ref_sim.SimConfig(**CFG),
                                 ref_sim.synthetic_pool(),
                                 materialize=False, **kw)


# --------------------------------------------------------------------------
# autotune

def test_autotune_streaming_source(services):
    cs = services[0]
    res = fleet.autotune(cs.tables, cs.params, cs.rule, source=cs.slab,
                         T=203, N=13, chunks=(8, 16), block_ns=(None, 8),
                         probe_slots=64, slabs=(32, 64), repeats=1,
                         warmup=0, enforce_slot_capacity=True, device=CPU)
    assert set(res.timings) == {(c, b, s) for c in (8, 16)
                                for b in (None, 8) for s in (32, 64)}
    assert res.kwargs == dict(chunk=res.chunk, block_n=res.block_n,
                              slab=res.slab)
    series, _ = fleet.simulate_chunked_stream(
        cs.slab, 203, 13, cs.tables, cs.params, cs.rule, device=CPU,
        enforce_slot_capacity=True, **res.kwargs)
    assert series["mu"].shape == (203,)


def test_autotune_trace_keys_match_reference(services):
    """The trace probes and the topology grid keep the reference's keys
    (K > 128 probes both reduction layouts)."""
    mat = services[1]
    topo = Topology.uniform(130, 13, CFG["H"], device=CPU)
    res = fleet.autotune(mat.tables, mat.params, mat.rule, trace=mat.trace,
                         overlay=mat.overlay, chunks=(8, 16), repeats=1,
                         warmup=0, probe_slots=32, topology=topo,
                         device=CPU)
    assert set(res.timings) == {(c, None, tb) for c in (8, 16)
                                for tb in (False, True)}
    assert res.kwargs["topology"] is topo
    with pytest.raises(ValueError, match="slabs= probes"):
        fleet.autotune(mat.tables, mat.params, mat.rule, trace=mat.trace,
                       slabs=(32,), device=CPU)


# --------------------------------------------------------------------------
# the rollout wrappers' checks, made once per run

def _rollout_inputs(N=6, M=5, T=16, K=None):
    gen = torch.Generator().manual_seed(0)
    j = torch.randint(0, M, (T, N), generator=gen, dtype=torch.int32)
    tabs = tuple(torch.rand(M, generator=gen) for _ in range(3))
    mu = torch.zeros(() if K is None else (K,))
    return [j, torch.zeros(N), mu, torch.zeros(N, M), *tabs, torch.ones(N),
            torch.tensor(1.0), 0.5, 0.5]


@pytest.mark.parametrize("bad", ["j high", "j negative", "assoc"])
def test_run_checks_raise_on_bad_input(bad):
    """With a RolloutRun the wrappers' range checks still raise (on the
    CPU at once; on a card when the run finishes), with their messages."""
    K = 3 if bad == "assoc" else None
    args = _rollout_inputs(K=K)
    run = k.RolloutRun(args[3], 0.5, 0.5, 0, 16)
    kw = {}
    if bad == "j high":
        args[0][3, 2] = 5
    elif bad == "j negative":
        args[0][0, 0] = -1
    else:
        assoc = torch.zeros((16, 6), dtype=torch.int32)
        assoc[7, 1] = 3
        kw = dict(assoc=assoc, H_k=torch.ones(3))
    match = ("assoc holds cloudlet ids in \\[0, 3\\], outside \\[0, 3\\)"
             if bad == "assoc" else "j_seq holds state indices")
    with pytest.raises(ValueError, match=match):
        ops.onalgo_chunked(*args, chunk=8, run=run, **kw)


@pytest.mark.parametrize("block_n", [None, 8])
def test_streamed_run_raises_on_a_state_index_out_of_range(services,
                                                           block_n):
    """The streaming engine's run keeps the range check: a j out of range
    in its second slab raises (on the CPU at that slab's call)."""
    mat = services[1]
    j = mat.trace.j_idx.clone()
    j[70, 5] = mat.tables[0].shape[-1]
    with pytest.raises(ValueError, match="j_seq holds state indices"):
        fleet.simulate_chunked_stream(
            lambda t0, L: (j[t0:t0 + L], None), 203, 13, mat.tables,
            mat.params, mat.rule, chunk=16, slab=64, block_n=block_n,
            device=CPU)


def test_run_counts_bound_past_uint16():
    """The counts check made once: the bound is max(counts0) at the run's
    start plus the slots walked, so a call whose counts could pass the
    uint16 limit takes the float32 / streaming layouts, as the per-call
    read of counts0 would choose."""
    counts0 = torch.zeros(100, 73)
    counts0[5, 3] = k.COUNT_LIMIT - 100
    run = k.RolloutRun(counts0, 0.5, 0.5, 64, 512)
    assert run.counts_max(64) == k._counts_max(counts0) == 65435
    assert run.counts_max(128) == 65499
    fits = k.tiled_plan(100, 73, 64, run.counts_max(64), 64, True, 132,
                        232448)
    past = k.tiled_plan(100, 73, 64, run.counts_max(128), 64, True, 132,
                        232448)
    assert (fits.counts, past.counts) == ("uint16", "float32")
    plan = lambda c: k.chunked_plan(100, 73, 64, c, 0, 232448, 132, 264, 16)
    assert plan(run.counts_max(64)).route == "resident"
    assert plan(run.counts_max(128)).route == "streaming"
    frac = k.RolloutRun(counts0 + 0.5, 0.5, 0.5, 0, 64)
    assert frac.counts_max(0) is None
    a_seq, inv_t = run.steps(0.5, 0.5, 128, 64)
    want = k.step_tables(0.5, 0.5, 128, 64)
    np.testing.assert_array_equal(a_seq.numpy(), want[0])
    np.testing.assert_array_equal(inv_t.numpy(), want[1])
    with pytest.raises(ValueError, match="outside the run's"):
        run.steps(0.5, 0.5, 500, 64)
    with pytest.raises(ValueError, match="step rule"):
        run.steps(0.25, 0.5, 64, 64)


def test_interop_carries_a_streaming_walk():
    ref = RefTopology.mobility_walk(5, 9, 150, 3.0, p_handover=0.1, seed=2,
                                    streaming=True)
    got = interop.topology_from(jax.tree_util.tree_map(np.asarray, ref),
                                device=CPU)
    assert got.streaming and (got.T, got.N, got.K) == (150, 9, 5)
    np.testing.assert_array_equal(_np(got.assoc_at(30, 100)),
                                  _np(ref.assoc_at(30, 100)))
