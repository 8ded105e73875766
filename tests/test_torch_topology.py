"""The port's multi-cloudlet topology tier against the JAX package: the
constructors and their checks, per-cloudlet admission, the K-vector OnAlgo
step, the plain K-vector rollout against the reference's Pallas kernels
(interpret mode, both TPU reduction layouts) and its oracle, the scan /
chunked / tiled engines, the Theorem-1 series, simulate_service and the
hand-over of a reference state.

Inputs are made with numpy (or by the reference and handed over as numpy
leaves).  Bars are the reference's own (tests/test_topology.py): kernel
decisions and visit counts equal, duals rtol=1e-5, atol=1e-6; engine
series rtol=2e-5, atol=1e-5; service metrics rel=2e-5, abs=1e-5; K = 1
exactly equal to the scalar path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import OnAlgoParams as RefParams
from repro.core import StepRule as RefRule
from repro.core import baselines as ref_bl
from repro.core import default_paper_space
from repro.core import fleet as ref_fleet
from repro.core import onalgo as ref_onalgo
from repro.data.traces import TraceSpec, iid_trace
from repro.kernels import ref as ref_kernels
from repro.kernels.onalgo_step import (onalgo_chunked_pallas,
                                       onalgo_tiled_pallas)
from repro.serve import simulator as ref_sim
from repro.topology import Topology as RefTopology
from repro.topology import validate_topology as ref_validate
from repro_torch import interop
from repro_torch.core import baselines as bl
from repro_torch.core import fleet, onalgo, theory
from repro_torch.kernels import onalgo_step as k
from repro_torch.kernels import ops
from repro_torch.serve.simulator import (SimConfig, simulate_service,
                                         synthetic_pool)
from repro_torch.topology import Topology, validate_topology

CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-6
METRICS = ("accuracy", "offload_frac", "admit_frac", "avg_power_per_dev",
           "avg_load", "avg_delay_ms", "tasks", "mu_final")
leaves = lambda x: jax.tree_util.tree_map(np.asarray, x)


def _port_topo(ref_topo):
    return interop.topology_from(leaves(ref_topo), device=CPU)


class _CpuTopology:
    """``Topology``'s constructors pinned to the CPU; calling it constructs a
    ``Topology``, as calling the reference's class does."""

    def __getattr__(self, name):
        fn = getattr(Topology, name)
        return lambda *a, **kw: fn(*a, device=CPU, **kw)

    def __call__(self, **kw):
        return Topology(**kw)


CPU_TOPOLOGY = _CpuTopology()


# --------------------------------------------------------------------------
# constructors

@pytest.mark.parametrize("build", [
    lambda T: T.uniform(4, 10, 8.0),
    lambda T: T.uniform(1, 6, 1.5 * 441e6),  # H / 1 == H, bit for bit
    lambda T: T.nearest_zone(3, 10, 8.0),
    lambda T: T.hotspot(4, 20, 8.0, hot_frac=0.5, hot=1),
    lambda T: T.mobility_walk(4, 6, 80, H=4.0, p_handover=0.2, seed=9),
    lambda T: T.mobility_walk(1024, 40, 130, H=1e9, p_handover=0.02,
                              seed=3),
], ids=["uniform", "uniform-k1", "nearest_zone", "hotspot", "walk",
        "walk-k1024"])
def test_constructors_match_reference(build):
    want = build(RefTopology)
    got = build(CPU_TOPOLOGY)
    assert got.K == want.K and got.N == want.N
    assert got.time_varying == want.time_varying
    assert got.assoc.dtype == torch.int32
    np.testing.assert_array_equal(got.assoc.numpy(), np.asarray(want.assoc))
    np.testing.assert_array_equal(got.H_k.numpy(), np.asarray(want.H_k))


def test_failover_assoc_at_prefix_match_reference():
    down = np.zeros(30, bool)
    down[10:20] = True
    want = RefTopology.nearest_zone(4, 8, 4.0).failover(jnp.asarray(down), 2)
    got = Topology.nearest_zone(4, 8, 4.0, device=CPU).failover(down, 2)
    np.testing.assert_array_equal(got.assoc.numpy(), np.asarray(want.assoc))
    assert not (got.assoc[10:20] == 2).any()

    r_tv = RefTopology.mobility_walk(3, 5, 40, H=3.0, seed=2)
    p_tv = Topology.mobility_walk(3, 5, 40, H=3.0, seed=2, device=CPU)
    for rt, pt in ((r_tv, p_tv), (RefTopology.uniform(3, 5, 3.0),
                                  Topology.uniform(3, 5, 3.0, device=CPU))):
        np.testing.assert_array_equal(pt.assoc_at(7, 12).numpy(),
                                      np.asarray(rt.assoc_at(7, 12)))
    long_ = Topology.mobility_walk(4, 6, 200, H=4.0, p_handover=0.2, seed=9,
                                   device=CPU)
    short = Topology.mobility_walk(4, 6, 80, H=4.0, p_handover=0.2, seed=9,
                                   device=CPU)
    assert long_.prefix(80).T == 80
    np.testing.assert_array_equal(long_.prefix(80).assoc.numpy(),
                                  short.assoc.numpy())
    with pytest.raises(ValueError, match="K >= 2"):
        Topology.hotspot(1, 8, 4.0, device=CPU)
    with pytest.raises(ValueError, match="K >= 2"):
        Topology.uniform(1, 8, 4.0, device=CPU).failover(down, 0)


@pytest.mark.parametrize("case", ["N", "covers", "H_k", "ids"])
def test_validate_topology_errors_match_reference(case):
    def make(T, arr):
        if case == "N":
            return T.uniform(2, 8, 4.0), (10, 6)
        if case == "covers":
            return T.mobility_walk(2, 8, 20, H=4.0), (50, 8)
        if case == "H_k":
            return T(assoc=arr(np.zeros(8, np.int32)),
                     H_k=arr(np.ones(3, np.float32)), K=2), (10, 8)
        return T(assoc=arr(np.full(8, 2, np.int32)),
                 H_k=arr(np.ones(2, np.float32)), K=2), (10, 8)

    r_topo, shape = make(RefTopology, jnp.asarray)
    with pytest.raises(ValueError) as want:
        ref_validate(r_topo, *shape)
    p_topo, _ = make(CPU_TOPOLOGY, torch.as_tensor)
    with pytest.raises(ValueError) as got:
        validate_topology(p_topo, *shape)
    assert str(got.value) == str(want.value)


def test_streaming_association_waits_for_a5():
    """The streaming walk (ROADMAP A5, now ported): its boundary states
    equal the reference's, and interop carries the reference's over."""
    got = Topology.mobility_walk(2, 8, 64, H=4.0, streaming=True,
                                 device=CPU)
    sw = RefTopology.mobility_walk(2, 8, 64, H=4.0, streaming=True)
    assert got.streaming and sw.streaming
    np.testing.assert_array_equal(got.assoc.entry.numpy(),
                                  np.asarray(sw.assoc.entry))
    carried = interop.topology_from(sw, device=CPU)
    np.testing.assert_array_equal(carried.assoc_at(0, 64).numpy(),
                                  np.asarray(sw.assoc_at(0, 64)))


# --------------------------------------------------------------------------
# per-cloudlet admission

@pytest.mark.parametrize("smallest_first", [False, True])
def test_admission_matches_reference_and_brute_force(smallest_first):
    rng = np.random.default_rng(0)
    N, K = 40, 5
    for trial in range(5):
        off = rng.random(N) < 0.7
        h = rng.uniform(0.1, 1.0, N)
        assoc = rng.integers(0, K, N)
        H_k = rng.uniform(0.5, 2.0, K)
        ref_args = (jnp.asarray(off), jnp.asarray(h, jnp.float32),
                    jnp.asarray(assoc, jnp.int32),
                    jnp.asarray(H_k, jnp.float32))
        want = np.asarray(ref_bl.admit_by_capacity_topo(
            *ref_args, smallest_first=smallest_first))
        args = (torch.as_tensor(off), torch.as_tensor(h, dtype=torch.float32),
                torch.as_tensor(assoc, dtype=torch.int32),
                torch.as_tensor(H_k, dtype=torch.float32))
        for fn in (bl.admit_by_capacity_topo,
                   bl.admit_by_capacity_topo_onehot):
            got = fn(*args, smallest_first=smallest_first).numpy()
            np.testing.assert_array_equal(got, want, err_msg=str(trial))
        # brute force: the cumsum-prefix rule per cloudlet (a task that
        # does not fit still counts against the prefix)
        brute = np.zeros(N, bool)
        order = (np.argsort(np.where(off, h, np.inf), kind="stable")
                 if smallest_first else np.arange(N))
        used = np.zeros(K)
        for n in order:
            used[assoc[n]] += h[n] if off[n] else 0.0
            brute[n] = off[n] and used[assoc[n]] <= H_k[assoc[n]]
        np.testing.assert_array_equal(want, brute)
        # a (T, N) batch admits each row as the single-slot call does
        batch = bl.admit_by_capacity_topo(
            torch.stack([args[0], args[0].flip(0)]),
            torch.stack([args[1], args[1].flip(0)]),
            torch.stack([args[2], args[2].flip(0)]), args[3],
            smallest_first=smallest_first)
        flip = bl.admit_by_capacity_topo(
            *(a.flip(0) for a in args[:3]), args[3],
            smallest_first=smallest_first)
        np.testing.assert_array_equal(batch[0].numpy(), want)
        np.testing.assert_array_equal(batch[1].numpy(), flip.numpy())


def test_admission_k1_is_scalar_rule():
    rng = np.random.default_rng(1)
    off = torch.as_tensor(rng.random(16) < 0.6)
    h = torch.as_tensor(rng.uniform(0.1, 1.0, 16), dtype=torch.float32)
    H = torch.tensor(2.5)
    for sf in (False, True):
        assert torch.equal(bl.admit_by_capacity_topo(off, h, None, H[None],
                                                     sf),
                           bl.admit_by_capacity(off, h, H, sf))


# --------------------------------------------------------------------------
# the K-vector OnAlgo step

def test_step_matches_reference():
    rng = np.random.default_rng(3)
    N, M, K, T = 12, 9, 3, 6
    o = rng.uniform(0.05, 0.3, M).astype(np.float32)
    h = rng.uniform(1.0, 3.0, M).astype(np.float32)
    w = rng.uniform(-0.05, 0.4, M).astype(np.float32)
    o[0] = h[0] = w[0] = 0.0
    B = np.full(N, 0.05, np.float32)
    H = np.float32(6.0)
    H_k = np.array([1.0, 2.5, 0.8], np.float32)
    j = rng.integers(0, M, (T, N)).astype(np.int32)
    assoc = rng.integers(0, K, (T, N)).astype(np.int32)
    rule = RefRule.inv_sqrt(0.5)
    r_params = RefParams(B=jnp.asarray(B), H=jnp.asarray(H))
    p_params = interop.onalgo_params_from(leaves(r_params), device=CPU)
    p_rule = interop.step_rule_from(leaves(rule))
    r_tab = tuple(jnp.asarray(x) for x in (o, h, w))
    p_tab = tuple(torch.as_tensor(x) for x in (o, h, w))
    r_state = ref_onalgo.init_state(N, M, K=K)
    p_state = onalgo.init_state(N, M, K=K, device=CPU)
    for t in range(T):
        r_now = [jnp.asarray(x)[j[t]] for x in (o, h, w)]
        r_state, r_off = ref_onalgo.step(
            r_state, jnp.asarray(j[t]), *r_now, jnp.asarray(j[t] > 0),
            r_tab, r_params, rule, assoc=jnp.asarray(assoc[t]),
            H_k=jnp.asarray(H_k))
        jt = torch.as_tensor(j[t])
        p_state, p_off = onalgo.step(
            p_state, jt, *(x[jt.long()] for x in p_tab), jt > 0, p_tab,
            p_params, p_rule, assoc=torch.as_tensor(assoc[t]),
            H_k=torch.as_tensor(H_k))
        np.testing.assert_array_equal(p_off.numpy(), np.asarray(r_off))
        np.testing.assert_allclose(p_state.lam.numpy(),
                                   np.asarray(r_state.lam), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(p_state.mu.numpy(),
                                   np.asarray(r_state.mu), rtol=RTOL,
                                   atol=ATOL)
    assert p_state.mu.shape == (K,) and float(p_state.mu.max()) > 0
    with pytest.raises(ValueError, match="together"):
        onalgo.step(p_state, jt, *p_tab, jt > 0, p_tab, p_params, p_rule,
                    assoc=torch.as_tensor(assoc[0]))
    with pytest.raises(ValueError, match="use_kernel"):
        onalgo.step(p_state, jt, *p_tab, jt > 0, p_tab, p_params, p_rule,
                    use_kernel=True, assoc=torch.as_tensor(assoc[0]),
                    H_k=torch.as_tensor(H_k))


# --------------------------------------------------------------------------
# the plain K-vector rollout against the reference's kernels and oracle

def _topo_rollout_inputs(N, M, T, K, seed, static=False, slot_values=False):
    rng = np.random.default_rng(seed)
    x = dict(
        j=rng.integers(0, M, (T, N)).astype(np.int32),
        lam0=rng.random(N, dtype=np.float32) * np.float32(0.1),
        mu0=np.zeros(K, np.float32),
        counts0=np.zeros((N, M), np.float32),
        o=rng.random(M, dtype=np.float32),
        h=rng.random(M, dtype=np.float32),
        w=rng.random(M, dtype=np.float32) - np.float32(0.2),
        B=rng.random(N, dtype=np.float32) + np.float32(0.05),
        H=np.float32(0.0))
    topo = (RefTopology.hotspot(K, N, jnp.float32(N * 0.1)) if static
            else RefTopology.mobility_walk(K, N, T, H=jnp.float32(N * 0.1),
                                           p_handover=0.1, seed=K))
    x["assoc"], x["H_k"] = np.asarray(topo.assoc), np.asarray(topo.H_k)
    if slot_values:
        x["sv"] = (rng.random((T, N), dtype=np.float32),
                   rng.random((T, N), dtype=np.float32),
                   rng.random((T, N), dtype=np.float32) - np.float32(0.1))
    return x


_ORDER = ("j", "lam0", "mu0", "counts0", "o", "h", "w", "B", "H")


def _assert_topo_rollouts(got, want, K):
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[5], np.asarray(want[5]))
    assert got[1].shape == (got[0].shape[0], K) and got[4].shape == (K,)
    for i in (1, 2, 3, 4):
        np.testing.assert_allclose(got[i], np.asarray(want[i]), rtol=RTOL,
                                   atol=ATOL, err_msg=str(i))


@pytest.mark.parametrize("N,M,T,chunk,block_n,K,static,slot_values,t0", [
    (20, 16, 64, 8, None, 4, False, False, 0),   # the reference's cases
    (20, 16, 64, 8, 8, 4, False, False, 0),
    (24, 37, 96, 16, 8, 16, False, False, 0),
    (8, 16, 64, 8, 8, 3, False, False, 0),
    (50, 23, 40, 8, 16, 130, False, False, 0),
    (16, 9, 32, 8, None, 4, True, True, 0),      # static map + overlay
    (16, 9, 32, 8, 8, 4, True, True, 0),
    (20, 16, 32, 8, None, 5, False, True, 24),   # walk resumed at t0
    (20, 16, 32, 8, 8, 5, False, False, 24),
])
def test_plain_rollout_matches_reference_kernels(N, M, T, chunk, block_n, K,
                                                 static, slot_values, t0):
    """The port's plain K-vector rollout == the reference's Pallas kernel
    in both TPU layouts (binned and one-hot) and its oracle."""
    x = _topo_rollout_inputs(N, M, T, K, N + M + K, static, slot_values)
    r_args = [jnp.asarray(x[n]) for n in _ORDER] + [0.4, 0.5]
    sv = None if "sv" not in x else tuple(jnp.asarray(s) for s in x["sv"])
    topo = dict(assoc=jnp.asarray(x["assoc"]), H_k=jnp.asarray(x["H_k"]))
    p_sv = None if sv is None else tuple(torch.as_tensor(s)
                                         for s in x["sv"])
    got = k.onalgo_chunked_plain(
        *(torch.as_tensor(x[n]) for n in _ORDER), 0.4, 0.5, t0=t0,
        slot_values=p_sv, assoc=torch.as_tensor(x["assoc"]),
        H_k=torch.as_tensor(x["H_k"]))
    got = [g.numpy() for g in got]
    want = ref_kernels.onalgo_chunked_ref(*r_args, t0=t0, slot_values=sv,
                                          **topo)
    _assert_topo_rollouts(got, want, K)
    for binned in (False, True):
        kw = dict(chunk=chunk, t0=t0, slot_values=sv, topo_binned=binned,
                  interpret=True, **topo)
        out = (onalgo_chunked_pallas(*r_args, **kw) if block_n is None
               else onalgo_tiled_pallas(*r_args, block_n=block_n, **kw))
        _assert_topo_rollouts(got, out, K)
    assert got[4].max() > 0  # the per-cloudlet duals engaged


def test_ops_topology_contract():
    x = _topo_rollout_inputs(6, 5, 16, 3, 1)
    args = [torch.as_tensor(x[n]) for n in _ORDER] + [0.4, 0.5]
    a, H_k = torch.as_tensor(x["assoc"]), torch.as_tensor(x["H_k"])
    want = k.onalgo_chunked_plain(*args, t0=3, assoc=a, H_k=H_k)
    for fn in (ops.onalgo_chunked, ops.onalgo_tiled):
        for binned in (None, True, False):
            got = fn(*args, chunk=8, t0=3, assoc=a, H_k=H_k,
                     topo_binned=binned)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
        with pytest.raises(ValueError, match="together"):
            fn(*args, chunk=8, H_k=H_k)
        with pytest.raises(TypeError, match="topo_binned"):
            fn(*args, chunk=8, assoc=a, H_k=H_k, topo_binned="binned")
    with pytest.raises(ValueError, match="together"):
        k.onalgo_chunked_plain(*args, assoc=a)
    with pytest.raises(ValueError, match="CUDA tensor"):
        k.onalgo_chunked_topo_cuda(*args, assoc=a, H_k=H_k)


# --------------------------------------------------------------------------
# engines

def _problem(N=10, T=53, seed=5, num_w=3, cap=1.2e8):
    space = default_paper_space(num_w=num_w)
    trace, _ = iid_trace(space, TraceSpec(T=T, N=N, seed=seed))
    params = RefParams(B=jnp.full((N,), 0.08, jnp.float32),
                       H=jnp.float32(N * cap))
    return trace, space.tables(), params, RefRule.inv_sqrt(0.5)


def _port_problem(trace, tables, params, rule):
    return (interop.trace_from(leaves(trace), device=CPU),
            tuple(torch.as_tensor(np.asarray(t)) for t in tables),
            interop.onalgo_params_from(leaves(params), device=CPU),
            interop.step_rule_from(leaves(rule)))


@pytest.fixture(scope="module")
def k4_problem():
    trace, tables, params, rule = _problem(N=10, T=53)
    topo = RefTopology.mobility_walk(4, 10, 53, H=params.H, p_handover=0.1,
                                     seed=1)
    kw = dict(topology=topo, enforce_slot_capacity=True)
    refs = {"scan": ref_fleet.simulate(trace, tables, params, rule, **kw),
            "chunked": ref_fleet.simulate_chunked(trace, tables, params,
                                                  rule, chunk=8, **kw),
            "tiled": ref_fleet.simulate_chunked(trace, tables, params, rule,
                                                chunk=8, block_n=8, **kw)}
    return _port_problem(trace, tables, params, rule), _port_topo(topo), refs


@pytest.mark.parametrize("engine", ["scan", "chunked", "tiled"])
def test_engines_match_reference(k4_problem, engine):
    """Port engines at K=4 (mobility) against the reference's scan,
    chunked and tiled engines; T=53 leaves a 5-slot tail."""
    args, topo, refs = k4_problem
    kw = dict(topology=topo, enforce_slot_capacity=True, device=CPU)
    if engine == "scan":
        s, f = fleet.simulate(*args, **kw)
    else:
        s, f = fleet.simulate_chunked(
            *args, chunk=8, block_n=None if engine == "chunked" else 8, **kw)
    assert s["mu_k"].shape == (53, 4) and float(s["mu"].max()) > 0
    for ref_name, (r_s, r_f) in refs.items():
        assert set(s) == set(r_s)
        for key in r_s:
            np.testing.assert_allclose(s[key].numpy(), np.asarray(r_s[key]),
                                       rtol=2e-5, atol=1e-5,
                                       err_msg=f"{ref_name}/{key}")
        np.testing.assert_allclose(f.mu.numpy(), np.asarray(r_f.mu),
                                   rtol=1e-4, atol=1e-6)


def test_engines_k1_and_longer_map(k4_problem):
    """K=1 equals the scalar path exactly on every port engine, and a walk
    covering more slots than the rollout equals the exact-length one."""
    args, _, _ = k4_problem
    N = args[0].N
    kw = dict(enforce_slot_capacity=True, device=CPU)
    runs = {"scan": lambda **t: fleet.simulate(*args, **kw, **t),
            "chunked": lambda **t: fleet.simulate_chunked(*args, chunk=8,
                                                          **kw, **t),
            "tiled": lambda **t: fleet.simulate_chunked(*args, chunk=8,
                                                        block_n=8, **kw,
                                                        **t)}
    k1 = Topology.uniform(1, N, args[2].H, device=CPU)
    long_ = Topology.mobility_walk(4, N, 100, H=args[2].H, p_handover=0.1,
                                   seed=3, device=CPU)
    for name, run in runs.items():
        scalar, _ = run()
        with_k1, _ = run(topology=k1)
        for key in scalar:
            assert torch.equal(with_k1[key], scalar[key]), (name, key)
        assert torch.equal(with_k1["mu_k"][:, 0], scalar["mu"])
        s_long, _ = run(topology=long_)
        s_exact, _ = run(topology=long_.prefix(53))
        for key in s_exact:
            assert torch.equal(s_long[key], s_exact[key]), (name, key)
    with pytest.raises(ValueError, match="use_kernel"):
        fleet.simulate(*args, topology=long_, use_kernel=True, device=CPU)


@pytest.mark.parametrize("K", [1, 2])
def test_true_rho_series_match_reference(K):
    """with_true_rho with and without K-row capacity duals, against the
    reference; Theorem 1(b) holds with the per-cloudlet sigma_g."""
    trace, tables, params, rule = _problem(N=6, T=120)
    M = tables[0].shape[-1]
    rho = np.full((6, M), 1.0 / M, np.float32)
    r_topo = None if K == 1 else RefTopology.uniform(K, 6, params.H)
    r_s, _ = ref_fleet.simulate(trace, tables, params, rule,
                                topology=r_topo, with_true_rho=True,
                                true_rho=jnp.asarray(rho))
    args = _port_problem(trace, tables, params, rule)
    p_topo = None if r_topo is None else _port_topo(r_topo)
    s, fin = fleet.simulate(*args, topology=p_topo, with_true_rho=True,
                            true_rho=torch.as_tensor(rho), device=CPU)
    assert set(s) == set(r_s)
    for key in r_s:
        np.testing.assert_allclose(s[key].numpy(), np.asarray(r_s[key]),
                                   rtol=2e-5, atol=1e-5, err_msg=key)
    sg = theory.sigma_g(args[1], args[2].B, args[2].H, 6,
                        H_k=None if p_topo is None else p_topo.H_k)
    lam_fin = float(torch.sqrt(torch.sum(fin.lam**2) + torch.sum(fin.mu**2)))
    terms = theory.theorem1_terms(s, lam_fin, 0.5, 0.5, sg)
    assert theory.positive_violation(s) <= terms["viol_bound"] + 1e-6
    assert theory.empirical_violation(s) >= theory.positive_violation(s)
    if K == 2:
        assert s["g_cap"].shape == (120, 2)


# --------------------------------------------------------------------------
# the service tier

SVC = dict(num_devices=6, T=203, B_n=0.06, H=1.5 * 441e6, seed=4)


def test_service_k1_equals_scalar_path_on_every_engine():
    sim = SimConfig(algo="onalgo", **SVC)
    pool = synthetic_pool()
    want = simulate_service(sim, pool, device=CPU)
    topo = Topology.uniform(1, 6, sim.H, device=CPU)
    for kw in ({}, dict(engine="chunked", chunk=8),
               dict(engine="chunked", chunk=8, block_n=8)):
        got = simulate_service(sim, pool, topology=topo, device=CPU, **kw)
        for key in METRICS:
            assert got[key] == want[key], (kw, key)


@pytest.mark.parametrize("cap", [6, 2])
def test_service_k4_matches_reference(cap):
    """K=4 mobility, the reference's configuration (cap 6: tasks admitted)
    and a tight one (cap 2: the per-cloudlet duals end above 0)."""
    cfg = dict(num_devices=8, T=203, algo="onalgo", B_n=0.06,
               H=cap * 441e6, seed=4)
    r_topo = RefTopology.mobility_walk(4, 8, 203, H=cfg["H"],
                                       p_handover=0.05, seed=2)
    r_pool = ref_sim.synthetic_pool()
    r_sim = ref_sim.SimConfig(**cfg)
    refs = {e: ref_sim.simulate_service(r_sim, r_pool, engine=e, chunk=8,
                                        topology=r_topo)
            for e in ("scan", "chunked")}
    topo = _port_topo(r_topo)
    sim, pool = SimConfig(**cfg), synthetic_pool()
    assert refs["scan"]["admit_frac" if cap == 6 else "mu_final"] > 0
    for kw in ({}, dict(engine="chunked", chunk=8),
               dict(engine="chunked", chunk=8, block_n=8, topo_binned=True),
               dict(engine="chunked", chunk=8, topo_binned=False)):
        got = simulate_service(sim, pool, topology=topo, device=CPU, **kw)
        for name, want in refs.items():
            for key in METRICS:
                assert got[key] == pytest.approx(want[key], rel=2e-5,
                                                 abs=1e-5), (kw, name, key)


def test_service_hotspot_admits_less_under_cloud():
    sim = SimConfig(num_devices=8, T=120, algo="cloud", seed=3, H=4 * 441e6)
    pool = synthetic_pool()
    topo = Topology.hotspot(4, 8, sim.H, hot_frac=0.5, device=CPU)
    out = simulate_service(sim, pool, topology=topo, device=CPU)
    flat = simulate_service(sim, pool, device=CPU)
    assert out["admit_frac"] < flat["admit_frac"]
    r_out = ref_sim.simulate_service(
        ref_sim.SimConfig(num_devices=8, T=120, algo="cloud", seed=3,
                          H=4 * 441e6), ref_sim.synthetic_pool(),
        topology=RefTopology.hotspot(4, 8, 4 * 441e6, hot_frac=0.5))
    for key in METRICS:
        assert out[key] == pytest.approx(r_out[key], rel=2e-5, abs=1e-5)


def test_service_topology_mismatch_rejected():
    sim = SimConfig(num_devices=6, T=64, seed=0)
    with pytest.raises(ValueError, match="N=4"):
        simulate_service(sim, synthetic_pool(), device=CPU,
                         topology=Topology.uniform(2, 4, sim.H, device=CPU))


# --------------------------------------------------------------------------
# carrying a reference state over

def test_resume_reference_k_state_in_port():
    """Run the reference for T1 slots under a K=3 walk, hand its (K,)
    state to the port, continue T2 slots through ops.onalgo_chunked with
    the walk's slots (T1, T1 + T2]: matches the reference oracle's single
    T1 + T2 run."""
    N, M, K, T1, T2 = 9, 11, 3, 24, 40
    rng = np.random.default_rng(12)
    o = rng.uniform(0.1, 0.4, M).astype(np.float32)
    h = rng.uniform(1.0, 3.0, M).astype(np.float32)
    w = rng.uniform(-0.05, 0.3, M).astype(np.float32)
    o[0] = h[0] = w[0] = 0.0
    j = rng.integers(0, M, (T1 + T2, N)).astype(np.int32)
    B = np.full((N,), 0.08, np.float32)
    H = np.float32(4.0)
    rule = RefRule.inv_sqrt(0.5)
    r_params = RefParams(B=jnp.asarray(B), H=jnp.asarray(H))
    r_tables = tuple(jnp.asarray(x) for x in (o, h, w))
    r_topo = RefTopology.mobility_walk(K, N, T1 + T2, H=H, p_handover=0.1,
                                       seed=7)
    r_trace = ref_fleet.Trace(j_idx=jnp.asarray(j[:T1]),
                              d_local=jnp.zeros((T1, N), jnp.float32))
    _, r_state = ref_fleet.simulate(r_trace, r_tables, r_params, rule,
                                    topology=r_topo)

    state = interop.onalgo_state_from(leaves(r_state), device=CPU)
    params = interop.onalgo_params_from(leaves(r_params), device=CPU)
    topo = _port_topo(r_topo)
    assert state.mu.shape == (K,) and state.rho.t == T1
    o_s, h_s, B1, H1 = onalgo.precondition_tables(
        torch.as_tensor(o), torch.as_tensor(h), params)
    out = ops.onalgo_chunked(
        torch.as_tensor(j[T1:]), state.lam, state.mu, state.rho.counts, o_s,
        h_s, torch.as_tensor(w), B1, H1, 0.5, 0.5, chunk=8, t0=T1,
        assoc=topo.assoc_at(T1, T2), H_k=topo.H_k / params.H)

    want = ref_kernels.onalgo_chunked_ref(
        jnp.asarray(j), jnp.zeros(N), jnp.zeros(K), jnp.zeros((N, M)),
        r_tables[0] / r_params.B[:, None], jnp.asarray(h / H),
        jnp.asarray(w), jnp.ones(N), jnp.float32(1.0), rule.a, rule.beta,
        assoc=r_topo.assoc, H_k=r_topo.H_k / H)
    want = [np.asarray(x) for x in want]
    np.testing.assert_array_equal(out[0].numpy(), want[0][T1:])
    np.testing.assert_array_equal(out[5].numpy(), want[5])
    for got, ref_ in ((out[1], want[1][T1:]), (out[2], want[2][T1:]),
                      (out[3], want[3]), (out[4], want[4])):
        np.testing.assert_allclose(got.numpy(), ref_, rtol=RTOL, atol=ATOL)
    assert float(out[4].max()) > 0  # the per-cloudlet duals are live


@pytest.mark.parametrize("N,K", [(1, 1), (7, 3), (500, 9), (20000, 1024)])
def test_segment_sums_match_index_add(N, K):
    """``onalgo.segment_sums`` (the card's per-cloudlet load, repeatable)
    against the CPU's ``index_add_`` in device order: exact on integer
    rows (every partial sum exact in both), within rtol 1e-5 on random
    rows (float32 left-to-right against float64 rounded once); empty
    cloudlets sum to 0."""
    g = torch.Generator().manual_seed(N + K)
    ids = torch.randint(0, K, (N,), generator=g)
    ints = torch.randint(0, 5, (N,), generator=g).float()
    want = torch.zeros(K).index_add_(0, ids, ints)
    assert torch.equal(onalgo.segment_sums(ints, ids, K), want)
    rows = torch.rand(N, generator=g)
    want = torch.zeros(K).index_add_(0, ids, rows)
    torch.testing.assert_close(onalgo.segment_sums(rows, ids, K), want,
                               rtol=1e-5, atol=1e-6)
    assert float(onalgo.segment_sums(rows, ids, K + 2)[K:].abs().sum()) == 0
