"""The port's service path against the JAX package: compile_service's
arrays, simulate_service's metrics on every ported engine, the golden v0
fixture, carrying state over mid-run, and the port's independence from
JAX.  Metrics bar: the reference's cross-engine bar (rel=2e-5, abs=1e-5,
tests/test_serve.py); golden bar rel=5e-3 (its own, same file).
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fleet as ref_fleet
from repro.core.onalgo import OnAlgoParams as RefParams
from repro.core.onalgo import StepRule as RefRule
from repro.core.state_space import empirical_rho as ref_empirical_rho
from repro.kernels import ref as ref_kernels
from repro.serve import compile as ref_compile
from repro.serve import simulator as ref_sim
from repro_torch import interop
from repro_torch.core import fleet
from repro_torch.core.onalgo import precondition_tables
from repro_torch.core.state_space import empirical_rho
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.serve.admission import quantize_states
from repro_torch.serve.compile import compile_service, service_metrics
from repro_torch.serve.simulator import (RATES, SimConfig, pool_space,
                                         power_of_rate, simulate_service,
                                         synthetic_pool)
from repro_torch.topology import Topology

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "service_legacy_fig5.json"
METRICS = ("accuracy", "offload_frac", "admit_frac", "avg_power_per_dev",
           "avg_load", "avg_delay_ms", "tasks", "mu_final")
ENGINE_CFG = dict(num_devices=5, T=203, B_n=0.06, H=1.5 * 441e6, seed=4)
CPU = "cpu"


def _assert_metrics(got, want, rel=2e-5, abs_=1e-5, what=""):
    assert set(got) == set(want)
    for key in METRICS:
        assert got[key] == pytest.approx(want[key], rel=rel, abs=abs_), \
            (what, key)


@pytest.fixture(scope="module")
def ref_scan():
    """Reference scan-engine metrics per algo (computed once)."""
    pool = ref_sim.synthetic_pool()
    cache = {}

    def get(algo):
        if algo not in cache:
            cache[algo] = ref_sim.simulate_service(
                ref_sim.SimConfig(algo=algo, **ENGINE_CFG), pool)
        return cache[algo]
    return get


@pytest.mark.parametrize("cfg", [
    ENGINE_CFG,
    dict(num_devices=7, T=130, seed=1, zeta=300.0, v_risk=0.3),
])
def test_compile_service_arrays_equal(cfg):
    sim, pool = SimConfig(**cfg), synthetic_pool()
    got = compile_service(sim, pool, device=CPU)
    want = ref_compile.compile_service(ref_sim.SimConfig(**cfg),
                                       ref_sim.synthetic_pool())
    np.testing.assert_array_equal(got.trace.j_idx.numpy(),
                                  np.asarray(want.trace.j_idx))
    np.testing.assert_array_equal(got.trace.d_local.numpy(),
                                  np.asarray(want.trace.d_local))
    for name in ("o", "h", "w", "correct_local", "correct_cloud"):
        np.testing.assert_array_equal(getattr(got.overlay, name).numpy(),
                                      np.asarray(getattr(want.overlay, name)),
                                      name)
    np.testing.assert_array_equal(got.on, want.on)
    for a, b in zip(got.tables, want.tables):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got.trace.j_idx.dtype == torch.int32


def test_compile_service_arrival_override():
    sim = SimConfig(num_devices=4, T=70, seed=2)
    on = np.random.default_rng(0).random((70, 4)) < 0.5
    got = compile_service(sim, synthetic_pool(), on, device=CPU)
    want = ref_compile.compile_service(ref_sim.SimConfig(
        num_devices=4, T=70, seed=2), ref_sim.synthetic_pool(), on)
    np.testing.assert_array_equal(got.on, on)
    np.testing.assert_array_equal(got.trace.j_idx.numpy(),
                                  np.asarray(want.trace.j_idx))


def _gathered(on, img, rates, tables):
    """The value lowering as the lower_values kernel computes it, in plain
    PyTorch: j the rate's part plus the image's where a task arrives, the
    values the records' float32 bits."""
    r, i = rates.long(), img.long()
    f = lambda x: x.view(torch.float32)
    j = torch.where(on, tables.rate_rec[r, 1] + tables.image_rec[i, 0], 0)
    return (j, f(tables.rate_rec[r, 0]),
            *(f(tables.image_rec[i, k]) for k in range(1, 6)))


def _tie_case():
    """Records over a hand-made space whose values sit on level midpoints
    (o 0.5; h 1.5 and 3; w 0.125 and 0.625 after the delay penalty) or
    past the clamps, and a workload that visits every rate and image."""
    from repro_torch.core.state_space import StateSpace
    from repro_torch.kernels.lower_values import value_tables
    space = StateSpace((0.25, 0.75), (1.0, 2.0, 4.0),
                       (0.0, 0.25, 0.5, 0.75, 1.0))
    t = lambda x: torch.tensor(x, dtype=torch.float32)
    S, rng = 6, np.random.default_rng(5)
    tables = value_tables(
        space, t([0.25, 0.5, 0.75, 0.6]), t([1.5, 3.0, 1.0, 5.0, 2.9, 0.0]),
        t([0.1875, 0.6875, 1.5, -0.2, 0.3, 0.4]),
        t([0.0, 0.0, 0.1, 0.3, 0.05, 0.125]), t(rng.random(S)),
        t(rng.random(S) < 0.5), t(rng.random(S) < 0.5), 0.5, 0.0625)
    L, N = 7, 13
    img = torch.from_numpy(rng.integers(0, S, (L, N), dtype=np.int32))
    rates = torch.from_numpy(rng.integers(0, 4, (L, N), dtype=np.int32))
    img[0, :S], rates[1, :4] = torch.arange(S), torch.arange(4)
    on = torch.from_numpy(rng.random((L, N)) < 0.7)
    return on, img, rates, tables


def _pool_case(gain_source):
    """A streamed service's records and its first slab, on the CPU."""
    from repro_torch.serve.compile import compile_service_streaming
    sim = SimConfig(num_devices=37, T=96, B_n=0.06, H=3 * 441e6, seed=6)
    st = compile_service_streaming(sim, synthetic_pool(),
                                   gain_source=gain_source, device=CPU)
    wl = st.wl.slab(0, 64)
    return wl.on, wl.img, wl.rates, st.values


@pytest.mark.parametrize("case", ["ties", "table", "overlay"])
def test_value_tables_gathered_equal_plain_lowering(case):
    """The per-rate and per-image records, gathered, equal the plain
    per-element lowering (``lower_values_plain``, the CPU route of
    ``ops.lower_values``) bit for bit: what the kernel computes on the
    card is then what the plain route computes there."""
    from repro_torch.kernels.lower_values import lower_values_plain
    on, img, rates, tables = (_tie_case() if case == "ties" else _pool_case(
        None if case == "table" else "overlay"))
    want = lower_values_plain(on, img, rates, tables)
    got = _gathered(on, img, rates, tables)
    assert [x.dtype for x in want] == [torch.int32] + [torch.float32] * 6
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(ops.lower_values(on, img, rates, tables), want):
        assert torch.equal(a, b)
    assert int(want[0].max()) < tables.space.M and bool((want[0] > 0).any())


@pytest.mark.parametrize("algo", ["onalgo", "ato", "rco", "ocos", "local",
                                  "cloud"])
def test_scan_metrics_match_reference(ref_scan, algo):
    got = simulate_service(SimConfig(algo=algo, **ENGINE_CFG),
                           synthetic_pool(), engine="scan", device=CPU)
    _assert_metrics(got, ref_scan(algo), what=f"scan {algo}")


@pytest.mark.parametrize("algo", ["onalgo", "local", "cloud"])
@pytest.mark.parametrize("block_n", [None, 8])
def test_chunked_metrics_match_reference(ref_scan, algo, block_n):
    """The reference's cross-engine test: chunked (K1) and tiled (K2)
    engines against the scan engine on the same workload (N=5, T=203:
    neither divides the tile or the chunk)."""
    got = simulate_service(SimConfig(algo=algo, **ENGINE_CFG),
                           synthetic_pool(), engine="chunked", chunk=8,
                           block_n=block_n, device=CPU)
    _assert_metrics(got, ref_scan(algo), what=f"chunked {algo} {block_n}")


def test_use_kernel_scan_matches_reference(ref_scan):
    sim = SimConfig(**ENGINE_CFG)
    cs = compile_service(sim, synthetic_pool(), device=CPU)
    series, _ = fleet.simulate(*cs.simulate_args(), cs.rule,
                               use_kernel=True, enforce_slot_capacity=True,
                               overlay=cs.overlay, device=CPU)
    _assert_metrics(service_metrics(sim, series), ref_scan("onalgo"))


def test_collect_decisions_match_reference():
    cfg = dict(num_devices=6, T=90, B_n=0.06, H=1.0 * 441e6, seed=9)
    cs = compile_service(SimConfig(**cfg), synthetic_pool(), device=CPU)
    rs = ref_compile.compile_service(ref_sim.SimConfig(**cfg),
                                     ref_sim.synthetic_pool())
    got, st = fleet.simulate(*cs.simulate_args(), cs.rule,
                             enforce_slot_capacity=True, overlay=cs.overlay,
                             collect_decisions=True, device=CPU)
    want, ref_st = ref_fleet.simulate(*rs.simulate_args(), rs.rule,
                                      enforce_slot_capacity=True,
                                      overlay=rs.overlay,
                                      collect_decisions=True)
    for key in ("offload_mask", "admit_mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    np.testing.assert_array_equal(st.rho.counts.numpy(),
                                  np.asarray(ref_st.rho.counts))
    np.testing.assert_allclose(st.lam.numpy(), np.asarray(ref_st.lam),
                               rtol=1e-5, atol=1e-6)


def test_interop_replays_reference_compiled_service(ref_scan):
    """The reference's compiled service, handed over as numpy leaves,
    replays through the port's slot loop to the reference's metrics."""
    rs = ref_compile.compile_service(ref_sim.SimConfig(**ENGINE_CFG),
                                     ref_sim.synthetic_pool())
    leaves = lambda x: jax.tree_util.tree_map(np.asarray, x)
    series, _ = fleet.simulate(
        interop.trace_from(leaves(rs.trace), device=CPU),
        tuple(torch.tensor(np.asarray(t)) for t in rs.tables),
        interop.onalgo_params_from(leaves(rs.params), device=CPU),
        interop.step_rule_from(leaves(rs.rule)), enforce_slot_capacity=True,
        overlay=interop.raw_overlay_from(leaves(rs.overlay), device=CPU),
        device=CPU)
    _assert_metrics(service_metrics(SimConfig(**ENGINE_CFG), series),
                    ref_scan("onalgo"))
    pool, want = interop.pool_from(ref_sim.synthetic_pool()), synthetic_pool()
    for name in ("local_correct", "cloud_correct", "d_local", "phi_hat",
                 "sigma", "cycles"):
        np.testing.assert_array_equal(getattr(pool, name),
                                      getattr(want, name))


def test_empirical_rho_matches_reference():
    """Exact counts; the mean's last rounding differs (XLA multiplies by
    1/T, torch divides by T), hence 1 ulp of float32."""
    j = np.random.default_rng(3).integers(0, 9, (40, 6)).astype(np.int32)
    np.testing.assert_allclose(
        empirical_rho(torch.as_tensor(j), 9).numpy(),
        np.asarray(ref_empirical_rho(jnp.asarray(j), 9)), rtol=2 ** -23,
        atol=0)


def _golden():
    return json.loads(GOLDEN.read_text())


@pytest.mark.parametrize("name", ["onalgo", "ato", "rco", "ocos", "local",
                                  "cloud", "onalgo_zeta300"])
def test_golden_v0_replay(name):
    """The pinned v0 workload (tests/legacy_workload.py, numpy only)
    replayed through the port's fleet.simulate + service_metrics."""
    from legacy_workload import legacy_service_workload
    g = _golden()
    entry = g["entries"][name]
    sim = SimConfig(**entry["sim"])
    pool = synthetic_pool(**g["pool"])
    N, T = sim.num_devices, sim.T
    on, img, rates = legacy_service_workload(
        sim.seed, T, N, len(pool.local_correct), len(RATES), sim.burst_len,
        sim.mean_gap)
    o_raw = power_of_rate(RATES[rates])
    h_raw = pool.cycles[img]
    w_raw = np.clip(pool.phi_hat[img] - sim.v_risk * pool.sigma[img],
                    0.0, 1.0)
    if sim.zeta:
        w_raw = np.clip(w_raw - sim.zeta * (sim.d_tr + sim.d_pr_cloud),
                        0.0, 1.0)
    space = pool_space(pool, num_w=sim.num_w_levels, v_risk=sim.v_risk)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    trace = fleet.Trace(
        j_idx=torch.as_tensor(quantize_states(space, o_raw, h_raw, w_raw,
                                              on)),
        d_local=f32(pool.d_local[img]))
    overlay = fleet.RawOverlay(
        o=f32(o_raw), h=f32(h_raw), w=f32(w_raw),
        correct_local=f32(pool.local_correct[img]),
        correct_cloud=f32(pool.cloud_correct[img]))
    params = interop.onalgo_params_from(
        RefParams(B=np.full((N,), sim.B_n, np.float32),
                  H=np.float32(sim.H)), device=CPU)
    series, _ = fleet.simulate(trace, space.tables(CPU), params,
                               interop.step_rule_from(
                                   RefRule.inv_sqrt(sim.step_a)),
                               algo=sim.algo, ato_theta=sim.ato_theta,
                               enforce_slot_capacity=True, overlay=overlay,
                               device=CPU)
    out = service_metrics(sim, series)
    for key in METRICS:
        assert out[key] == pytest.approx(entry["metrics"][key], rel=5e-3,
                                         abs=1e-6), key


def test_resume_reference_state_in_port():
    """Run the reference for T1 slots, hand its final state to the port,
    continue T2 slots through ops.onalgo_chunked(..., t0=T1): matches the
    reference oracle's single T1 + T2 run."""
    N, M, T1, T2 = 9, 11, 24, 40
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
    r_trace = ref_fleet.Trace(j_idx=jnp.asarray(j[:T1]),
                              d_local=jnp.zeros((T1, N), jnp.float32))
    _, r_state = ref_fleet.simulate(r_trace, r_tables, r_params, rule)

    # hand over, as numpy leaves
    state = interop.onalgo_state_from(
        jax.tree_util.tree_map(np.asarray, r_state), device=CPU)
    params = interop.onalgo_params_from(
        jax.tree_util.tree_map(np.asarray, r_params), device=CPU)
    p_rule = interop.step_rule_from(jax.tree_util.tree_map(np.asarray, rule))
    assert state.rho.t == T1
    o_s, h_s, B1, H1 = precondition_tables(torch.as_tensor(o),
                                           torch.as_tensor(h), params)
    off, mu_seq, lnorm, lam, mu, counts = ops.onalgo_chunked(
        torch.as_tensor(j[T1:]), state.lam, state.mu, state.rho.counts,
        o_s, h_s, torch.as_tensor(w), B1, H1, p_rule.a, p_rule.beta,
        chunk=8, t0=T1)

    ro, rh = np.asarray(r_tables[0] / r_params.B[:, None]), h / H
    want = ref_kernels.onalgo_chunked_ref(
        jnp.asarray(j), jnp.zeros(N), jnp.float32(0.0), jnp.zeros((N, M)),
        jnp.asarray(ro), jnp.asarray(rh), jnp.asarray(w), jnp.ones(N),
        jnp.float32(1.0), rule.a, rule.beta)
    want = [np.asarray(x) for x in want]
    np.testing.assert_array_equal(off.numpy(), want[0][T1:])
    np.testing.assert_array_equal(counts.numpy(), want[5])
    for got, ref_, sl in ((mu_seq, want[1], slice(T1, None)),
                          (lnorm, want[2], slice(T1, None)),
                          (lam, want[3], slice(None))):
        np.testing.assert_allclose(got.numpy(), ref_[sl], rtol=1e-5,
                                   atol=1e-6)
    assert float(mu) == pytest.approx(float(want[4]), rel=1e-5, abs=1e-6)
    assert lnorm.numpy().min() > 0  # the duals moved


def test_port_runs_without_jax_or_reference():
    """repro_torch (repro_torch.topology included) and chip_smoke.py
    import neither jax nor repro."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = sys.modules['repro'] = None\n"
        "import importlib, pkgutil, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "from repro_torch.serve.simulator import *\n"
        "from repro_torch.topology import Topology\n"
        "topo = Topology.mobility_walk(2, 3, 40, H=2 * 441e6, "
        "device='cpu')\n"
        "for engine in ('scan', 'chunked'):\n"
        "    for t in (None, topo):\n"
        "        m = simulate_service(SimConfig(num_devices=3, T=40), "
        "synthetic_pool(), engine=engine, topology=t, device='cpu')\n"
        "        assert 0 < m['accuracy'] <= 1, m\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_device_defaults_to_cuda(monkeypatch):
    """device=None means the card, and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    sim = SimConfig(num_devices=2, T=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_service(sim, synthetic_pool())
    cs = compile_service(sim, synthetic_pool(), device=CPU)
    for engine in (fleet.simulate, fleet.simulate_chunked):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            engine(*cs.simulate_args(), cs.rule)


@pytest.mark.parametrize("kw", [
    dict(engine="sharded"), dict(engine="sharded", materialize=False),
    dict(engine="sharded", topology="streaming"),
    dict(gain_source=object())])
def test_unported_paths_raise(kw):
    """The sharded engines (ROADMAP A11) are ported: streamed or not and
    under a streaming walk, ``engine="sharded"`` with ``mesh=None`` runs on
    a world of one (started here, the process group destroyed after) and
    its metrics equal the scan engine's exactly, since a world of one's
    all-reduce adds nothing (four ranks: tests/test_torch_distributed.py).
    Gain sources are ported (tests/test_torch_gain.py): an object that is
    not one is rejected with a TypeError, as the reference's
    ``as_gain_source`` does."""
    import torch.distributed as dist

    sim, pool = SimConfig(num_devices=4, T=40, seed=2), synthetic_pool()
    if "gain_source" in kw:
        with pytest.raises(TypeError, match="not a GainSource"):
            simulate_service(sim, pool, device=CPU, **kw)
        return
    if kw.get("topology") == "streaming":
        kw = dict(kw, topology=Topology.mobility_walk(
            2, 4, 40, H=sim.H, p_handover=0.2, streaming=True, device=CPU))
    assert not dist.is_initialized()
    try:
        got = simulate_service(sim, pool, device=CPU, **kw)
        assert dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()
    want = simulate_service(sim, pool, device=CPU,
                            topology=kw.get("topology"))
    assert got == want


def test_rejections_match_reference():
    pool = synthetic_pool()
    with pytest.raises(ValueError, match="engine"):
        simulate_service(SimConfig(num_devices=4, T=64), pool,
                         engine="warp", device=CPU)
    with pytest.raises(ValueError, match="chunked"):
        simulate_service(SimConfig(num_devices=4, T=64, algo="ato"), pool,
                         engine="chunked", device=CPU)
    with pytest.raises(ValueError, match="retired"):
        simulate_service(SimConfig(num_devices=2, T=40, rng_version=0),
                         pool, device=CPU)
