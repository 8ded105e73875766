"""The port's scenario engine against the JAX package: the registry (every
kind and the modifier chains), the YAML catalog and the port's reader of
it, the runner on the scan and chunked engines, and the sweeps (scan and
the cell-axis chunked engine), plus the cell-axis plan and plain version.

Inputs are the reference's compiled scenarios and grids handed over as
numpy leaves (``interop``), or the port's own compilation of the same
spec, which must equal the reference's exactly (numpy RNG, the counter
streams, the topology constructors).  Bars are the reference's own
(tests/test_scenarios.py): decisions, admits, task counts and visit
counts exactly; duals rtol=1e-5, atol=1e-6; series and metrics rtol=2e-5,
atol=1e-5.  The reference's chunked sweep runs its Pallas kernels in
interpret mode, as its own tests run them.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from repro import scenarios as ref
from repro.core import StepRule as RefRule
from repro_torch import interop
from repro_torch import scenarios as sc
from repro_torch.core import fleet
from repro_torch.core.onalgo import OnAlgoParams, StepRule
from repro_torch.kernels import onalgo_step as k
from repro_torch.scenarios import catalog

CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-6
REL, ABS = 2e-5, 1e-5
EXACT = ("offloads", "admits", "tasks")
RULE, REF_RULE = StepRule.inv_sqrt(0.5), RefRule.inv_sqrt(0.5)
_SMS, _OPTIN = 132, 232448  # an H100 SXM: SMs, opt-in shared memory a block
REPO = Path(__file__).resolve().parents[1]


def _small(spec, T=300):
    return dataclasses.replace(spec, T=T)


def _port(spec):
    return sc.Scenario.from_dict(spec.to_dict())


def _assert_compiled_equal(got, want):
    """A port compilation equal to the reference's, exactly."""
    assert got.scenario.to_dict() == want.scenario.to_dict()
    np.testing.assert_array_equal(got.trace.j_idx.numpy(),
                                  np.asarray(want.trace.j_idx))
    np.testing.assert_array_equal(got.trace.d_local.numpy(),
                                  np.asarray(want.trace.d_local))
    for x, y in zip(got.tables, want.tables):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    np.testing.assert_array_equal(got.params.B.numpy(),
                                  np.asarray(want.params.B))
    np.testing.assert_array_equal(got.params.H.numpy(),
                                  np.asarray(want.params.H))
    assert (got.true_rho is None) == (want.true_rho is None)
    if want.true_rho is not None:
        np.testing.assert_array_equal(got.true_rho.numpy(),
                                      np.asarray(want.true_rho))
    assert set(got.meta) == set(want.meta)
    for key, v in want.meta.items():
        np.testing.assert_array_equal(np.asarray(got.meta[key]),
                                      np.asarray(v), err_msg=key)
    assert (got.topology is None) == (want.topology is None)
    if want.topology is not None:
        assert got.topology.K == want.topology.K
        np.testing.assert_array_equal(got.topology.assoc.numpy(),
                                      np.asarray(want.topology.assoc))
        np.testing.assert_array_equal(got.topology.H_k.numpy(),
                                      np.asarray(want.topology.H_k))


def _assert_series_close(got, want, keys=None):
    for key in keys or want:
        g, w = got[key].numpy(), np.asarray(want[key])
        if key in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=REL, atol=ABS,
                                       err_msg=key)


# --------------------------------------------------------------------------
# registry

def test_kinds_and_modifiers_are_the_reference_s():
    assert sc.names() == ref.names()
    assert sorted(sc.MODIFIERS) == sorted(ref.MODIFIERS)
    assert [s.to_dict() for s in sc.default_scenarios()] == \
        [s.to_dict() for s in ref.default_scenarios()]


@pytest.mark.parametrize("spec", ref.default_scenarios(),
                         ids=lambda s: s.kind)
def test_kind_compiles_like_the_reference(spec):
    """Every registered kind at a reduced T=300, N=8: trace, tables,
    params, true_rho, the meta arrays and the topology equal the
    reference's exactly; the spec round-trips through (JSON) dicts."""
    spec = _small(spec)
    port = _port(spec)
    assert sc.Scenario.from_dict(json.loads(json.dumps(port.to_dict()))) \
        == port
    _assert_compiled_equal(sc.compile_scenario(port, device=CPU),
                           ref.compile_scenario(spec))


def test_modifier_chain_three_deep_like_the_reference():
    """flash_crowd + outage + churn over bursty_counter, composed spec by
    spec, equal to the reference's chain; its scan run equals the
    reference's and the chunked run agrees, with no offload while down."""
    kw = dict(T=320, N=8, seed=5)
    specs = [ref.Scenario("bursty_counter", **kw),
             ref.Scenario("flash_crowd", **kw),
             ref.Scenario("outage", **kw).with_extra(n_outages=1,
                                                     outage_len=60),
             ref.Scenario("churn", **kw).with_extra(churn_frac=0.3)]
    want = ref.compose(ref.compose(ref.compose(specs[0], specs[1]),
                                   specs[2]), specs[3])
    got = sc.compose(sc.compose(sc.compose(_port(specs[0]), _port(specs[1]),
                                           device=CPU), _port(specs[2])),
                     _port(specs[3]))
    _assert_compiled_equal(got, want)
    s_ref, _, _ = ref.run_scenario(want, rule=REF_RULE, engine="scan",
                                   use_kernel=False)
    s1, _, _ = sc.run_scenario(got, rule=RULE, engine="scan")
    s2, _, _ = sc.run_scenario(got, rule=RULE, engine="chunked", chunk=8)
    _assert_series_close(s1, s_ref)
    _assert_series_close(s2, s_ref, ("reward", "offloads", "tasks", "mu"))
    assert s1["offloads"].numpy()[got.meta["down"]].sum() == 0


def test_registry_rejects_what_the_reference_rejects():
    with pytest.raises(KeyError):
        sc.compile_scenario(sc.Scenario("no_such_kind"), device=CPU)
    with pytest.raises(ValueError, match="different fleets"):
        sc.compose(sc.Scenario("stationary", T=50, N=4),
                   sc.Scenario("churn", T=60, N=4), device=CPU)
    with pytest.raises(KeyError, match="modifier"):
        sc.compose(sc.Scenario("stationary", T=50, N=4),
                   sc.Scenario("stationary", T=50, N=4), device=CPU)
    with pytest.raises(ValueError, match="already carries one"):
        sc.compose(sc.Scenario("mobility", T=50, N=4),
                   sc.Scenario("hotspot", T=50, N=4), device=CPU)


def test_interop_hands_over_a_compiled_scenario():
    want = ref.compile_scenario(ref.Scenario("cloudlet_outage", T=120, N=8)
                                .with_extra(K=4, outage_len=40))
    _assert_compiled_equal(interop.compiled_scenario_from(want, device=CPU),
                           want)


# --------------------------------------------------------------------------
# catalog

_MINI = ("name: mini\n"
         "base: {kind: stationary, T: 120, N: 4, seed: 1}\n"
         "modifiers:\n"
         "  - {kind: churn, extra: {churn_frac: 0.5}}\n")


def test_catalog_files_are_the_reference_s():
    ours = sorted(catalog.catalog_dir().glob("*.yaml"))
    theirs = sorted(Path(ref.catalog_dir()).glob("*.yaml"))
    assert [p.name for p in ours] == [p.name for p in theirs]
    for a, b in zip(ours, theirs):
        assert a.read_bytes() == b.read_bytes(), a.name
    assert sc.catalog_names() == ref.catalog_names()


@pytest.mark.parametrize("doc", [p.name for p in sorted(
    (REPO / "src/repro_torch/scenarios/catalog").glob("*.yaml"))]
    + ["mini"])
def test_reader_gives_what_safe_load_gives(doc):
    text = (_MINI if doc == "mini"
            else (catalog.catalog_dir() / doc).read_text())
    assert catalog.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: [1, 2]\n", "a: true\n", "a:\n", "a: 0x1f\n", "a: &x 1\n",
    "a: 'q'\n", "a: 1\n  b: 2\n", "a: {b: 1\n", "a: 1\na: 2\n",
    "a: ~\n", "---\na: 1\n", "a: 2001-12-14\n", "a: |\n  text\n",
])
def test_reader_rejects_what_is_outside_the_subset(text):
    with pytest.raises(catalog.CatalogSyntaxError):
        catalog.parse_yaml(text)


@pytest.mark.parametrize("name", ref.catalog_names())
def test_compile_named_equals_the_reference(name):
    entry, want_entry = sc.load_catalog()[name], ref.load_catalog()[name]
    assert entry.base.to_dict() == want_entry.base.to_dict()
    assert [m.to_dict() for m in entry.modifiers] == \
        [m.to_dict() for m in want_entry.modifiers]
    _assert_compiled_equal(sc.compile_named(name, device=CPU),
                           ref.compile_named(name))


def test_catalog_entry_inherits_the_base_fleet(tmp_path):
    f = tmp_path / "mini.yaml"
    f.write_text(_MINI)
    entry = sc.load_entry(f)
    assert (entry.modifiers[0].T, entry.modifiers[0].N) == (120, 4)
    assert "arrive" in entry.compile(device=CPU).meta
    with pytest.raises(KeyError, match="catalog"):
        sc.compile_named("no_such_workload", device=CPU)


def test_port_imports_neither_jax_nor_yaml():
    """The port (and chip_smoke.py) import no JAX, nothing of the JAX
    package and no YAML package: the catalog has its own reader."""
    files = sorted((REPO / "src/repro_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]
    for f in files:
        for line in f.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1].split(".")[0]
                assert mod not in ("jax", "jaxlib", "yaml", "repro"), \
                    (f.name, line)


# --------------------------------------------------------------------------
# runner

@pytest.mark.parametrize("kind", ["stationary", "churn_outage", "mobility"])
def test_run_scenario_matches_the_reference(kind):
    """run_scenario on scan, chunked (the plain K1, chunk 8) and chunked
    block_n=16 (the plain K2) against the reference's scan run, for a
    stationary, a doubled-state-space and a topology kind."""
    spec = _small(next(s for s in ref.default_scenarios() if s.kind == kind))
    want_c = ref.compile_scenario(spec)
    want, wf, _ = ref.run_scenario(want_c, rule=REF_RULE, engine="scan",
                                   use_kernel=False)
    c = sc.compile_scenario(_port(spec), device=CPU)
    for kw in (dict(engine="scan"), dict(engine="chunked", chunk=8),
               dict(engine="chunked", chunk=8, block_n=16)):
        got, gf, _ = sc.run_scenario(c, rule=RULE, **kw)
        _assert_series_close(got, want)
        np.testing.assert_allclose(gf.lam.numpy(), np.asarray(wf.lam),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(gf.mu.numpy(), np.asarray(wf.mu),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(gf.rho.counts.numpy(),
                                      np.asarray(wf.rho.counts))


def test_stadium_flash_outage_never_offloads_while_down():
    c = sc.compile_named("stadium_flash_outage", device=CPU)
    down = c.meta["down"]
    for kw in (dict(engine="scan"), dict(engine="chunked", chunk=8)):
        s, _, _ = sc.run_scenario(c, rule=RULE, **kw)
        off = s["offloads"].numpy()
        assert off[down].sum() == 0 and off[~down].sum() > 0


def test_engine_resolution_goes_by_the_device():
    """'auto' resolves by the run's device (not by what the machine has);
    scan-only options pin 'auto' to scan and make an explicit 'chunked'
    raise, as in the reference."""
    assert sc.resolve_engine("auto", "cpu") == "scan"
    assert sc.resolve_engine("auto", "cuda") == "chunked"
    assert sc.resolve_use_kernel("auto", "cpu") is False
    assert sc.resolve_use_kernel("auto", torch.device("cuda")) is True
    with pytest.raises(ValueError):
        sc.resolve_engine("warp", "cpu")
    c = sc.compile_scenario(sc.Scenario("stationary", T=40, N=4), device=CPU)
    s, _, _ = sc.run_scenario(c, rule=RULE, with_true_rho=True)
    assert "f_true" in s
    with pytest.raises(ValueError, match="with_true_rho"):
        sc.run_scenario(c, rule=RULE, engine="chunked", with_true_rho=True)
    with pytest.raises(ValueError, match="OnAlgo"):
        sc.run_scenario(c, rule=RULE, engine="chunked", algo="ato")
    m = sc.compile_scenario(sc.Scenario("mobility", T=40, N=4), device=CPU)
    with pytest.raises(ValueError, match="multi-cloudlet"):
        sc.run_scenario(m, rule=RULE, engine="scan", use_kernel=True)


# --------------------------------------------------------------------------
# sweeps

def _grids(N, H, **values):
    want = ref.product_grid(N, H_values=(H,), **values)
    return interop.sweep_grid_from(want, device=CPU), want


def test_scan_sweep_matches_the_reference():
    spec = ref.Scenario("stationary", T=300, N=8, seed=11)
    want_c = ref.compile_scenario(spec)
    c = sc.compile_scenario(_port(spec), device=CPU)
    grid, want_grid = _grids(8, spec.H, a_values=(0.2, 0.5),
                             beta_values=(0.0, 0.5), B_values=(0.04, 0.08))
    assert grid.G == want_grid.G == 8
    assert grid.labels == want_grid.labels
    want, wf = ref.sweep_simulate(want_c.trace, want_c.tables, want_grid)
    got, gf = sc.sweep_simulate(c.trace, c.tables, grid, device=CPU)
    _assert_series_close(got, want)
    np.testing.assert_allclose(gf.lam.numpy(), np.asarray(wf.lam),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gf.mu.numpy(), np.asarray(wf.mu), rtol=RTOL,
                               atol=ATOL)
    # and each cell is the port's own simulate, bit for bit
    for g in range(grid.G):
        s, f = fleet.simulate(c.trace, c.tables, *reversed(grid.cell(g)),
                              device=CPU)
        for key in s:
            assert torch.equal(got[key][g], s[key]), (g, key)


def test_true_rho_sweep_matches_the_reference():
    """The Theorem-1 series of a scan sweep (tests/test_scenarios.py's
    true_rho case) against the reference's, at the cross-engine bar."""
    from repro.core import default_paper_space
    from repro.data.traces import TraceSpec, iid_trace
    trace, rho = iid_trace(default_paper_space(num_w=4),
                           TraceSpec(T=200, N=4, seed=13))
    tables = default_paper_space(num_w=4).tables()
    grid, want_grid = _grids(4, 4 * 1e8, a_values=(0.5,), beta_values=(0.5,),
                             B_values=(0.08,))
    want, _ = ref.sweep_simulate(trace, tables, want_grid, true_rho=rho,
                                 with_true_rho=True)
    got, _ = sc.sweep_simulate(
        interop.trace_from(trace, device=CPU),
        tuple(torch.tensor(np.asarray(t)) for t in tables), grid,
        true_rho=torch.tensor(np.asarray(rho)), with_true_rho=True,
        device=CPU)
    assert got["f_true"].shape == (1, 200)
    _assert_series_close(got, want)


def test_chunked_sweep_matches_the_reference_chunked_sweep():
    """The cell-axis chunked sweep (the plain K1 / K2 with a cell axis, T =
    120, N = 8, G = 8) against the reference's chunked sweep (the Pallas
    kernels in interpret mode): decisions and counts exactly, the rest at
    the bars; and bit for bit with a loop of the port's per-cell
    simulate_chunked calls."""
    spec = ref.Scenario("stationary", T=120, N=8, seed=11)
    want_c = ref.compile_scenario(spec)
    c = sc.compile_scenario(_port(spec), device=CPU)
    grid, want_grid = _grids(8, spec.H, a_values=(0.2, 0.5),
                             beta_values=(0.0, 0.5), B_values=(0.04, 0.08))
    want, wf = ref.sweep_simulate(want_c.trace, want_c.tables, want_grid,
                                  engine="chunked", chunk=8,
                                  enforce_slot_capacity=True)
    for block_n in (None, 4):
        got, gf = sc.sweep_simulate(c.trace, c.tables, grid,
                                    engine="chunked", chunk=8,
                                    block_n=block_n,
                                    enforce_slot_capacity=True, device=CPU)
        _assert_series_close(got, want)
        np.testing.assert_array_equal(gf.rho.counts.numpy(),
                                      np.asarray(wf.rho.counts))
        np.testing.assert_allclose(gf.lam.numpy(), np.asarray(wf.lam),
                                   rtol=RTOL, atol=ATOL)
        for g in range(grid.G):
            rule, params = grid.cell(g)
            s, f = fleet.simulate_chunked(c.trace, c.tables, params, rule,
                                          chunk=8, block_n=block_n,
                                          enforce_slot_capacity=True,
                                          device=CPU)
            for key in s:
                assert torch.equal(got[key][g], s[key]), (g, key)
            assert torch.equal(gf.rho.counts[g], f.rho.counts)


def test_sweep_grids_and_options():
    params = OnAlgoParams(B=torch.full((4,), 0.08), H=torch.tensor(5e8))
    grid = sc.grid_from_cells([("r1", StepRule.constant(0.02), params),
                               ("r2", StepRule.inv_sqrt(0.5), params)])
    assert grid.G == 2 and grid.rules.a.shape == (2,)
    c = sc.compile_scenario(sc.Scenario("stationary", T=60, N=4, seed=12),
                            device=CPU)
    series, _ = sc.sweep_simulate(c.trace, c.tables, grid, device=CPU)
    out = dict(sc.unstack_series(series, grid))
    assert set(out) == {"r1", "r2"} and out["r1"]["reward"].shape == (60,)
    with pytest.raises(ValueError):
        sc.stack_params([params, dataclasses.replace(params,
                                                     precondition=False)])
    with pytest.raises(ValueError, match="scan-only"):
        sc.sweep_simulate(c.trace, c.tables, grid, engine="chunked",
                          with_true_rho=True, device=CPU)
    with pytest.raises(ValueError, match="engine"):
        sc.sweep_simulate(c.trace, c.tables, grid, engine="warp",
                          device=CPU)
    series, _ = sc.sweep_simulate(c.trace, c.tables, grid,
                                  true_rho=c.true_rho, with_true_rho=True,
                                  device=CPU)
    assert series["f_true"].shape == (2, 60)
    # a chunked sweep of a stateless policy, and one without the
    # preconditioner (tables shared by the cells)
    s, _ = sc.sweep_simulate(c.trace, c.tables, grid, algo="cloud",
                             engine="chunked", device=CPU)
    assert torch.equal(s["offloads"][0], s["tasks"][0])
    raw = sc.grid_from_cells([(l, grid.rules.cell(i), dataclasses.replace(
        params, precondition=False)) for i, l in enumerate(grid.labels)])
    s, _ = sc.sweep_simulate(c.trace, c.tables, raw, engine="chunked",
                             device=CPU)
    for g in range(2):
        want, _ = fleet.simulate_chunked(c.trace, c.tables,
                                         *reversed(raw.cell(g)), device=CPU)
        assert torch.equal(s["lam_norm"][g], want["lam_norm"])


# --------------------------------------------------------------------------
# the cell axis of K1 / K2: plain version and plan

def test_cells_plain_is_a_loop_of_single_cell_plain_calls():
    g = np.random.default_rng(3)
    G, N, M, T = 3, 7, 13, 24
    f = lambda *shape: torch.tensor(g.random(shape, dtype=np.float32))
    j = torch.tensor(g.integers(0, M, (T, N)), dtype=torch.int32)
    o, h, w = f(G, N, M), f(G, 1, M), f(M) - 0.2
    B, H = f(G, N) + 0.05, f(G) * 0.1 * N
    a, beta = np.float32([0.3, 0.5, 0.9]), np.float32([0.5, 0.0, 0.5])
    lam0, mu0, counts0 = f(G, N) * 0.1, f(G) * 0.1, f(G, N, M).floor()
    got = k.onalgo_cells_plain(j, lam0, mu0, counts0, o, h, w, B, H, a,
                               beta, t0=5)
    assert [x.shape for x in got] == [(G, T, N), (G, T), (G, T), (G, N),
                                      (G,), (G, N, M)]
    for c in range(G):
        want = k.onalgo_chunked_plain(j, lam0[c], mu0[c], counts0[c], o[c],
                                      h[c, 0], w, B[c], H[c], a[c], beta[c],
                                      t0=5)
        for x, y in zip(got, want):
            assert torch.equal(x[c], y)


# (lane groups, passes a slot) of the plans below, by (G, N)
_CELLS_LANES = {(64, 8): (1, 1), (16, 8192): (8, 2), (64, 5000): (8, 3),
                (3, 20_000): (3, 2), (5, 20_000): (4, 4)}


@pytest.mark.parametrize("G,N,M,T,counts_max,hw_dev,route,groups,V", [
    (64, 8, 37, 4000, 0, False, "cells", 1, 1),     # 9c (i): a block a cell
    (16, 8192, 37, 512, 0, False, "cells", 1, 16),  # 9c (ii): one launch
    (64, 5000, 37, 8, 0, False, "cells", 2, 20),    # split in two groups
    # per > the single call's block: lane groups of 128, two tiles a block
    (3, 20_000, 37, 16, 0, False, "cells", 1, 3),
    (5, 20_000, 37, 16, 0, False, "cells", 1, 5),   # V = 5 on 4 groups
    (3, 300, 37, 16, 65_535 - 15, False, "per-cell", 3, 1),  # past uint16
    (3, 300, 37, 16, 0, True, "per-cell", 3, 1),    # per-device h / w
    (2, 400_000, 73, 16, 0, False, "per-cell", 2, 1),  # K1 streams
])
def test_cells_plan_groups_the_cells(G, N, M, T, counts_max, hw_dev, route,
                                     groups, V):
    """The cell-axis plan, pure Python: each cell cut as its single-cell
    call is, its devices on lane groups of that call's width (min(per, its
    block)), V virtual blocks a block within the opt-in shared memory, the
    most lane groups whose one o' stage each fits, ceil(V / groups) passes
    of a virtual block's tiles a slot, the grid split into launches where
    that costs fewer passes, one cell a launch on K1's own route where
    that route is not resident."""
    plan = k.cells_plan(G, N, M, T, counts_max, _OPTIN, _SMS, 264, 16,
                        hw_per_device=hw_dev)
    assert (plan.route, len(plan.groups), plan.V) == (route, groups, V)
    assert (plan.lane_groups, plan.passes) == _CELLS_LANES.get((G, N),
                                                              (1, 0))
    assert sum(n for _, n in plan.groups) == G
    assert [g0 for g0, _ in plan.groups] == list(np.cumsum(
        [0] + [n for _, n in plan.groups])[:-1])
    if route == "cells":
        single = plan.single
        assert single.route == "resident"
        width, P, S = plan.group_width, plan.lane_groups, plan.stages
        assert width == min(single.per, 32 * single.warps)
        assert plan.passes == -(-plan.V // P) * -(-single.per // width)
        assert plan.smem == k.cells_smem(single.per, M, width, P, S, plan.V,
                                         True) <= _OPTIN
        assert P <= plan.V and P * width <= k.CELLS_MAX_THREADS
        assert P == min(plan.V, k.CELLS_MAX_GROUPS,
                        k.CELLS_MAX_THREADS // width) or k.cells_smem(
            single.per, M, width, P + 1, 1, plan.V, True) > _OPTIN
        assert 1 <= S <= -(-plan.V // P) * -(-single.per // width)
        assert plan.grid <= _SMS
        assert "launch" in plan.why and f"{P} lane group" in plan.why
        assert f"{plan.passes} pass" in plan.why
    else:
        assert "own route" in plan.why
