"""The port's gain tier against the JAX package: the numpy predictor, the
ridge and SSD gain models, the gain sources (snap, quantile, the resolved
tables), the trivial sources' bit identity on every engine and under a
topology, the frozen-pool round trip, the decision stream under a ridge
source, the regret harness, the SSD head's training and the ridge's checkpoints
(either package's loads in the other).

Bars: the predictor, the ridge model and ModelGain's tables (snapped or
not) are EQUAL to the reference's — numpy on both sides, and the ridge's
features and dot reproduce the reference's compiled float32 arithmetic
(``gain/model.py``).  The SSD head at K4's plain bar (rtol = atol = 1e-4,
tests/test_kernels.py), since the chunk recurrence sums in another order.
Decisions exactly; metrics of the trivial sources exactly.
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fleet as ref_fleet
from repro.data import predictor as ref_pred
from repro.gain import model as ref_model
from repro.gain import regret as ref_regret
from repro.gain import source as ref_source
from repro.gain import train as ref_train
from repro.serve import compile as ref_compile
from repro.serve import simulator as ref_sim
from repro_torch import interop
from repro_torch.core import fleet
from repro_torch.data import predictor
from repro_torch.gain import (GATE_SCENARIOS, ModelGain, OverlayGain,
                              SeqGainConfig, SeqGainModel,
                              TableGain, as_gain_source, default_sources,
                              fit_ridge_gain, load_ridge, oracle_pool,
                              save_ridge, scenario_regret, snap_to_grid,
                              synthetic_gain_problem, trace_history,
                              train_seq_gain)
from repro_torch.gain import source as gs
from repro_torch.gain.model import init_seq_params
from repro_torch.serve.compile import compile_service
from repro_torch.serve.simulator import (SimConfig, simulate_service,
                                         synthetic_pool)
from repro_torch.topology import Topology

CPU = "cpu"
METRICS = ("accuracy", "offload_frac", "admit_frac", "avg_power_per_dev",
           "avg_load", "avg_delay_ms", "tasks", "mu_final")
SSD_TOL = dict(rtol=1e-4, atol=1e-4)
ENGINES = {"scan": dict(engine="scan"),
           "chunked": dict(engine="chunked", chunk=8),
           "tiled": dict(engine="chunked", chunk=8, block_n=3),
           "streaming": dict(engine="chunked", chunk=8, materialize=False,
                             slab=32)}

# torch's first large float32 exp in a process that has loaded JAX is now
# and then off (ROADMAP.md C7); the SSD head takes exps
torch.exp(torch.zeros(1 << 16))


def _random_probs(rng, S, C):
    logits = rng.normal(0.0, 1.5, (S, C))
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return p / p.sum(-1, keepdims=True)


@pytest.fixture(scope="module")
def problem():
    """(probs, gains, port oracle pool, reference oracle pool), S=256."""
    probs, gains = synthetic_gain_problem(S=256, seed=0)
    return (probs, gains, oracle_pool(probs, gains, seed=0),
            ref_train.oracle_pool(probs, gains, seed=0))


@pytest.fixture(scope="module")
def ridge(problem):
    probs, gains, _, _ = problem
    return (fit_ridge_gain(probs, gains, device=CPU),
            ref_train.fit_ridge_gain(probs, gains))


def test_synthetic_problem_and_pool_match_reference():
    probs, gains = synthetic_gain_problem(S=300, C=7, seed=4)
    rp, rg = ref_train.synthetic_gain_problem(S=300, C=7, seed=4)
    assert np.array_equal(probs, rp) and np.array_equal(gains, rg)
    pool, rpool = oracle_pool(probs, gains, 4), ref_train.oracle_pool(
        rp, rg, 4)
    for k in ("local_correct", "cloud_correct", "d_local", "phi_hat",
              "sigma", "cycles"):
        assert np.array_equal(getattr(pool, k), getattr(rpool, k)), k


@pytest.mark.parametrize("class_specific,thin", [(True, False),
                                                 (False, False),
                                                 (True, True)])
def test_predictor_matches_reference(class_specific, thin):
    """The numpy GainPredictor equals the reference's, including the
    thin-class fallback to the general fit AND its sigma."""
    rng = np.random.default_rng(2)
    C = 4
    probs = _random_probs(rng, 300, C)
    if thin:  # class 3 appears exactly once
        order = np.argsort(probs, axis=-1)
        for i in np.flatnonzero(probs.argmax(-1) == 3)[1:]:
            a, b = order[i, -1], order[i, -2]
            probs[i, a], probs[i, b] = probs[i, b], probs[i, a]
        assert (probs.argmax(-1) == 3).sum() == 1
    gains = np.clip(0.3 * (1 - probs.max(-1)) + rng.normal(0, 0.02, 300),
                    0, 1)
    got = predictor.GainPredictor(class_specific=class_specific).fit(
        probs, gains)
    want = ref_pred.GainPredictor(class_specific=class_specific).fit(
        probs, gains)
    assert np.array_equal(got.coefs, want.coefs)
    assert np.array_equal(got.sigma, want.sigma)
    assert all(np.array_equal(a, b) for a, b in zip(
        got.predict(probs), want.predict(probs)))
    carried = interop.gain_predictor_from(want)
    assert np.array_equal(carried.predict(probs)[0], want.predict(probs)[0])
    if thin:
        gen = predictor.GainPredictor(class_specific=False).fit(probs, gains)
        assert np.array_equal(got.coefs[3], gen.coefs[0])
        assert got.sigma[3] == gen.sigma[0] > 0


def test_calibrate_matches_reference():
    """``calibrate`` over any pair with local_probs / cloud_probs."""
    rng = np.random.default_rng(5)
    lp, cp = _random_probs(rng, 200, 5), _random_probs(rng, 200, 5)
    y = rng.integers(0, 5, 200)

    class Pair:
        local_probs = staticmethod(lambda x: lp[np.asarray(x)])
        cloud_probs = staticmethod(lambda x: cp[np.asarray(x)])

    x = np.arange(200)
    got = predictor.calibrate(Pair, x, y)
    want = ref_pred.calibrate(Pair, x, y)
    assert np.array_equal(got.coefs, want.coefs)
    from repro_torch.gain import gain_pairs
    assert all(np.array_equal(a, b) for a, b in zip(
        gain_pairs(Pair, x, y), ref_train.gain_pairs(Pair, x, y)))


@pytest.mark.parametrize("S,seed,class_specific", [
    (256, 0, True), (1000, 7, True), (600, 3, False)])
def test_ridge_apply_matches_reference(S, seed, class_specific):
    """RidgeGainModel.apply == the reference's jitted ``_ridge_apply`` bit
    for bit (its float32 log, the fused multiply-adds, the dot's order)."""
    probs, gains = synthetic_gain_problem(S=S, seed=seed)
    want_model = ref_train.fit_ridge_gain(probs, gains,
                                          class_specific=class_specific)
    p32 = probs.astype(np.float32)
    want = [np.asarray(x) for x in want_model.apply(jnp.asarray(p32))]
    for model in (fit_ridge_gain(probs, gains, class_specific=class_specific,
                                 device=CPU),
                  interop.ridge_gain_model_from(want_model, device=CPU)):
        got = model.apply(torch.tensor(p32))
        assert np.array_equal(got[0].numpy(), want[0])
        assert np.array_equal(got[1].numpy(), want[1])


@pytest.mark.parametrize("seed,num_levels", [(0, 2), (1, 8), (2, 16),
                                             (3, 12)])
def test_snap_and_quantile_match_reference(seed, num_levels):
    """snap_to_grid, its levels (jnp.linspace as compiled) and the
    0.999 quantile equal the reference's bit for bit."""
    rng = np.random.default_rng(seed)
    vals = rng.uniform(0, 1, 257).astype(np.float32)
    hi = np.float32(rng.uniform(0.1, 1.0))
    got = snap_to_grid(torch.tensor(vals), num_levels, torch.tensor(hi))
    want = np.asarray(ref_source.snap_to_grid(vals, num_levels, hi))
    assert np.array_equal(got.numpy(), want)
    levels = np.asarray(jnp.linspace(0.0, jnp.float32(hi), num_levels)
                        .astype(jnp.float32))
    assert np.array_equal(gs.grid_levels(num_levels, torch.tensor(hi))
                          .numpy(), levels)
    assert np.isin(got.numpy(), levels).all()
    q = gs.quantile_f32(torch.tensor(vals[: 50 + 37 * seed]), 0.999)
    assert q.item() == np.float32(jnp.quantile(
        jnp.asarray(vals[: 50 + 37 * seed]), 0.999))


@pytest.mark.parametrize("quantize,num_w", [(True, 8), (True, 4),
                                            (False, 8)])
def test_model_gain_tables_match_reference(problem, ridge, quantize, num_w):
    """ModelGain(ridge)'s resolved tables and space equal the
    reference's, snapped or not; snapped tables lie on the grid."""
    probs, _, pool, rpool = problem
    sim = SimConfig(num_devices=4, T=50, seed=1, num_w_levels=num_w)
    rsim = ref_sim.SimConfig(num_devices=4, T=50, seed=1,
                             num_w_levels=num_w)
    src = ModelGain(ridge[0], probs, quantize=quantize)
    ref = ref_source.ModelGain(ridge[1], probs, quantize=quantize)
    gt, space = src.resolve(pool, sim, device=CPU)
    want = ref.tables(rpool, rsim)
    assert np.array_equal(gt.phi_hat.numpy(), np.asarray(want.phi_hat))
    assert np.array_equal(gt.sigma.numpy(), np.asarray(want.sigma))
    want_space = ref.space(rpool, rsim)
    for k in ("o_levels", "h_levels", "w_levels"):
        assert getattr(space, k) == getattr(want_space, k), k
    if quantize:
        assert len(np.unique(gt.phi_hat.numpy())) <= num_w
    carried = interop.gain_source_from(ref, device=CPU)
    assert torch.equal(carried.tables(pool, sim, device=CPU).phi_hat,
                       gt.phi_hat)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_trivial_sources_reproduce_default(engine):
    """"table" / "overlay" / TableGain() / OverlayGain() == gain_source=None,
    metrics exactly, on scan, chunked (K1), tiled (K2) and streaming."""
    pool = synthetic_pool(seed=2)
    sim = SimConfig(num_devices=4, T=96, seed=5)
    ref = simulate_service(sim, pool, device=CPU, **ENGINES[engine])
    for src in ("table", "overlay", TableGain(), OverlayGain()):
        out = simulate_service(sim, pool, gain_source=src, device=CPU,
                               **ENGINES[engine])
        assert all(out[k] == ref[k] for k in METRICS), (src, engine)


@pytest.mark.parametrize("engine", ["scan", "chunked"])
def test_topology_k_gt_1_bit_identical(engine):
    """Per-cloudlet duals (K = 4) replay identically under the overlay
    and table sources."""
    pool = synthetic_pool(seed=2)
    sim = SimConfig(num_devices=8, T=96, seed=6)
    topo = Topology.hotspot(4, 8, H=8e8, device=CPU)
    ref = simulate_service(sim, pool, topology=topo, device=CPU,
                           **ENGINES[engine])
    for src in (OverlayGain(), TableGain()):
        out = simulate_service(sim, pool, topology=topo, gain_source=src,
                               device=CPU, **ENGINES[engine])
        assert all(out[k] == ref[k] for k in METRICS), (src, engine)


def test_ridge_source_decisions_match_reference(problem, ridge):
    """The decision stream under ModelGain(ridge) equals the reference's
    fleet.simulate on its own compile with the same source, and the port's
    engines agree on it."""
    probs, _, pool, rpool = problem
    sim = SimConfig(num_devices=6, T=100, seed=3)
    rsim = ref_sim.SimConfig(num_devices=6, T=100, seed=3)
    rcs = ref_compile.compile_service(
        rsim, rpool, gain_source=ref_source.ModelGain(ridge[1], probs))
    want, _ = ref_fleet.simulate(rcs.trace, rcs.tables, rcs.params,
                                 rcs.rule, overlay=rcs.overlay,
                                 enforce_slot_capacity=True,
                                 collect_decisions=True)
    src = ModelGain(ridge[0], probs)
    cs = compile_service(sim, pool, gain_source=src, device=CPU)
    assert np.array_equal(cs.trace.j_idx.numpy(),
                          np.asarray(rcs.trace.j_idx))
    got, _ = fleet.simulate(*cs.simulate_args(), cs.rule, overlay=cs.overlay,
                            enforce_slot_capacity=True,
                            collect_decisions=True, device=CPU)
    for key in ("offload_mask", "admit_mask"):
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
    scan = simulate_service(sim, pool, gain_source=src, device=CPU)
    for kw in list(ENGINES.values())[1:]:
        out = simulate_service(sim, pool, gain_source=src, device=CPU, **kw)
        assert all(out[k] == pytest.approx(scan[k], rel=2e-5, abs=1e-5)
                   for k in METRICS), kw


@pytest.mark.parametrize("seed,num_w", [(0, 4), (1, 8), (2, 12)])
def test_frozen_pool_round_trips_bit_identically(seed, num_w):
    """ModelGain -> to_pool_tables -> TableGain replays the live model's
    metrics exactly."""
    probs, gains = synthetic_gain_problem(S=128, seed=seed)
    pool = oracle_pool(probs, gains, seed=seed)
    sim = SimConfig(num_devices=4, T=80, seed=seed, num_w_levels=num_w)
    mg = ModelGain(fit_ridge_gain(probs, gains, device=CPU), probs)
    live = simulate_service(sim, pool, gain_source=mg, device=CPU)
    frozen = mg.to_pool_tables(pool, sim, device=CPU)
    replay = simulate_service(sim, frozen, gain_source=TableGain(),
                              device=CPU)
    assert all(replay[k] == live[k] for k in METRICS)


def test_as_gain_source_coercion_and_errors(problem, ridge):
    assert isinstance(as_gain_source(None), TableGain)
    assert isinstance(as_gain_source("overlay"), OverlayGain)
    src = TableGain()
    assert as_gain_source(src) is src
    with pytest.raises(ValueError, match="unknown gain source"):
        as_gain_source("no_such_source")
    with pytest.raises(TypeError):
        as_gain_source(42)
    probs, _, pool, _ = problem
    sim = SimConfig(num_devices=4, T=50, seed=1)
    with pytest.raises(ValueError, match="does not cover"):
        ModelGain(ridge[0], probs[:10]).tables(pool, sim, device=CPU)


def _ref_seq_model(C):
    cfg = ref_model.SeqGainConfig(feat_dim=C + 4)
    params = ref_model.init_seq_params(jax.random.PRNGKey(3), cfg)
    sigma = jnp.linspace(0.01, 0.05, C).astype(jnp.float32)
    return ref_model.SeqGainModel(cfg=cfg, params=params, sigma=sigma)


def test_seq_head_matches_reference(problem):
    """SeqGainModel.apply on params carried from the reference equals the
    reference's seq_apply at K4's plain bar (S=256: two 128-slot chunks);
    a seeded head resolves through ModelGain on every engine."""
    probs, _, pool, _ = problem
    ref = _ref_seq_model(probs.shape[1])
    p32 = probs.astype(np.float32)
    want = [np.asarray(x) for x in ref.apply(jnp.asarray(p32))]
    model = interop.seq_gain_model_from(ref, device=CPU)
    got = model.apply(torch.tensor(p32))
    np.testing.assert_allclose(got[0].numpy(), want[0], **SSD_TOL)
    assert np.array_equal(got[1].numpy(), want[1])
    cfg = SeqGainConfig(feat_dim=probs.shape[1] + 4)
    seeded = SeqGainModel(cfg=cfg, params=init_seq_params(
        torch.Generator().manual_seed(0), cfg, device=CPU),
        sigma=torch.full((probs.shape[1],), 0.02))
    sim = SimConfig(num_devices=4, T=64, seed=2)
    runs = [simulate_service(sim, pool, gain_source=ModelGain(m, probs),
                             device=CPU, **kw)
            for m in (model, seeded) for kw in (ENGINES["scan"],
                                                ENGINES["streaming"])]
    for a, b in ((runs[0], runs[1]), (runs[2], runs[3])):
        assert all(a[k] == pytest.approx(b[k], rel=2e-5, abs=1e-5)
                   for k in METRICS)


def test_trace_history_matches_reference(problem):
    probs, gains, _, _ = problem
    kw = dict(T=128, N=4, seq_len=32, seed=1)
    got = trace_history(probs, gains, device=CPU, **kw)
    want = ref_train.trace_history(probs, gains, **kw)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_scenario_regret_matches_reference(problem, ridge):
    """Per-source accuracy, offload share and tasks on 'stationary' at
    max_T=150 equal the reference's harness (one reference call)."""
    probs, _, pool, rpool = problem
    got = scenario_regret({"table": TableGain(), "overlay": "overlay",
                           "ridge": ModelGain(ridge[0], probs)}, pool,
                          scenario="stationary", max_T=150, device=CPU)
    want = ref_regret.scenario_regret(
        {"table": ref_source.TableGain(), "overlay": "overlay",
         "ridge": ref_source.ModelGain(ridge[1], probs)}, rpool,
        scenario="stationary", max_T=150)
    assert got == want
    assert got["table"]["regret"] == got["overlay"]["regret"] == 0.0
    assert GATE_SCENARIOS == ref_regret.GATE_SCENARIOS


def _seq_flat(t, pre=""):
    if isinstance(t, dict):
        out = {}
        for k, v in t.items():
            out.update(_seq_flat(v, f"{pre}/{k}"))
        return out
    return {pre: np.asarray(t.detach() if hasattr(t, "detach") else t)}


def test_train_seq_gain_matches_reference(problem):
    """train_seq_gain over 8 steps (AdamW at lr 2e-2, batches of 4 windows
    of 64 slots from T=256, N=4) from the reference's initial weights
    (``init_seq_params(PRNGKey(0))``, carried across): the logged losses
    at rtol 1e-5, every weight within 1e-5 of its max |value| and the
    per-class sigma at rtol 1e-5 (measured: 6.6e-7 of max, 3e-7); the
    model resolves on the CPU, and a resumed run from its checkpoint
    continues the history."""
    probs, gains, _, _ = problem
    kw = dict(steps=8, T=256, N=4, seq_len=64, batch=4, seed=0)
    rmodel, rhist = ref_train.train_seq_gain(probs, gains, **kw)
    cfg = ref_model.SeqGainConfig(feat_dim=probs.shape[1] + 4)
    p0 = ref_model.init_seq_params(jax.random.PRNGKey(0), cfg)
    p0 = interop.seq_gain_model_from(ref_model.SeqGainModel(
        cfg, jax.tree.map(np.asarray, p0), jnp.zeros(10)), device=CPU).params
    with tempfile.TemporaryDirectory() as d:
        model, hist = train_seq_gain(probs, gains, params=p0, ckpt_dir=d,
                                     device=CPU, **kw)
        assert [h["step"] for h in hist] == [h["step"] for h in rhist]
        np.testing.assert_allclose([h["loss"] for h in hist],
                                   [h["loss"] for h in rhist], rtol=1e-5)
        got, want = _seq_flat(model.params), _seq_flat(
            jax.tree.map(np.asarray, rmodel.params))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(
                got[k], want[k], rtol=0,
                atol=1e-5 * np.abs(want[k]).max(), err_msg=k)
        np.testing.assert_allclose(model.sigma.numpy(),
                                   np.asarray(rmodel.sigma), rtol=1e-5)
        assert not any(t.requires_grad for t in _iter_tensors(model.params))
        phi, sig = model.apply(torch.tensor(probs, dtype=torch.float32))
        assert phi.shape == sig.shape == (len(gains),)
        # a longer run in the same directory resumes from step 8
        logs = []
        _, hist2 = train_seq_gain(probs, gains, params=p0, ckpt_dir=d,
                                  device=CPU, log_fn=logs.append,
                                  **dict(kw, steps=12))
        assert "[trainer] resumed from step 8" in logs
        assert hist2[-1]["step"] == 12


def _iter_tensors(t):
    if isinstance(t, dict):
        for v in t.values():
            yield from _iter_tensors(v)
    else:
        yield t


def test_ridge_checkpoints_cross_packages(problem, ridge):
    """save_ridge / load_ridge: the port's checkpoint loads in the
    reference and the reference's in the port, coefs and sigma equal."""
    port, ref = ridge
    with tempfile.TemporaryDirectory() as d:
        save_ridge(d, port, step=3)
        back = ref_train.load_ridge(d)
        np.testing.assert_array_equal(np.asarray(back.coefs),
                                      port.coefs.numpy())
        np.testing.assert_array_equal(np.asarray(back.sigma),
                                      port.sigma.numpy())
        ref_train.save_ridge(d, ref, step=5)
        mine = load_ridge(d, device=CPU)  # the latest: the reference's
        np.testing.assert_array_equal(mine.coefs.numpy(),
                                      np.asarray(ref.coefs))
        np.testing.assert_array_equal(load_ridge(d, 3, device=CPU)
                                      .sigma.numpy(), port.sigma.numpy())
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(FileNotFoundError):
            load_ridge(d, device=CPU)


@pytest.mark.parametrize("call", [
    lambda: train_seq_gain(*synthetic_gain_problem(S=64), steps=2, T=64,
                           N=2, seq_len=32, batch=2, device=CPU)[0],
    lambda: save_ridge(_tmpdir(), fit_ridge_gain(
        *synthetic_gain_problem(S=64), device=CPU)),
    lambda: load_ridge(os.path.dirname(save_ridge(_tmpdir(), fit_ridge_gain(
        *synthetic_gain_problem(S=64), device=CPU), step=4)), device=CPU),
    lambda: default_sources(S=16, with_seq=True, seq_steps=2, device=CPU)],
    ids=["train_seq_gain", "save_ridge", "load_ridge", "with_seq"])
def test_trainer_names_raise(call):
    """The names that waited for the trainer (ROADMAP A12) are exported
    and now run: none raises, each returns its object."""
    out = call()
    if isinstance(out, tuple):  # default_sources: the trained seq head
        assert isinstance(out[0]["seq"], ModelGain)
        assert isinstance(out[0]["seq"].model, SeqGainModel)
    else:
        assert out is not None


def _tmpdir():
    return tempfile.mkdtemp(prefix="gain_ckpt_")
