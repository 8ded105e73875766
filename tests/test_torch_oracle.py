"""The port's analysis layer against the JAX package: the paper's state
space, the fleet traces, the P1 oracle (exact LP and dual ascent) and the
Sec. V extensions (delay penalty, bandwidth dual, pre-classification).

Inputs come from numpy seeds (the traces' own ``default_rng``) and go
through both packages.  Bars: state tables, traces and true rho exactly
(the same numpy draws); the LP solution exactly (the same HiGHS problem on
the same float64 inputs); dual ascent, the pre-classification budget
shift (a float32 sum in another order than XLA's) and the extension
step's duals, ``nu`` and slot delay at the reference's duals' bar
rtol=1e-5, atol=1e-6, its decisions and effective tables exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import OnAlgoParams as RefParams
from repro.core import StepRule as RefRule
from repro.core import default_paper_space as ref_space
from repro.core import extensions as ref_ext
from repro.core import oracle as ref_oracle
from repro.data import traces as ref_traces
from repro_torch.core import default_paper_space, extensions, oracle
from repro_torch.core.onalgo import OnAlgoParams, StepRule
from repro_torch.data import traces

CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("num_w", [4, 8])
def test_default_paper_space_is_the_reference_s(num_w):
    space, want = default_paper_space(num_w), ref_space(num_w)
    assert (space.o_levels, space.h_levels, space.w_levels, space.M) == (
        want.o_levels, want.h_levels, want.w_levels, want.M)
    for x, y in zip(space.tables(CPU), want.tables()):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("gen", ["iid", "iid_probs", "bursty",
                                 "load_profile"])
def test_traces_equal_the_reference_s(gen):
    space, want_space = default_paper_space(4), ref_space(4)
    kw = dict(T=200, N=6, task_prob=0.5, seed=7)
    spec, want_spec = traces.TraceSpec(**kw), ref_traces.TraceSpec(**kw)
    probs = (np.array([0.2, 0.3, 0.5]), np.array([0.6, 0.2, 0.2]),
             np.array([0.1, 0.2, 0.3, 0.4]))
    if gen == "iid":
        got = traces.iid_trace(space, spec, device=CPU)
        want = ref_traces.iid_trace(want_space, want_spec)
    elif gen == "iid_probs":
        got = traces.iid_trace(space, spec, probs, device=CPU)
        want = ref_traces.iid_trace(want_space, want_spec, probs)
    elif gen == "bursty":
        got = traces.bursty_trace(space, spec, device=CPU)
        want = ref_traces.bursty_trace(want_space, want_spec)
    else:
        got = traces.load_profile_trace(space, spec, 3.0, device=CPU)
        want = ref_traces.load_profile_trace(want_space, want_spec, 3.0)
    (trace, rho), (want_trace, want_rho) = got, want
    np.testing.assert_array_equal(trace.j_idx.numpy(),
                                  np.asarray(want_trace.j_idx))
    np.testing.assert_array_equal(trace.d_local.numpy(),
                                  np.asarray(want_trace.d_local))
    np.testing.assert_array_equal(rho.numpy(), np.asarray(want_rho))
    assert trace.j_idx.dtype == torch.int32 and rho.dtype == torch.float32


def _problem(N=4, T=100, seed=1, budget=0.08, cap_frac=0.25):
    """tests/test_core_onalgo.py's oracle setup: the iid true rho of a
    seeded trace, the paper's tables, budgets and capacity."""
    spec = traces.TraceSpec(T=T, N=N, task_prob=0.6, seed=seed)
    space = default_paper_space(4)
    _, rho = traces.iid_trace(space, spec, device=CPU)
    B = np.full(N, budget)
    H = N * cap_frac * 441e6
    return rho, space.tables(CPU), ref_space(4).tables(), B, H


def test_solve_lp_equals_the_reference():
    rho, tables, ref_tables, B, H = _problem()
    y, r = oracle.solve_lp(rho, tables, torch.tensor(B), H)
    y_ref, r_ref = ref_oracle.solve_lp(rho.numpy(), ref_tables, B, H)
    np.testing.assert_array_equal(y, y_ref)
    assert r == r_ref
    # an (N, M) per-device table takes the same LP
    o_nm = tables[0].expand(rho.shape).contiguous() * 1.5
    y2, r2 = oracle.solve_lp(rho, (o_nm, *tables[1:]), B, H)
    y2_ref, r2_ref = ref_oracle.solve_lp(
        rho.numpy(), (o_nm.numpy(), *ref_tables[1:]), B, H)
    np.testing.assert_array_equal(y2, y2_ref)
    assert r2 == r2_ref


def test_solve_dual_ascent_matches_the_reference():
    """N = 4, M = 37, 2000 iterations: y_bar, reward and violation at the
    duals' bar (the primal average of the same threshold policies)."""
    rho, tables, ref_tables, B, H = _problem()
    y, r, v = oracle.solve_dual_ascent(rho, tables, torch.tensor(B),
                                       torch.tensor(H), iters=2000)
    y_ref, r_ref, v_ref = ref_oracle.solve_dual_ascent(
        jnp.asarray(rho.numpy()), ref_tables, jnp.asarray(B, jnp.float32),
        jnp.float32(H), iters=2000)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(r), float(r_ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(v), float(v_ref), rtol=RTOL, atol=ATOL)


def test_ext_step_matches_the_reference():
    """200 slots of the Sec. V step with the delay term (zeta = 1, 50 ms
    tables) and the bandwidth dual (unit loads, W = 0.5): offloads exactly,
    lam, mu, nu and the slot delay at the duals' bar, every slot."""
    N = 8
    space, want_space = default_paper_space(4), ref_space(4)
    spec = traces.TraceSpec(T=200, N=N, seed=5)
    trace, _ = traces.iid_trace(space, spec, device=CPU)
    tables, ref_tables = space.tables(CPU), want_space.tables()
    M = space.M
    params = OnAlgoParams(B=torch.full((N,), 0.08), H=torch.tensor(8e8))
    ref_params = RefParams(B=jnp.full((N,), 0.08), H=jnp.float32(8e8))
    rule, ref_rule = StepRule.inv_sqrt(0.5), RefRule.inv_sqrt(0.5)
    delay = extensions.DelayModel(d_tr=torch.full((M,), 0.05),
                                  d_pr_cloud=torch.full((M,), 0.05))
    ref_delay = ref_ext.DelayModel(d_tr=jnp.full((M,), 0.05, jnp.float32),
                                   d_pr_cloud=jnp.full((M,), 0.05,
                                                       jnp.float32))
    l_tab = torch.ones((M,))
    state = extensions.init_ext_state(N, M, device=CPU)
    ref_state = ref_ext.init_ext_state(N, M)
    o_tab, h_tab, w_tab = tables
    ro, rh, rw = ref_tables
    kw = dict(zeta=1.0, W=0.5)
    for t in range(200):
        j = trace.j_idx[t]
        jr = jnp.asarray(j.numpy())
        state, off, d = extensions.ext_step(
            state, j, o_tab[j.long()], h_tab[j.long()], w_tab[j.long()],
            j > 0, tables, params, rule, delay=delay, l_tab=l_tab, **kw)
        ref_state, ref_off, ref_d = ref_ext.ext_step(
            ref_state, jr, ro[jr], rh[jr], rw[jr], jr > 0, ref_tables,
            ref_params, ref_rule, delay=ref_delay,
            l_tab=jnp.ones((M,), jnp.float32), **kw)
        np.testing.assert_array_equal(off.numpy(), np.asarray(ref_off))
        for x, y in ((state.base.lam, ref_state.base.lam),
                     (state.base.mu, ref_state.base.mu),
                     (state.nu, ref_state.nu), (d, ref_d)):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=RTOL,
                                       atol=ATOL, err_msg=f"slot {t}")
    assert float(state.nu) > 0.0  # the bandwidth price engaged
    # axis_name takes a mesh axis's ProcessGroup, not a name (the sharded
    # step on four ranks: tests/test_torch_distributed.py)
    with pytest.raises(TypeError, match="ProcessGroup"):
        extensions.ext_step(state, j, o_tab[j.long()], h_tab[j.long()],
                            w_tab[j.long()], j > 0, tables, params, rule,
                            axis_name="fleet")


def test_ext_policy_and_preclassification_equal_the_reference():
    space = default_paper_space(4)
    M, N = space.M, 5
    g = np.random.default_rng(2)
    rho = g.dirichlet(np.ones(M), N).astype(np.float32)
    v = np.float32(0.05)
    tables, ref_tables = space.tables(CPU), ref_space(4).tables()
    got = extensions.preclassification_costs(tables[0], torch.tensor(v),
                                             torch.tensor(rho))
    want = ref_ext.preclassification_costs(ref_tables[0], jnp.float32(v),
                                           jnp.asarray(rho))
    # the effective table exactly; the budget shift is a float32 sum over
    # the states, which XLA orders otherwise: the duals' bar
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=RTOL, atol=ATOL)
    state = extensions.init_ext_state(N, M, device=CPU)
    state.base.lam = torch.tensor(g.random(N, dtype=np.float32))
    state.base.mu = torch.tensor(np.float32(2e-9))
    ref_state = ref_ext.init_ext_state(N, M)
    ref_state.base.lam = jnp.asarray(state.base.lam.numpy())
    ref_state.base.mu = jnp.float32(2e-9)
    delay = extensions.DelayModel.paper_defaults(M, device=CPU)
    ref_delay = ref_ext.DelayModel.paper_defaults(M)
    np.testing.assert_array_equal(
        extensions.ext_policy_matrix(state, *tables, zeta=100.0,
                                     delay=delay).numpy(),
        np.asarray(ref_ext.ext_policy_matrix(ref_state, *ref_tables,
                                             zeta=100.0, delay=ref_delay)))
