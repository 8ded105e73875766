"""OnAlgo — the paper's online selective-offloading algorithm (Algorithm 1).

Port of ``repro/core/onalgo.py``.  Per slot t, with duals lambda_t (N,)
and mu_t ():

  primal (eq. 7):  offload iff  lambda_n o_n^j + mu h_n^j < w_n^j
  dual ascent (eqs. 8-9), with the policy over all states weighted by the
  running empirical distribution rho_t:
      lambda_{n,t+1} = [lambda_nt + a_t (sum_j o_n^j rho_t^j y_n^j - B_n)]^+
      mu_{t+1}       = [mu_t + a_t (sum_n sum_j h_n^j rho_t^j y_n^j - H)]^+

Plain functions on tensors; ``step`` returns a new state.  Under a
multi-cloudlet topology mu is a (K,) vector: device n is priced by
``mu[assoc[n]]`` and each cloudlet's dual ascends on the load of its own
devices (``capacity_loads``).

The sharded forms take ``axis_name``, the mesh axis's ProcessGroup: each
shard (one process) holds its N/S devices, and the capacity load, summed
over the shard's devices, is all-reduced over the axis
(``core.collectives.all_reduce``), the reference's ``psum`` and the
paper's one collective a slot.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.collectives import all_reduce
from repro_torch.core.state_space import RhoEstimator


@dataclasses.dataclass
class StepRule:
    """Dual step-size rule a_t = a / t^beta (beta=0 constant; 0.5 ->
    1/sqrt(t)); a and beta are float32 values held as Python floats."""

    a: float
    beta: float

    def __post_init__(self):
        self.a = float(np.float32(self.a))
        self.beta = float(np.float32(self.beta))

    @staticmethod
    def constant(a: float) -> "StepRule":
        return StepRule(a, 0.0)

    @staticmethod
    def inv_sqrt(a: float) -> "StepRule":
        return StepRule(a, 0.5)

    @staticmethod
    def power(a: float, beta: float) -> "StepRule":
        return StepRule(a, beta)

    def at(self, t: int) -> float:
        """a_t in float32 arithmetic, as a Python float."""
        tf = np.float32(max(int(t), 1))
        return float(np.float32(self.a) / tf ** np.float32(self.beta))


@dataclasses.dataclass
class OnAlgoParams:
    """Problem constants: B (N,) per-device power budgets, H () cloudlet
    capacity (float32 tensors on the run's device).  ``precondition``
    rescales each constraint row to RHS 1 (o' = o/B_n, h' = h/H): an exact
    diagonal preconditioner of the dual ascent."""

    B: torch.Tensor
    H: torch.Tensor
    precondition: bool = True


@dataclasses.dataclass
class OnAlgoState:
    lam: torch.Tensor  # (N,) power duals
    mu: torch.Tensor  # () cloudlet capacity dual, or (K,) per cloudlet
    rho: RhoEstimator  # streaming empirical per-device distribution


def init_state(num_devices: int, M: int, K: Optional[int] = None, *,
               device) -> OnAlgoState:
    """Fresh duals: mu is scalar, or (K,) for a K-cloudlet topology."""
    return OnAlgoState(
        lam=torch.zeros((num_devices,), dtype=torch.float32, device=device),
        mu=torch.zeros(() if K is None else (K,), dtype=torch.float32,
                       device=device),
        rho=RhoEstimator.create(num_devices, M, device=device))


def risk_adjusted_gain(phi_hat, sigma, v_risk):
    """Eq. (1): w = clip(phi_hat - v * sigma, 0, 1).

    ``phi_hat - v * sigma`` is formed in float64 (exact for float32
    inputs up to one rounding) and rounded to float32 once: a fused
    multiply-add, which is what the reference's compiled program computes
    on the CPU, so the gain streams match it bit for bit on any device."""
    w = phi_hat.double() - float(v_risk) * sigma.double()
    return torch.clamp(w.to(phi_hat.dtype), 0.0, 1.0)


def precondition_tables(o_tab, h_tab, params: OnAlgoParams):
    """Constraint-space tables (o', h', B_eff, H_eff): with
    ``params.precondition`` o' = o/B_n ((M,) -> (N, M)) and h' = h/H, with
    unit right-hand sides; otherwise a passthrough."""
    if not params.precondition:
        return o_tab, h_tab, params.B, params.H
    B_col = params.B[:, None] if params.B.ndim == 1 else params.B
    return (o_tab / B_col, h_tab / params.H,
            torch.ones_like(params.B), torch.ones_like(params.H))


def precondition_capacities(H_k, params: OnAlgoParams):
    """Per-cloudlet capacities (K,) in the dual space: with
    ``params.precondition`` H_k / H (the K capacity rows share the scalar
    H's scale, as ``precondition_tables`` divides h by H); otherwise a
    passthrough."""
    return H_k / params.H if params.precondition else H_k


def policy_matrix(lam, mu, o_tab, h_tab, w_tab, assoc=None):
    """Threshold policy y in {0,1}^(N,M) for every state (eq. 6/7), as
    float32.  Tables broadcast: (M,) shared or (N, M) per device.  With a
    topology, ``mu`` is the (K,) dual vector and ``assoc`` (N,) picks each
    device's current cloudlet price."""
    if assoc is None:
        price = lam[:, None] * o_tab + mu * h_tab
    else:
        price = lam[:, None] * o_tab + mu[assoc.long()][:, None] * h_tab
    return (price < w_tab).float() * (w_tab > 0)


def decide(lam, mu, o_now, h_now, w_now, task_mask):
    """Realized offloading decision for the current values (eq. 7); a
    device with w <= 0 never offloads.  ``mu`` is the scalar dual or an
    already gathered (N,) price ``mu_k[assoc]``."""
    price = lam * o_now + mu * h_now
    return (price < w_now) & (w_now > 0) & task_mask


def _power_slack_and_load(y_pol, rho, o_tab, h_tab, B, assoc=None, K=None):
    """g_pow (N,) and these devices' expected capacity load: () or, with
    ``assoc`` (N,), per cloudlet (K,)."""
    g_pow = torch.sum(o_tab.expand(y_pol.shape) * rho * y_pol, dim=-1) - B
    if assoc is not None:
        return g_pow, capacity_loads(y_pol, rho, h_tab, assoc, K)
    return g_pow, torch.sum(h_tab.expand(y_pol.shape) * rho * y_pol)


def constraint_slacks(y_pol, rho, o_tab, h_tab, params: OnAlgoParams,
                      axis_name=None, assoc=None, H_k=None):
    """g_t(y): per-device power slack (N,) and the capacity slack: global
    () or, with ``assoc`` (N,) and ``H_k`` (K,), per cloudlet (K,).  With
    ``axis_name`` (a mesh axis's ProcessGroup) the shard's load is
    all-reduced over the axis first: the protocol's one collective."""
    g_pow, load = _power_slack_and_load(
        y_pol, rho, o_tab, h_tab, params.B, assoc,
        None if H_k is None else H_k.shape[0])
    if axis_name is not None:
        load = all_reduce(load, axis_name)
    return g_pow, load - (params.H if assoc is None else H_k)


def capacity_loads(y_pol, rho, h_tab, assoc, K: int, axis_name=None):
    """(K,) per-cloudlet expected loads of the policy under rho: each
    device's row load (sum over states of h * rho * y) summed onto its
    cloudlet ``assoc[n]`` (a segment sum over the (N,) ids).  On the CPU
    in device order (the reference's); on the card by ``segment_sums``,
    the same bits every call.  With ``axis_name`` the shard's (K,)
    partials are all-reduced over the axis: the association may cross
    shard boundaries, and the collective stays one K-vector."""
    rows = torch.sum(h_tab.expand(y_pol.shape) * rho * y_pol, dim=-1)
    if rows.device.type == "cuda":
        load = segment_sums(rows, assoc.long(), K)
    else:
        load = torch.zeros((K,), dtype=rows.dtype, device=rows.device
                           ).index_add_(0, assoc.long(), rows)
    return load if axis_name is None else all_reduce(load, axis_name)


def segment_sums(rows, ids, K: int):
    """(K,) sums of float32 ``rows`` (N,) by id in [0, K), the same bits
    every call: on a CUDA tensor ``index_add_`` adds floats with atomics
    in any order (ROADMAP C10).  Here the rows go to fixed point: scaled
    by a power of two set from the largest |row| (so that every scaled
    row stays below 2^(62 - ceil(log2 N)) and no sum of N of them
    overflows int64) and truncated; integer atomics add them, exact in any
    order, and each sum comes back with one rounding.  Truncation moves a
    row by less than max|row| * 2^(ceil(log2 N) - 61).  No host wait."""
    shift = 62 - max(rows.shape[0] - 1, 1).bit_length()
    rows = rows.float()
    amax = torch.linalg.vector_norm(rows, float("inf"))
    # amax < 2^(E - 126), E its biased exponent; the scale 2^(shift + 126
    # - E) has the biased exponent 253 + shift - E (float32's largest
    # normal power where amax is tiny)
    e = amax.view(torch.int32) >> 23
    scale = (((253 + shift) - e).clamp_max(254) << 23).view(torch.float32)
    acc = torch.zeros((K,), dtype=torch.int64, device=rows.device
                      ).index_add_(0, ids, (rows * scale).long())
    return acc.float() / scale


def local_step(state: OnAlgoState, j_idx, o_now, h_now, w_now, task_mask,
               tables, params: OnAlgoParams, rule: StepRule,
               use_kernel: bool = False, assoc=None, H_k=None):
    """The part of a slot that needs no other shard: ``step`` up to the
    capacity dual's ascent.  Returns (lam (N,) after its ascent, the
    updated rho estimator, offload (N,) bool, load () or (K,): the
    expected capacity load of these devices (a shard's partial, not yet
    all-reduced), cap: the capacity it is held to in the dual space
    (H or H_k), a_t)."""
    topo = assoc is not None
    if topo != (H_k is not None):
        raise ValueError("assoc and H_k must be passed together")
    if topo and use_kernel:
        raise ValueError(
            "use_kernel (the fused single-slot dual kernel) does not "
            "support multi-cloudlet duals; run with use_kernel=False or "
            "through the chunked engines")
    o_tab, h_tab, w_tab = tables
    if params.precondition:
        o_tab, h_tab, B_eff, H_eff = precondition_tables(o_tab, h_tab,
                                                         params)
        o_now = o_now / params.B
        h_now = h_now / params.H
        if topo:
            H_k = precondition_capacities(H_k, params)
        params = OnAlgoParams(B=B_eff, H=H_eff, precondition=False)

    rho_est = state.rho.update(j_idx)
    rho = rho_est.rho
    mu_n = state.mu[assoc.long()] if topo else state.mu
    offload = decide(state.lam, mu_n, o_now, h_now, w_now, task_mask)

    if use_kernel:
        from repro_torch.kernels import ops as kops
        g_pow, load = kops.onalgo_duals(state.lam, state.mu, rho, o_tab,
                                        h_tab, w_tab, params.B)
    else:
        y_pol = policy_matrix(state.lam, state.mu, o_tab, h_tab, w_tab,
                              assoc=assoc)
        g_pow, load = _power_slack_and_load(
            y_pol, rho, o_tab, h_tab, params.B, assoc,
            H_k.shape[0] if topo else None)

    a_t = rule.at(rho_est.t)
    lam = torch.clamp_min(state.lam + a_t * g_pow, 0.0)
    return lam, rho_est, offload, load, H_k if topo else params.H, a_t


def ascend_capacity(mu, load, cap, a_t: float):
    """The capacity dual's ascent on the fleet's load (all shards'):
    [mu + a_t (load - cap)]^+."""
    return torch.clamp_min(mu + a_t * (load - cap), 0.0)


def step(state: OnAlgoState, j_idx, o_now, h_now, w_now, task_mask, tables,
         params: OnAlgoParams, rule: StepRule, axis_name=None,
         use_kernel: bool = False, assoc=None, H_k=None):
    """One OnAlgo slot (Algorithm 1 lines 3-19).

    j_idx (N,) current state indices; o_now/h_now/w_now (N,) realized
    values; task_mask (N,) bool; tables (o, h, w) of (M,) or (N, M).
    ``use_kernel`` routes the fused policy + reductions through
    ``kernels.ops.onalgo_duals`` (the CUDA kernel on CUDA tensors).
    ``assoc`` (N,) / ``H_k`` (K,): a multi-cloudlet slot; ``state.mu`` is
    then the (K,) dual vector and ``params.H`` stays the preconditioner's
    scale (h' = h / H, H_k' = H_k / H).
    ``axis_name``: a mesh axis's ProcessGroup; the state, values, tables
    and ``params.B`` are then this shard's devices (H, H_k and mu stay
    global), and the shard's load (K3's on the card) is all-reduced over
    the axis before mu ascends.
    Returns (new_state, offload (N,) bool).
    """
    lam, rho_est, offload, load, cap, a_t = local_step(
        state, j_idx, o_now, h_now, w_now, task_mask, tables, params, rule,
        use_kernel=use_kernel, assoc=assoc, H_k=H_k)
    if axis_name is not None:
        load = all_reduce(load, axis_name)
    mu = ascend_capacity(state.mu, load, cap, a_t)
    return OnAlgoState(lam=lam, mu=mu, rho=rho_est), offload
