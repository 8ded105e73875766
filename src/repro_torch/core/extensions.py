"""Model/algorithm extensions from paper Sec. V (port of
``repro/core/extensions.py``).

1. Joint accuracy + delay optimization (P3, eq. 15): the objective gains a
   ``-zeta * D_tot(y)`` term; the threshold rule becomes
       offload iff  lam*o + mu*h < w - zeta * (D_tr + D0_pr),
   (the device processing delay cancels: it is paid either way).
2. Wireless bandwidth constraint (eq. 16): sum_n sum_j y l rho <= W with its
   own dual nu and price term nu*l in the threshold.
3. Pre-classification offloading: the power constraint becomes
   sum_j (y o + (1-y) v) rho <= B, an affine shift handled by the
   effective cost o' = o - v and budget B' = B - sum_j v rho^j.

``ext_step(axis_name=...)`` is the sharded form: a shard's devices, with
the capacity load and the bandwidth use all-reduced over the mesh axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.collectives import all_reduce
from repro_torch.core.onalgo import (OnAlgoParams, OnAlgoState, StepRule,
                                     init_state)
from repro_torch.device import resolve_device


@dataclasses.dataclass
class DelayModel:
    """Per-state delay tables (seconds). Defaults from the paper's testbed:
    D_pr_dev = 2.537 ms, D_pr_cloud = 0.191 ms, D_tr = 0.157 ms."""

    d_tr: torch.Tensor  # (M,) or (N, M) transmission delay
    d_pr_cloud: torch.Tensor  # (M,) or scalar cloudlet processing delay

    @staticmethod
    def paper_defaults(M: int, *, device=None) -> "DelayModel":
        dev = resolve_device(device)
        return DelayModel(
            d_tr=torch.full((M,), 0.157e-3, dtype=torch.float32, device=dev),
            d_pr_cloud=torch.full((M,), 0.191e-3, dtype=torch.float32,
                                  device=dev))


@dataclasses.dataclass
class ExtState:
    base: OnAlgoState
    nu: torch.Tensor  # () bandwidth dual (0 when the constraint is disabled)


def init_ext_state(num_devices: int, M: int, *, device=None) -> ExtState:
    dev = resolve_device(device)
    return ExtState(base=init_state(num_devices, M, device=dev),
                    nu=torch.zeros((), dtype=torch.float32, device=dev))


def ext_policy_matrix(state: ExtState, o_tab, h_tab, w_tab,
                      zeta: float = 0.0,
                      delay: Optional[DelayModel] = None,
                      l_tab: Optional[torch.Tensor] = None):
    """Threshold policy with delay penalty and bandwidth price (eq. 15 +
    16), float32 (N, M)."""
    w_eff = w_tab
    if delay is not None and zeta:
        w_eff = w_tab - zeta * (delay.d_tr + delay.d_pr_cloud)
    price = state.base.lam[:, None] * o_tab + state.base.mu * h_tab
    if l_tab is not None:
        price = price + state.nu * l_tab
    return (price < w_eff).float() * (w_tab > 0)


def ext_step(state: ExtState, j_idx, o_now, h_now, w_now, task_mask,
             tables, params: OnAlgoParams, rule: StepRule,
             zeta: float = 0.0,
             delay: Optional[DelayModel] = None,
             l_tab: Optional[torch.Tensor] = None,
             W: Optional[float] = None,
             axis_name=None):
    """OnAlgo slot with the Sec. V extensions enabled.

    ``axis_name`` (a mesh axis's ProcessGroup): the state, values, tables
    and ``params.B`` are this shard's devices, and the capacity load and
    the bandwidth use are all-reduced over the axis, as the reference
    psums them.  Returns (new_state, offload (N,) bool, slot_delay ())."""
    o_tab, h_tab, w_tab = tables
    rho_est = state.base.rho.update(j_idx)
    rho = rho_est.rho
    j = j_idx.long()

    # realized decision with the delay / bandwidth-adjusted threshold
    w_eff = w_now
    d_extra = torch.zeros_like(w_now)
    if delay is not None and zeta:
        d_tr = delay.d_tr[j] if delay.d_tr.ndim == 1 else delay.d_tr
        d_pc = (delay.d_pr_cloud[j] if delay.d_pr_cloud.ndim == 1
                else delay.d_pr_cloud)
        d_extra = d_tr + d_pc
        w_eff = w_now - zeta * d_extra
    price = state.base.lam * o_now + state.base.mu * h_now
    if l_tab is not None:
        price = price + state.nu * l_tab[j]
    offload = (price < w_eff) & (w_now > 0) & task_mask

    # dual subgradients from the full adjusted policy
    y_pol = ext_policy_matrix(state, o_tab, h_tab, w_tab, zeta, delay, l_tab)
    g_pow = torch.sum(o_tab.expand(y_pol.shape) * rho * y_pol,
                      dim=-1) - params.B
    load = torch.sum(h_tab.expand(y_pol.shape) * rho * y_pol)
    if axis_name is not None:
        load = all_reduce(load, axis_name)
    g_cap = load - params.H

    a_t = rule.at(rho_est.t)
    lam = torch.clamp_min(state.base.lam + a_t * g_pow, 0.0)
    mu = torch.clamp_min(state.base.mu + a_t * g_cap, 0.0)

    nu = state.nu
    if l_tab is not None and W is not None:
        used = torch.sum(l_tab.expand(y_pol.shape) * rho * y_pol)
        if axis_name is not None:
            used = all_reduce(used, axis_name)
        nu = torch.clamp_min(nu + a_t * (used - W), 0.0)

    # the slot's total extra delay actually incurred (Fig. 8 metrics)
    slot_delay = torch.sum(torch.where(offload, d_extra, 0.0))

    new_state = ExtState(base=OnAlgoState(lam=lam, mu=mu, rho=rho_est),
                         nu=nu)
    return new_state, offload, slot_delay


def preclassification_costs(o_tab, v_power, rho):
    """Sec. V alternative architecture: the device skips local
    classification when offloading.  Effective transmit cost o' = o - v
    and budget shift B' = B - sum_j v rho^j; returns (o_eff_tab,
    budget_shift)."""
    return o_tab - v_power, -(v_power * rho).sum(dim=-1)
