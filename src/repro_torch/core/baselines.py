"""Benchmark offloading policies from the paper (Sec. VI.A.3).

Port of ``repro/core/baselines.py``:
- ATO: offload when local confidence is below a threshold;
- RCO: offload while the running average power stays within budget;
- OCOS: always offload; the cloudlet admits as many tasks as fit.

Admission at the cloudlet: ``admit_by_capacity`` (one cloudlet) and
``admit_by_capacity_topo`` (each of K cloudlets admits its own devices).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class ATOState:
    theta: float  # confidence threshold


@dataclasses.dataclass
class RCOState:
    energy: torch.Tensor  # (N,) cumulative transmit energy spent
    t: int  # slots so far


@dataclasses.dataclass
class OCOSState:
    pass  # stateless


def ato_step(state: ATOState, d_local, o_now, task_mask):
    """Offload iff local confidence below threshold. No resource awareness."""
    return state, task_mask & (d_local < state.theta)


def rco_step(state: RCOState, o_now, B, task_mask):
    """Offload iff (energy so far + this task) keeps average power <= B."""
    t = state.t + 1
    tf = torch.full((), float(t), dtype=torch.float32, device=o_now.device)
    ok = (state.energy + o_now) / tf <= B
    offload = task_mask & ok
    energy = state.energy + torch.where(offload, o_now, 0.0)
    return RCOState(energy=energy, t=t), offload


def ocos_step(state: OCOSState, task_mask):
    """Always offload every task; admission happens at the cloudlet."""
    return state, task_mask


def admit_by_capacity(offload, h_now, H_slot, smallest_first: bool = False):
    """Cloudlet per-slot admission under capacity H_slot (paper Sec. VI.C.2):
    a greedy prefix in device order, or in ascending cycle cost with
    ``smallest_first`` (OCOS).  Works on the last axis, so a (T, N) batch
    of slots is admitted in one call.  Returns the admitted mask (bool)."""
    h_eff = torch.where(offload, h_now, 0.0)
    if smallest_first:
        key = torch.where(offload, h_now, float("inf"))
        order = torch.argsort(key, dim=-1, stable=True)
        fits_sorted = torch.cumsum(torch.gather(h_eff, -1, order),
                                   dim=-1) <= H_slot
        fits = torch.empty_like(fits_sorted).scatter_(-1, order, fits_sorted)
    else:
        fits = torch.cumsum(h_eff, dim=-1) <= H_slot
    return offload & fits


def _segmented_cumsum(x, seg):
    """Inclusive running sum of ``x`` along the last axis in float64,
    restarting wherever ``seg`` changes (``seg`` sorted, so each segment
    is contiguous).  Log-step doubling: pass d adds the partial sum d
    places back only within the same segment, so a running load never
    mixes two cloudlets' values."""
    s = x.double()
    n = s.shape[-1]
    d = 1
    while d < n:
        add = torch.where(seg[..., d:] == seg[..., :-d], s[..., :-d], 0.0)
        s = torch.cat([s[..., :d], s[..., d:] + add], dim=-1)
        d *= 2
    return s


def admit_by_capacity_topo(offload, h_now, assoc, H_k,
                           smallest_first: bool = False):
    """Per-cloudlet slot admission: cloudlet k admits a greedy prefix (in
    device order, or ascending cycle cost with ``smallest_first``) of ITS
    OWN offloaders under its capacity H_k.

    Works on the last axis ((N,) or a (T, N) batch of slots); ``assoc``
    (N,) or the same shape as ``offload`` (ignored when K == 1: then this
    is exactly :func:`admit_by_capacity` under ``H_k[0]``).  O(N log N):
    a stable sort by cloudlet (for ``smallest_first``, a stable sort by
    cost first, then by cloudlet) and a segmented running load in float64
    that never mixes cloudlets; :func:`admit_by_capacity_topo_onehot` is
    the O(N K) oracle.  Returns the admitted mask (bool)."""
    K = H_k.shape[0]
    if K == 1:  # one cloudlet: the scalar rule, bit for bit
        return admit_by_capacity(offload, h_now, H_k[0], smallest_first)
    assoc = assoc.long().expand(offload.shape)
    h_eff = torch.where(offload, h_now, 0.0)
    if smallest_first:
        key = torch.where(offload, h_now, float("inf"))
        by_cost = torch.argsort(key, dim=-1, stable=True)
        by_cloudlet = torch.argsort(torch.gather(assoc, -1, by_cost),
                                    dim=-1, stable=True)
        order = torch.gather(by_cost, -1, by_cloudlet)
    else:
        order = torch.argsort(assoc, dim=-1, stable=True)
    a_s = torch.gather(assoc, -1, order)
    prefix = _segmented_cumsum(torch.gather(h_eff, -1, order), a_s)
    fits_sorted = prefix <= H_k.double()[a_s]
    fits = torch.empty_like(fits_sorted).scatter_(-1, order, fits_sorted)
    return offload & fits


def admit_by_capacity_topo_onehot(offload, h_now, assoc, H_k,
                                  smallest_first: bool = False):
    """O(N K) one-hot oracle for :func:`admit_by_capacity_topo` on (N,)
    inputs: the per-cloudlet running load as a dense (N, K) cumsum.  Kept
    for the tests; never called on a hot path."""
    K = H_k.shape[0]
    if K == 1:
        return admit_by_capacity(offload, h_now, H_k[0], smallest_first)
    assoc = assoc.long()
    h_eff = torch.where(offload, h_now, 0.0)
    if smallest_first:
        key = torch.where(offload, h_now, float("inf"))
        order = torch.argsort(key, stable=True)
    else:
        order = torch.arange(offload.shape[0], device=offload.device)
    onehot = torch.nn.functional.one_hot(assoc[order], K).to(h_eff.dtype)
    cum = torch.cumsum(h_eff[order][:, None] * onehot, dim=0)  # (N, K)
    fits_sorted = torch.sum(cum * onehot, dim=1) <= H_k[assoc[order]]
    fits = torch.empty_like(fits_sorted).scatter_(0, order, fits_sorted)
    return offload & fits
