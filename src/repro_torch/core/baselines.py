"""Benchmark offloading policies from the paper (Sec. VI.A.3).

Port of ``repro/core/baselines.py``:
- ATO: offload when local confidence is below a threshold;
- RCO: offload while the running average power stays within budget;
- OCOS: always offload; the cloudlet admits as many tasks as fit.

The per-cloudlet (``_topo``) admissions wait for the topology tier
(ROADMAP.md, queue A item 6).
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
