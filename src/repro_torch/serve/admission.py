"""OnAlgo as the serving tier's admission controller, and the quantization
of raw observed values into the OnAlgo state space.

Port of ``repro/serve/admission.py``.  The cloudlet-capacity dual mu is a
congestion price the serving tier broadcasts to the fleet each slot; the
per-device power duals lambda_n stay device-local.  Request costs h are
model FLOPs of the serving architecture, and H is the cloudlet's FLOP
budget per slot.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import onalgo
from repro_torch.core.onalgo import OnAlgoParams, StepRule
from repro_torch.core.state_space import StateSpace
from repro_torch.device import resolve_device


@functools.lru_cache(maxsize=None)
def level_grid(levels: tuple, device: torch.device) -> torch.Tensor:
    """The float32 level grid on ``device``, uploaded once: a slab loop
    that quantizes every slab then copies nothing to the card."""
    return obs.upload(levels, device, torch.float32)


def quantize_states_device(space: StateSpace, o, h, w, task_mask
                           ) -> torch.Tensor:
    """Raw (o, h, w, task) tensors of any batch shape -> int32 state indices
    on their device (0 = no task).  Nearest level in float32 distances,
    ties to the first level (``torch.argmin`` returns the first minimum);
    the level grids are float32, built as the reference builds them."""
    def nearest(x, levels):
        lv = level_grid(tuple(levels), x.device)
        return torch.argmin(torch.abs(x.float()[..., None] - lv), dim=-1)

    j = space.encode(nearest(o, space.o_levels), nearest(h, space.h_levels),
                     nearest(w, space.w_levels)).to(torch.int32)
    return torch.where(task_mask.bool(), j, torch.zeros_like(j))


def quantize_states(space: StateSpace, o, h, w, task_mask) -> np.ndarray:
    """``quantize_states_device`` for host arrays; returns numpy int32."""
    t = lambda x: torch.as_tensor(np.asarray(x))
    return quantize_states_device(space, t(o), t(h), t(w),
                                  t(task_mask)).numpy()


class AdmissionController:
    """Vectorized OnAlgo over a fleet of N devices, driven slot by slot with
    RAW (unquantized) observed values; the quantized state space is used
    for the running distribution rho_t as in the paper.  ``use_kernel``
    routes each slot's policy and dual subgradients through
    ``kernels.ops.onalgo_duals`` (K3 on the card).  ``params`` holds
    tensors on ``device``."""

    def __init__(self, space: StateSpace, params: OnAlgoParams,
                 rule: StepRule, num_devices: int, use_kernel: bool = False,
                 *, device=None):
        self.space = space
        self.params = params
        self.rule = rule
        self.num_devices = num_devices
        self.use_kernel = use_kernel
        self.device = resolve_device(device)
        self.state = onalgo.init_state(num_devices, space.M,
                                       device=self.device)
        self.tables = space.tables(self.device)

    def quantize(self, o, h, w, task_mask):
        """Map raw (o, h, w) to the nearest state index (0 = no task)."""
        return quantize_states(self.space, o, h, w, task_mask)

    def admit(self, o, h, w, task_mask) -> np.ndarray:
        """One slot.  All args (N,) float/bool host arrays.  Returns the
        offload mask (N,) as numpy bool."""
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32),
                                        device=self.device)
        o_t, h_t, w_t = f32(o), f32(h), f32(w)
        task = torch.as_tensor(np.asarray(task_mask, bool),
                               device=self.device)
        j = quantize_states_device(self.space, o_t, h_t, w_t, task)
        self.state, offload = onalgo.step(
            self.state, j, o_t, h_t, w_t, task, self.tables, self.params,
            self.rule, use_kernel=self.use_kernel)
        return offload.cpu().numpy()

    @property
    def mu(self) -> float:
        return float(self.state.mu)

    @property
    def lam(self) -> np.ndarray:
        return self.state.lam.cpu().numpy()


def flops_per_request(cfg, seq_len: int, mode: str = "prefill") -> float:
    """Serving cost h for one request against architecture ``cfg``:
    2 * active_params * tokens (decode: per generated token)."""
    tokens = seq_len if mode == "prefill" else 1
    return 2.0 * cfg.active_param_count() * tokens
