"""Quantization of raw observed values into the OnAlgo state space.

Port of ``quantize_states_device`` / ``quantize_states`` from
``repro/serve/admission.py``; the admission controller class waits for
the serving tier (ROADMAP.md, queue A item 10).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.state_space import StateSpace


def quantize_states_device(space: StateSpace, o, h, w, task_mask
                           ) -> torch.Tensor:
    """Raw (o, h, w, task) tensors of any batch shape -> int32 state indices
    on their device (0 = no task).  Nearest level in float32 distances,
    ties to the first level (``torch.argmin`` returns the first minimum);
    the level grids are float32, built as the reference builds them."""
    def nearest(x, levels):
        lv = torch.tensor(levels, dtype=torch.float32, device=x.device)
        return torch.argmin(torch.abs(x.float()[..., None] - lv), dim=-1)

    j = space.encode(nearest(o, space.o_levels), nearest(h, space.h_levels),
                     nearest(w, space.w_levels)).to(torch.int32)
    return torch.where(task_mask.bool(), j, torch.zeros_like(j))


def quantize_states(space: StateSpace, o, h, w, task_mask) -> np.ndarray:
    """``quantize_states_device`` for host arrays; returns numpy int32."""
    t = lambda x: torch.as_tensor(np.asarray(x))
    return quantize_states_device(space, t(o), t(h), t(w),
                                  t(task_mask)).numpy()
