"""Carry problem, algorithm state and model weights over from the JAX
package.

What crosses over is the problem (params, step rule, trace, overlay,
pool), the algorithm state (duals and visit counts) and the cloudlet
LM's weights.  Each function takes the reference's object with numpy
leaves — or any object with the same attributes — and builds the port's
object on ``device``, so a run can start in one package and continue in
the other, and both packages can compute the same function in the tests.
Nothing here imports JAX: callers convert leaves with ``np.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fleet import RawOverlay, Trace
from repro_torch.core.onalgo import (TOPOLOGY_TODO, OnAlgoParams,
                                     OnAlgoState, StepRule)
from repro_torch.core.state_space import RhoEstimator
from repro_torch.models.lm import to_module
from repro_torch.serve.simulator import PrecomputedPool


def _t(x, dtype, device):
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def step_rule_from(rule) -> StepRule:
    """``StepRule`` from an object with scalar ``a`` and ``beta``."""
    return StepRule(a=float(np.asarray(rule.a)),
                    beta=float(np.asarray(rule.beta)))


def onalgo_params_from(params, *, device) -> OnAlgoParams:
    """``OnAlgoParams`` from ``B`` (N,), ``H`` () and ``precondition``."""
    return OnAlgoParams(B=_t(params.B, torch.float32, device),
                        H=_t(params.H, torch.float32, device),
                        precondition=bool(params.precondition))


def onalgo_state_from(state, *, device) -> OnAlgoState:
    """``OnAlgoState`` from ``lam`` (N,), ``mu`` () and ``rho.counts`` (N, M)
    / ``rho.t`` ().  A (K,) ``mu`` needs the topology tier and raises."""
    mu = np.asarray(state.mu)
    if mu.ndim:
        raise NotImplementedError(TOPOLOGY_TODO)
    return OnAlgoState(
        lam=_t(state.lam, torch.float32, device),
        mu=_t(mu, torch.float32, device),
        rho=RhoEstimator(counts=_t(state.rho.counts, torch.float32, device),
                         t=int(np.asarray(state.rho.t))))


def trace_from(trace, *, device) -> Trace:
    """``Trace`` from ``j_idx`` (T, N) and ``d_local`` (T, N)."""
    return Trace(j_idx=_t(trace.j_idx, torch.int32, device),
                 d_local=_t(trace.d_local, torch.float32, device))


def raw_overlay_from(overlay, *, device) -> RawOverlay:
    """``RawOverlay`` from the five (T, N) raw-value streams."""
    return RawOverlay(*(_t(getattr(overlay, k), torch.float32, device)
                        for k in ("o", "h", "w", "correct_local",
                                  "correct_cloud")))


def pool_from(pool) -> PrecomputedPool:
    """``PrecomputedPool`` (numpy arrays, as the reference holds them)."""
    return PrecomputedPool(*(np.asarray(getattr(pool, k)) for k in (
        "local_correct", "cloud_correct", "d_local", "phi_hat", "sigma",
        "cycles")))


def _weight(x, device) -> torch.Tensor:
    """A numpy leaf as a tensor of the same dtype (a bfloat16 leaf, which
    numpy holds as ml_dtypes.bfloat16, goes through float32: exact)."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.tensor(x.astype(np.float32), device=device).to(
            torch.bfloat16)
    return torch.tensor(x, device=device)


def model_params_from(params, cfg, *, device):
    """The port's LM params (``models.lm.init_lm``'s module) from the
    reference's params tree with numpy leaves: {"embed", "blocks",
    "final_norm"}, the blocks stacked on a leading axis of
    ``cfg.num_layers // cfg.pattern_period`` pattern instances
    (``repro/models/lm.py::init_lm``), which becomes the module list."""
    def tree(t, pick=lambda x: x):
        if isinstance(t, dict):
            return {k: tree(v, pick) for k, v in t.items()}
        return _weight(pick(t), device)

    n_scan = cfg.num_layers // cfg.pattern_period
    blocks = [tree(params["blocks"], lambda x, i=i: np.asarray(x)[i])
              for i in range(n_scan)]
    return to_module({"embed": tree(params["embed"]), "blocks": blocks,
                      "final_norm": tree(params["final_norm"])})
