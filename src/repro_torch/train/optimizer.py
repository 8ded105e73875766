"""Optimizers from scratch: AdamW, Adafactor, SGD.

Port of ``repro/train/optimizer.py``.  The state is float32 and every
update is taken in float32, then cast back to the parameter's dtype, as
the reference does.  The port's optimizer works on named leaves
(``train.tree.named_leaves``): its per-parameter state is a dict keyed by
the parameters' dotted names, and an update writes the new values into
the parameter tensors and the moments in place (the model's own tensors:
at full width a new copy of each is gigabytes).  One rule differs from an
elementwise update: Adafactor clips a leaf's update to RMS 1 over the
reference's leaf, which stacks a layer stack's instances, so its mean
square runs over every instance of that leaf (``tree.ref_key``).

Constants enter the arithmetic as the reference's do: Python floats,
rounded to float32 where they meet a float32 tensor; the step count and
the schedule's values are float32 tensors on the parameters' device (no
host value is read back).  ``opt_state_specs`` gives the state's logical
axes (the dry run places a sharded state by them).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch.train.tree import named_leaves, ref_key


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    name: str = "adamw"  # adamw | adafactor | sgd
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # adafactor
    decay_rate: float = 0.8
    factored_min: int = 128  # factor 2nd moment only for dims >= this


def global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads.values()))


def clip_by_global_norm(grads: dict, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params) -> dict:
    leaves = named_leaves(params)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    dev = next(iter(leaves.values())).device
    return {"m": {k: zeros(p) for k, p in leaves.items()},
            "v": {k: zeros(p) for k, p in leaves.items()},
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(spec, params, grads, state, lr):
    c = state["count"] + 1
    cf = c.float()
    b1, b2 = spec.b1, spec.b2
    bc1 = 1 - torch.pow(b1, cf)
    bc2 = 1 - torch.pow(b2, cf)
    for k, p in named_leaves(params).items():
        g32 = grads[k].float()
        m, v = state["m"][k], state["v"][k]
        m.copy_(b1 * m + (1 - b1) * g32)
        v.copy_(b2 * v + (1 - b2) * g32 * g32)
        step = (m / bc1) / (torch.sqrt(v / bc2) + spec.eps)
        p32 = p.float()
        step = step + spec.weight_decay * p32
        p.copy_((p32 - lr * step).to(p.dtype))
    return params, {"m": state["m"], "v": state["v"], "count": c}


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018), simplified: factored v, no momentum
# ---------------------------------------------------------------------------

def _factored(p, min_dim):
    return p.dim() >= 2 and p.shape[-1] >= min_dim and p.shape[-2] >= min_dim


def adafactor_init(params, spec: Optional[OptimizerSpec] = None) -> dict:
    spec = spec or OptimizerSpec(name="adafactor")
    leaves = named_leaves(params)

    def one(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if _factored(p, spec.factored_min):
            return {"vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"v": torch.zeros(p.shape, **f32)}

    dev = next(iter(leaves.values())).device
    return {"v": {k: one(p) for k, p in leaves.items()},
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adafactor_update(spec, params, grads, state, lr):
    c = state["count"] + 1
    rho = 1.0 - c.float() ** (-spec.decay_rate)
    eps = 1e-30
    leaves = named_leaves(params)
    steps = {}
    for k, p in leaves.items():
        g32 = grads[k].float()
        g2 = g32 * g32 + eps
        v = state["v"][k]
        if "vr" in v:
            v["vr"].copy_(rho * v["vr"] + (1 - rho) * g2.mean(dim=-1))
            v["vc"].copy_(rho * v["vc"] + (1 - rho) * g2.mean(dim=-2))
            vr, vc = v["vr"], v["vc"]
            denom = (vr[..., :, None] / torch.clamp_min(
                vr.mean(dim=-1, keepdim=True)[..., :, None], eps)) \
                * vc[..., None, :]
            steps[k] = g32 * torch.rsqrt(torch.clamp_min(denom, eps))
        else:
            v["v"].copy_(rho * v["v"] + (1 - rho) * g2)
            steps[k] = g32 * torch.rsqrt(torch.clamp_min(v["v"], eps))
    # update clipping (RMS <= 1) as in the paper, over the reference's
    # leaf: every stacked instance of it
    groups: dict = {}
    for k in leaves:
        groups.setdefault(ref_key(k.split("."))[0], []).append(k)
    for names in groups.values():
        total = sum(steps[k].numel() for k in names)
        ms = sum(torch.sum(steps[k] * steps[k]) for k in names) / total
        rms = torch.sqrt(ms + eps)
        for k in names:
            p = leaves[k]
            step = steps[k] / torch.clamp_min(rms, 1.0)
            p32 = p.float()
            step = step + spec.weight_decay * p32
            p.copy_((p32 - lr * step).to(p.dtype))
    return params, {"v": state["v"], "count": c}


# ---------------------------------------------------------------------------
# SGD: for tests
# ---------------------------------------------------------------------------

def sgd_init(params) -> dict:
    dev = next(iter(named_leaves(params).values())).device
    return {"count": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def sgd_update(spec, params, grads, state, lr):
    for k, p in named_leaves(params).items():
        p.copy_((p.float() - lr * grads[k].float()).to(p.dtype))
    return params, {"count": state["count"] + 1}


# ---------------------------------------------------------------------------
# dispatch + schedules
# ---------------------------------------------------------------------------

_INITS = {"adamw": adamw_init, "adafactor": adafactor_init, "sgd": sgd_init}
_UPDATES = {"adamw": adamw_update, "adafactor": adafactor_update,
            "sgd": sgd_update}


def init_opt_state(spec: OptimizerSpec, params) -> dict:
    if spec.name not in _INITS:
        raise ValueError(f"unknown optimizer {spec.name!r}; "
                         "expected adamw | adafactor | sgd")
    if spec.name == "adafactor":
        return adafactor_init(params, spec)
    return _INITS[spec.name](params)


def apply_update(spec: OptimizerSpec, params, grads: dict, state: dict, lr):
    """Clip (``spec.grad_clip``; 0 leaves the gradients as they are) and
    apply one update.  ``grads`` is {dotted name: tensor}.  The parameters
    and the state's moments are written in place; returns (params, the
    new state, the gradients' global norm before clipping)."""
    if spec.grad_clip:
        grads, gnorm = clip_by_global_norm(grads, spec.grad_clip)
    else:
        gnorm = global_norm(grads)
    params, state = _UPDATES[spec.name](spec, params, grads, state, lr)
    return params, state, gnorm


def opt_state_specs(spec: OptimizerSpec, param_shapes: dict,
                    param_specs: dict) -> dict:
    """Logical-axes tree of the optimizer state (mirrors init_opt_state).

    param_shapes: {dotted name: tensor (meta, fake or real)}, as
    ``tree.named_leaves`` gives them; param_specs: {dotted name: logical
    axes}, as ``tree.leaf_axes`` gives them.  Adam m / v inherit the param
    axes (ZeRO-style); Adafactor's factored rows / cols drop the factored
    dimension's axis."""
    if spec.name == "sgd":
        return {"count": ()}
    if spec.name == "adamw":
        return {"m": dict(param_specs), "v": dict(param_specs), "count": ()}

    def one(p, axes):
        axes = tuple(axes) or (None,) * p.dim()
        if _factored(p, spec.factored_min):
            return {"vr": axes[:-1], "vc": axes[:-2] + axes[-1:]}
        return {"v": axes}

    return {"v": {k: one(p, param_specs[k]) for k, p in param_shapes.items()},
            "count": ()}


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable:
    """lr_at(step): linear warmup over ``warmup`` steps, then a cosine
    decay to ``min_frac`` of ``base_lr`` at ``total``; ``step`` an integer
    tensor (the counter starts at 0), the result a float32 tensor."""
    def lr_at(step):
        s = step.float() + 1.0
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0, 1)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi
                                                               * prog))
        return base_lr * torch.where(s < warmup, warm, cos)

    return lr_at
