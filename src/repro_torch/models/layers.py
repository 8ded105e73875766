"""Shared neural-net layers: norms, RoPE, MLPs, embeddings.

Port of ``repro/models/layers.py``.  Params are nested dicts of tensors
(the port wraps them in ``nn.ParameterDict`` / ``nn.ModuleDict``, see
``models/lm.py``); every init function takes a ``torch.Generator`` and
returns ``(params, specs)``, ``specs`` mirroring params with tuples of
logical axis names as the reference's do.  Activations flow in
``cfg.dtype``; reductions and normalizer statistics in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def normal(gen, shape, dtype, scale):
    """N(0, 1) * scale in ``dtype`` on the generator's device (the
    reference draws in ``cfg.dtype`` and scales in it too)."""
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=gen.device) * scale


# ----------------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------------

def rmsnorm(x, scale, eps=1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layernorm(x, scale, bias, eps=1e-5):
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def nonparam_ln(x, eps=1e-5):
    """OLMo's non-parametric LayerNorm: no learnable scale/bias."""
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def init_norm(cfg, d=None, *, device=None):
    d = d or cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    if cfg.norm_type == "rmsnorm":
        return {"scale": torch.zeros((d,), **f32)}, {"scale": ("act_embed",)}
    if cfg.norm_type == "layernorm":
        return ({"scale": torch.ones((d,), **f32),
                 "bias": torch.zeros((d,), **f32)},
                {"scale": ("act_embed",), "bias": ("act_embed",)})
    if cfg.norm_type == "nonparam_ln":
        return {}, {}
    raise ValueError(cfg.norm_type)


def apply_norm(cfg, params, x):
    if cfg.norm_type == "rmsnorm":
        return rmsnorm(x, params["scale"])
    if cfg.norm_type == "layernorm":
        return layernorm(x, params["scale"], params["bias"])
    return nonparam_ln(x)


# ----------------------------------------------------------------------------
# Rotary position embeddings
# ----------------------------------------------------------------------------

def apply_rope(x, positions, theta=10000.0):
    """x: (..., S, H, D) with D even; positions: (..., S) integer.

    Frequencies and angles in float32, the rotation in float32 (x times a
    float32 table promotes), cast back to x's dtype, as the reference."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].to(device=x.device,
                                  dtype=torch.float32) * freq  # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# MLP (gated SwiGLU-style or plain)
# ----------------------------------------------------------------------------

_ACTS = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
         "relu": F.relu}  # jax.nn.gelu defaults to the tanh approximation


def init_mlp(gen, cfg, d_in=None, d_ff=None):
    d_in = d_in or cfg.d_model
    d_ff = d_ff or cfg.d_ff
    s_in = (2.0 / d_in) ** 0.5
    p = {"w_up": normal(gen, (d_in, d_ff), cfg.dtype, s_in),
         "w_down": normal(gen, (d_ff, d_in), cfg.dtype, (2.0 / d_ff) ** 0.5)}
    s = {"w_up": ("embed", "mlp"), "w_down": ("mlp", "embed")}
    if cfg.gated_mlp:
        p["w_gate"] = normal(gen, (d_in, d_ff), cfg.dtype, s_in)
        s["w_gate"] = ("embed", "mlp")
    return p, s


def apply_mlp(cfg, params, x):
    up = x @ params["w_up"]
    if cfg.gated_mlp:
        h = _ACTS[cfg.act](x @ params["w_gate"]) * up
    else:
        h = _ACTS[cfg.act](up)
    return h @ params["w_down"]


# ----------------------------------------------------------------------------
# Embedding + LM head
# ----------------------------------------------------------------------------

def init_embed(gen, cfg):
    p = {"embedding": normal(gen, (cfg.vocab_size, cfg.d_model), cfg.dtype,
                             0.02)}
    s = {"embedding": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        p["lm_head"] = normal(gen, (cfg.d_model, cfg.vocab_size), cfg.dtype,
                              0.02)
        s["lm_head"] = ("embed", "vocab")
    return p, s


def embed_tokens(cfg, params, tokens):
    return params["embedding"][tokens.long()]


def lm_head(cfg, params):
    """The (D, V) output projection (the tied embedding, transposed)."""
    return (params["embedding"].T if cfg.tie_embeddings
            else params["lm_head"])


def lm_logits(cfg, params, x):
    return x @ lm_head(cfg, params)
