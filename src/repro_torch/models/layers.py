"""Shared neural-net layers: norms, RoPE, MLPs, embeddings.

Port of ``repro/models/layers.py``.  Params are nested dicts of tensors
(the port wraps them in ``nn.ParameterDict`` / ``nn.ModuleDict``, see
``models/lm.py``); every init function takes a ``torch.Generator`` and
returns ``(params, specs)``, ``specs`` mirroring params with tuples of
logical axis names as the reference's do (``parallel/sharding.py``; the
activations carry the reference's ``shard`` annotations).  Activations flow in
``cfg.dtype``; reductions and normalizer statistics in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import grad_placed, placed_by_rules, shard


def normal(gen, shape, dtype, scale):
    """N(0, 1) * scale in ``dtype`` on the generator's device (the
    reference draws in ``cfg.dtype`` and scales in it too).  Scaled in
    place: a full-width expert stack is tens of GB, drawn once."""
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=gen.device).mul_(scale)


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
    # "mlp_seq" (not "seq") on the hidden: under sequence-parallel rules the
    # MLP stays tensor-parallel over d_ff while attention is seq-sharded.
    up = shard(x @ params["w_up"], "batch", "mlp_seq", "mlp")
    if cfg.gated_mlp:
        gate = shard(x @ params["w_gate"], "batch", "mlp_seq", "mlp")
        h = _ACTS[cfg.act](gate) * up
    else:
        h = _ACTS[cfg.act](up)
    return shard(h @ params["w_down"], "batch", "seq", "act_embed")


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
    # under a mesh the table is gathered whole first: a row gather from a
    # split vocabulary has no backward in DTensor that reaches the split
    # table (a no-op without a mesh)
    table = shard(params["embedding"], None, None)
    return shard(F.embedding(tokens.long(), table), "batch", "seq",
                 "act_embed")


def lm_head(cfg, params):
    """The (D, V) output projection (the tied embedding, transposed).

    Under a mesh, a tied table whose rows the vocabulary's axis does not
    divide lies whole over that axis, while the logits split it all the
    same: the head's gradient comes split there and partial over the
    batch's axis.  Torch 2.11's DTensor sums it with the lookup's
    gradient (placed as the table) by following the head's, and asks the
    lookup's Shard for that Partial, which it cannot make; so such a table
    takes its head gradient placed as the table is."""
    if not cfg.tie_embeddings:
        return params["lm_head"]
    table = params["embedding"]
    if not placed_by_rules(table, "vocab", "embed"):
        table = grad_placed(table)
    return table.T


def lm_logits(cfg, params, x):
    return shard(x @ lm_head(cfg, params), "batch", "seq", "vocab")
