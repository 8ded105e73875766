"""Layer blocks: (attention | mamba) mixer + (dense | MoE) FFN, pre-norm.

Port of ``repro/models/blocks.py``.  A *pattern* is the smallest
repeating group of layers (period 1 for uniform stacks; 8 for Jamba's
[m m m m a m m m] with MoE on odd layers); the LM loops over pattern
instances.  Mamba2-style blocks (d_ff == 0, no MoE) have no FFN
sublayer.  ``remat_wrap`` is the reference's rematerialization of a
pattern instance in a training forward.
"""

from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib


def init_sub_block(gen, cfg, layer_idx: int):
    """One layer: norms + mixer + ffn params (+specs)."""
    dev = gen.device
    p, s = {}, {}
    p["norm1"], s["norm1"] = L.init_norm(cfg, device=dev)
    if cfg.block_kind(layer_idx) == "attn":
        p["mixer"], s["mixer"] = attn.init_attention(gen, cfg)
    else:
        p["mixer"], s["mixer"] = ssm_lib.init_ssm(gen, cfg)
    # Mamba2-style blocks (d_ff == 0, no MoE) have no FFN sublayer.
    if cfg.ffn_kind(layer_idx) == "moe":
        p["norm2"], s["norm2"] = L.init_norm(cfg, device=dev)
        p["ffn"], s["ffn"] = moe_lib.init_moe(gen, cfg)
        if cfg.dense_residual:
            p["ffn_dense"], s["ffn_dense"] = L.init_mlp(gen, cfg)
    elif cfg.d_ff > 0:
        p["norm2"], s["norm2"] = L.init_norm(cfg, device=dev)
        p["ffn"], s["ffn"] = L.init_mlp(gen, cfg)
    return p, s


def apply_sub_block(cfg, params, x, layer_idx: int, *, positions,
                    cache=None, cache_len=None, use_kernel=False,
                    causal=True):
    """Pre-norm transformer / mamba layer.  Returns (x, new_cache,
    aux_loss); the cache is written in place (attention: the new tokens'
    k / v rows; mamba: the conv window and the SSM state, copied into
    the cache's tensors, which may be views of the LM's stacked cache).
    The aux loss is the MoE router's load-balance loss (0 for a dense
    FFN)."""
    h = L.apply_norm(cfg, params["norm1"], x)
    if cfg.block_kind(layer_idx) == "attn":
        kv_cache = (cache["k"], cache["v"]) if cache is not None else None
        out, _ = attn.attention_block(
            cfg, params["mixer"], h, positions=positions, causal=causal,
            kv_cache=kv_cache, cache_len=cache_len, use_kernel=use_kernel)
    else:
        out, ssm_cache = ssm_lib.mamba_block(cfg, params["mixer"], h,
                                             cache=cache,
                                             use_kernel=use_kernel)
        if cache is not None:
            for name, t in ssm_cache.items():
                cache[name].copy_(t)
    x = x + out

    aux = 0.0
    if cfg.ffn_kind(layer_idx) == "moe":
        h = L.apply_norm(cfg, params["norm2"], x)
        moe_fn = (moe_lib.moe_ffn_dropless if cfg.moe_impl == "dropless"
                  else moe_lib.moe_ffn)
        out, aux = moe_fn(cfg, params["ffn"], h)
        if cfg.dense_residual:
            out = out + L.apply_mlp(cfg, params["ffn_dense"], h)
        x = x + out
    elif cfg.d_ff > 0:
        h = L.apply_norm(cfg, params["norm2"], x)
        x = x + L.apply_mlp(cfg, params["ffn"], h)
    return x, cache, aux


def init_block_cache(cfg, layer_idx: int, batch: int, max_len: int, *,
                     device=None):
    """Decode cache entry for one layer (kv or ssm/conv)."""
    if cfg.block_kind(layer_idx) != "attn":
        return ssm_lib.init_ssm_cache(cfg, batch, device=device)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def cache_specs(cfg, layer_idx: int):
    """Logical axes of a layer's cache entry (mirrors init_block_cache)."""
    if cfg.block_kind(layer_idx) == "attn":
        axes = ("batch", "kv_seq", "kv_heads", "head_dim")
        return {"k": axes, "v": axes}
    return {"conv": ("batch", None, "mlp"),
            "ssm": ("batch", None, None, "state")}


def init_pattern(gen, cfg):
    """Init one pattern instance (cfg.pattern_period consecutive layers)."""
    params, specs = {}, {}
    for r in range(cfg.pattern_period):
        params[f"sub{r}"], specs[f"sub{r}"] = init_sub_block(gen, cfg, r)
    return params, specs


def apply_pattern(cfg, params, x, *, positions, cache=None, cache_len=None,
                  use_kernel=False, causal=True):
    """Apply one pattern instance; cache is the per-instance cache dict."""
    new_cache = {} if cache is not None else None
    aux_total = 0.0
    for r in range(cfg.pattern_period):
        sub_cache = cache[f"sub{r}"] if cache is not None else None
        x, sc, aux = apply_sub_block(
            cfg, params[f"sub{r}"], x, r, positions=positions,
            cache=sub_cache, cache_len=cache_len, use_kernel=use_kernel,
            causal=causal)
        if cache is not None:
            new_cache[f"sub{r}"] = sc
        aux_total = aux_total + aux
    return x, new_cache, aux_total


# The products a "dots" forward keeps for the backward: matrix products
# with no batch dimension (a (B, S, D) @ (D, F) product is one ``mm``),
# as jax's ``dots_with_no_batch_dims_saveable``; batched products
# (``bmm``: attention scores) and everything else are recomputed.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_wrap(cfg, fn):
    """``fn`` rematerialized by ``cfg.remat``: "none" as it is; "full"
    keeps only its inputs and recomputes the rest in the backward
    (``torch.utils.checkpoint``, non-reentrant); "dots" keeps the outputs
    of its matrix products as well (a selective-checkpoint policy).
    With grad mode off the function runs as it is."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r}; "
                         "expected none | full | dots")
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped
