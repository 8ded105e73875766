"""Layer blocks: attention mixer + dense FFN, pre-norm.

Port of ``repro/models/blocks.py`` for the dense decoder family.  A
*pattern* is the smallest repeating group of layers (period 1 for the
uniform stacks ported so far); the LM loops over pattern instances.  The
MoE and SSM branches are not ported yet; ``remat`` has no meaning
without training and is dropped.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import layers as L

MOE_SSM_TODO = ("MoE and SSM blocks are not ported yet: ROADMAP.md, queue "
                "A item 12 (model zoo)")


def _dense_attn_only(cfg, layer_idx: int):
    if cfg.block_kind(layer_idx) != "attn" or cfg.ffn_kind(layer_idx) != \
            "dense":
        raise NotImplementedError(MOE_SSM_TODO)


def init_sub_block(gen, cfg, layer_idx: int):
    """One layer: norms + mixer + ffn params (+specs)."""
    _dense_attn_only(cfg, layer_idx)
    dev = gen.device
    p, s = {}, {}
    p["norm1"], s["norm1"] = L.init_norm(cfg, device=dev)
    p["mixer"], s["mixer"] = attn.init_attention(gen, cfg)
    if cfg.d_ff > 0:
        p["norm2"], s["norm2"] = L.init_norm(cfg, device=dev)
        p["ffn"], s["ffn"] = L.init_mlp(gen, cfg)
    return p, s


def apply_sub_block(cfg, params, x, layer_idx: int, *, positions,
                    cache=None, cache_len=None, use_kernel=False,
                    causal=True):
    """Pre-norm transformer layer.  Returns (x, new_cache, aux_loss)."""
    _dense_attn_only(cfg, layer_idx)
    h = L.apply_norm(cfg, params["norm1"], x)
    kv_cache = (cache["k"], cache["v"]) if cache is not None else None
    out, (k, v) = attn.attention_block(
        cfg, params["mixer"], h, positions=positions, causal=causal,
        kv_cache=kv_cache, cache_len=cache_len, use_kernel=use_kernel)
    new_cache = {"k": k, "v": v} if cache is not None else None
    x = x + out
    if cfg.d_ff > 0:
        h = L.apply_norm(cfg, params["norm2"], x)
        x = x + L.apply_mlp(cfg, params["ffn"], h)
    return x, new_cache, 0.0  # dense FFN: no auxiliary loss


def init_block_cache(cfg, layer_idx: int, batch: int, max_len: int, *,
                     device=None):
    """Decode cache entry for one layer (kv)."""
    _dense_attn_only(cfg, layer_idx)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


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
