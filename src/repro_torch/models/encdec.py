"""Encoder-decoder backbone (SeamlessM4T-medium style, audio frontend stub).

Port of ``repro/models/encdec.py``.  Encoder: bidirectional
self-attention stack over precomputed source frame embeddings (the
conformer speech frontend is a stub, as in the reference).  Decoder:
causal self-attention + cross-attention to the encoder memory + FFN.
Decode-time state: the self-attention KV cache, in the reference's
stacked layout (num_layers, B, max_len, Hkv, Dh) and written in place,
and the cross-attention K / V, computed once from the memory at prefill
((num_layers, B, S_src, Hkv, Dh) each).

``use_kernel`` reaches every attention: the encoder's self-attention
runs K5 (non-causal), a decode step's self-attention K6, the
cross-attention K5 at prefill and K6 at a decode step (one query row
against all S_src memory rows is K6's function with ``cache_len`` =
S_src).  The reference's ``encode`` / ``decode`` take no flag: its
kernels are unreachable from them (ROADMAP.md C5).  The layer stacks
are module lists of per-layer dicts (the reference stacks them on a
leading axis: ``interop.encdec_params_from`` carries them across).
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.blocks import remat_wrap
from repro_torch.models.lm import _add_layers_axis, chunked_xent, to_module
from repro_torch.parallel import sharding


def _init_enc_layer(gen, cfg):
    dev = gen.device
    p, s = {}, {}
    p["norm1"], s["norm1"] = L.init_norm(cfg, device=dev)
    p["attn"], s["attn"] = attn.init_attention(gen, cfg)
    p["norm2"], s["norm2"] = L.init_norm(cfg, device=dev)
    p["mlp"], s["mlp"] = L.init_mlp(gen, cfg)
    return p, s


def _init_dec_layer(gen, cfg):
    dev = gen.device
    p, s = {}, {}
    p["norm1"], s["norm1"] = L.init_norm(cfg, device=dev)
    p["self_attn"], s["self_attn"] = attn.init_attention(gen, cfg)
    p["norm_x"], s["norm_x"] = L.init_norm(cfg, device=dev)
    p["cross_attn"], s["cross_attn"] = attn.init_attention(gen, cfg)
    p["norm2"], s["norm2"] = L.init_norm(cfg, device=dev)
    p["mlp"], s["mlp"] = L.init_mlp(gen, cfg)
    return p, s


def init_encdec(cfg, key):
    """Returns (params, specs); ``key`` is a ``torch.Generator`` and the
    params land on its device (see ``lm.init_lm``)."""
    embed_p, embed_s = L.init_embed(key, cfg)
    enc = [_init_enc_layer(key, cfg) for _ in range(cfg.enc_layers)]
    dec = [_init_dec_layer(key, cfg) for _ in range(cfg.num_layers)]
    enc_norm_p, enc_norm_s = L.init_norm(cfg, device=key.device)
    dec_norm_p, dec_norm_s = L.init_norm(cfg, device=key.device)
    params = to_module({"embed": embed_p, "encoder": [p for p, _ in enc],
                        "decoder": [p for p, _ in dec],
                        "enc_norm": enc_norm_p, "final_norm": dec_norm_p})
    specs = {"embed": embed_s,
             "encoder": _add_layers_axis(enc[0][1]),
             "decoder": _add_layers_axis(dec[0][1]),
             "enc_norm": enc_norm_s, "final_norm": dec_norm_s}
    return params, specs


def _positions(B: int, S: int, start: int, device):
    return (start + torch.arange(S, device=device))[None].expand(B, S)


def encode(cfg, params, src_embeds, *, use_kernel=False):
    """src_embeds: (B, S_src, D) precomputed frame embeddings -> memory
    (B, S_src, D) in ``cfg.dtype``."""
    Bsz, S, _ = src_embeds.shape
    positions = _positions(Bsz, S, 0, src_embeds.device)
    x = sharding.shard(src_embeds.to(cfg.dtype), "batch", "seq", "act_embed")

    def body(layer, x):
        a = L.apply_norm(cfg, layer["norm1"], x)
        out, _ = attn.attention_block(cfg, layer["attn"], a,
                                      positions=positions, causal=False,
                                      use_kernel=use_kernel)
        x = x + out
        a = L.apply_norm(cfg, layer["norm2"], x)
        return x + L.apply_mlp(cfg, layer["mlp"], a)

    body = remat_wrap(cfg, body)
    for layer in params["encoder"]:
        x = body(layer, x)
    return L.apply_norm(cfg, params["enc_norm"], x)


def cross_kv(cfg, params, memory):
    """Per-layer cross-attention (K, V) from the encoder memory: a pair of
    (num_layers, B, S_src, Hkv, Dh) tensors (no rope on them)."""
    ks, vs = [], []
    for layer in params["decoder"]:
        ks.append(attn._proj(memory, layer["cross_attn"]["wk"]))
        vs.append(attn._proj(memory, layer["cross_attn"]["wv"]))
    return torch.stack(ks), torch.stack(vs)


def decode(cfg, params, tokens, memory_kv, *, cache=None, cache_len=None,
           use_kernel=False):
    """Decoder stack.  tokens: (B, S); memory_kv from ``cross_kv``; cache
    from ``init_dec_cache`` (written in place) with ``cache_len`` (a host
    int, the length including these tokens), or None.

    Returns (hidden (B, S, D), cache).  Without a cache each layer runs
    inside ``remat_wrap(cfg, ...)``, as the reference's scan body."""
    x = L.embed_tokens(cfg, params["embed"], tokens)
    Bsz, S, _ = x.shape
    start = int(cache_len) - S if cache_len is not None else 0
    positions = _positions(Bsz, S, start, x.device)

    def body(layer, x, mem_k, mem_v, kv_cache=None):
        a = L.apply_norm(cfg, layer["norm1"], x)
        out, _ = attn.attention_block(
            cfg, layer["self_attn"], a, positions=positions, causal=True,
            kv_cache=kv_cache, cache_len=cache_len, use_kernel=use_kernel)
        x = x + out
        a = L.apply_norm(cfg, layer["norm_x"], x)
        out, _ = attn.attention_block(
            cfg, layer["cross_attn"], a, positions=positions, causal=False,
            kv_override=(mem_k, mem_v), use_kernel=use_kernel)
        x = x + out
        a = L.apply_norm(cfg, layer["norm2"], x)
        return x + L.apply_mlp(cfg, layer["mlp"], a)

    mem_k, mem_v = memory_kv
    step = body if cache is not None else remat_wrap(cfg, body)
    for i, layer in enumerate(params["decoder"]):
        kv_cache = ((cache["k"][i], cache["v"][i]) if cache is not None
                    else None)
        x = step(layer, x, mem_k[i], mem_v[i], kv_cache)
    return L.apply_norm(cfg, params["final_norm"], x), cache


def init_dec_cache(cfg, batch: int, max_len: int, *, device=None):
    """The decoder's self-attention cache, zeros: {"k", "v"} each
    (num_layers, batch, max_len, Hkv, Dh) in ``cfg.dtype`` (placed by
    ``KV_AXES`` under a mesh)."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {name: sharding.zeros(shape, cfg.dtype, device, *KV_AXES)
            for name in ("k", "v")}


# logical axes of the decoder's self-attention cache and of the
# cross-attention K / V (the reference's serve_state_specs)
KV_AXES = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
MEM_AXES = ("layers", "batch", None, "kv_heads", "head_dim")


def encdec_loss(cfg, params, batch, use_kernel=False):
    """batch: {"src_embeds": (B, S_src, D), "tokens": (B, S_tgt+1)}:
    the decoder's next-token loss over the encoded source."""
    memory = encode(cfg, params, batch["src_embeds"], use_kernel=use_kernel)
    kv = cross_kv(cfg, params, memory)
    tokens = batch["tokens"]
    hidden, _ = decode(cfg, params, tokens[:, :-1], kv,
                       use_kernel=use_kernel)
    loss = chunked_xent(cfg, params["embed"], hidden, tokens[:, 1:])
    return loss, {"xent": loss, "aux": 0.0}
