"""GQA attention: online-softmax flash for prefill, dense for decode.

Port of ``repro/models/attention.py``.  Head grouping: q heads are
reshaped to (kv_heads, group) so the kv tensors are never repeated.  With
``use_kernel`` the no-cache forward runs ``kernels.ops.flash_attention``
(K5) and a decode step ``kernels.ops.decode_attention`` (K6); prefill
with a cache runs the plain ``flash_attention`` below, as the reference's
does.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope, normal

# KV block of the plain flash loop (the reference takes it from
# parallel/compile_mode.flash_block_size(), 512).
FLASH_BLOCK_KV = 512


def init_attention(gen, cfg):
    D, Hq, Hkv, Dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim)
    s = (2.0 / D) ** 0.5
    p = {
        "wq": normal(gen, (D, Hq, Dh), cfg.dtype, s),
        "wk": normal(gen, (D, Hkv, Dh), cfg.dtype, s),
        "wv": normal(gen, (D, Hkv, Dh), cfg.dtype, s),
        "wo": normal(gen, (Hq, Dh, D), cfg.dtype, (2.0 / (Hq * Dh)) ** 0.5),
    }
    specs = {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }
    return p, specs


def flash_attention(q, k, v, *, causal=True, q_offset=0, block_kv=None,
                    bias=None):
    """Online-softmax attention, looped over KV blocks.

    q: (B, Sq, Hq, Dh); k, v: (B, Skv, Hkv, Dh) with Hq % Hkv == 0.
    ``q_offset``: absolute position of q[0] (for chunked prefill).
    Fully masked rows (-inf) are guarded as in the reference.
    Returns (B, Sq, Hq, Dh) in q.dtype.
    """
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    blk = min(block_kv or FLASH_BLOCK_KV, Skv)
    if Skv % blk:
        raise ValueError(f"Skv={Skv} must be a multiple of the block {blk}")
    dev = q.device
    qg = q.reshape(B, Sq, Hkv, G, Dh).float()
    scale = Dh ** -0.5
    q_pos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, Hkv, G, Sq), float("-inf"), device=dev)
    l = torch.zeros((B, Hkv, G, Sq), device=dev)
    acc = torch.zeros((B, Hkv, G, Sq, Dh), device=dev)
    for start in range(0, Skv, blk):
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                         k[:, start:start + blk].float()) * scale
        if causal:
            k_pos = start + torch.arange(blk, device=dev)
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                            float("-inf"))
        if bias is not None:
            s = s + bias
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows (m_new = -inf): exp(-inf - -inf) -> nan
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        corr = torch.exp(torch.where(torch.isfinite(m), m - m_safe,
                                     float("-inf")))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p, v[:, start:start + blk].float())
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    # b h g q d -> b q (h g) d
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, Dh).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len):
    """Single-step attention against a (possibly longer) KV cache.

    q: (B, 1, Hq, Dh); caches: (B, S, Hkv, Dh); cache_len: int, () or
    (B,) valid prefix length (new token's k/v already written at
    cache_len - 1).  Scores and the value sum in float32 from the storage
    dtype's values (exact products, as the reference's
    preferred_element_type); the probabilities are rounded to the cache's
    dtype before the value sum, as the reference does.
    """
    B, _, Hq, Dh = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, Dh)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(),
                     k_cache.float()) * Dh ** -0.5
    pos = torch.arange(S, device=q.device)
    lens = torch.as_tensor(cache_len, device=q.device).expand(B)
    valid = pos[None] < lens[:, None]  # (B, S)
    s = torch.where(valid[:, None, None], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, Hq, Dh).to(q.dtype)


def attention_ref(q, k, v, *, causal=True, q_offset=0):
    """Naive O(S^2) oracle for tests."""
    B, Sq, Hq, Dh = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, Dh).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * Dh ** -0.5
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        mask = q_pos[:, None] >= torch.arange(k.shape[1],
                                              device=q.device)[None, :]
        s = torch.where(mask, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, Dh).to(q.dtype)


def _proj(x, w):
    """x (B, S, D) @ w (D, H, Dh) -> (B, S, H, Dh)."""
    D, H, Dh = w.shape
    return (x @ w.reshape(D, H * Dh)).reshape(*x.shape[:-1], H, Dh)


def attention_block(cfg, params, x, *, positions, causal=True, kv_cache=None,
                    cache_len=None, kv_override=None, use_kernel=False):
    """Full attention sublayer: qkv proj -> rope -> attention -> out proj.

    kv_cache: None (prefill / forward; returns the new kv) or
      (k_cache, v_cache) — the new tokens are written at
      [cache_len - S_new, cache_len) and attention runs against the valid
      prefix.  ``cache_len`` is then a host int.
    kv_override: (k, v) from an encoder for cross-attention (no rope on kv).
    Returns (out, (k, v)) — the kv actually used (the caches, with a cache).

    The cache is written IN PLACE (the reference builds a new cache: a
    one-hot masked write for decode, dynamic_update_slice for prefill).
    The values are the same; the in-place write saves the two full passes
    over the cache that the masked write makes.
    """
    q = _proj(x, params["wq"])
    if kv_override is None:
        k = _proj(x, params["wk"])
        v = _proj(x, params["wv"])
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    else:
        k, v = kv_override

    if kv_cache is not None:
        k_cache, v_cache = kv_cache
        S_new = k.shape[1]
        idx = int(cache_len) - S_new
        k_cache[:, idx:idx + S_new] = k.to(k_cache.dtype)
        v_cache[:, idx:idx + S_new] = v.to(v_cache.dtype)
        if S_new == 1:
            if use_kernel:
                out = kops.decode_attention(q, k_cache, v_cache,
                                            int(cache_len))
            else:
                out = decode_attention(q, k_cache, v_cache, cache_len)
        else:
            # chunked prefill: causal flash over the cache; the causal mask
            # with q_offset ignores the unwritten tail positions.
            out = flash_attention(q, k_cache, v_cache, causal=True,
                                  q_offset=idx)
        k, v = k_cache, v_cache
    elif use_kernel:
        out = kops.flash_attention(q, k, v, causal=causal)
    else:
        out = flash_attention(q, k, v, causal=causal)

    Hq, Dh, D = params["wo"].shape
    out = out.reshape(*out.shape[:2], Hq * Dh) @ params["wo"].reshape(
        Hq * Dh, D)
    return out, (k, v)
