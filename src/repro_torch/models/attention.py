"""GQA attention: online-softmax flash for prefill, dense for decode.

Port of ``repro/models/attention.py``.  Head grouping: q heads are
reshaped to (kv_heads, group) so the kv tensors are never repeated.  With
``use_kernel`` the no-cache forward runs ``kernels.ops.flash_attention``
(K5), as does a prefill that fills its cache from row 0, and a decode
step ``kernels.ops.decode_attention`` (K6), as does a one-row
cross-attention (``kv_override``); any other prefill with a cache runs the
plain ``flash_attention`` below, as the reference's does.  The
``shard`` annotations are the reference's (identity without a mesh); under
a mesh whose axes split a cache's sequence, the new rows are written with
the reference's masked select, which stays shard-local.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope, normal
from repro_torch.parallel import compile_mode
from repro_torch.parallel.sharding import (grad_placed, reshape_last, shard,
                                           split_counts)


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
    Fully masked rows (-inf) are guarded as in the reference.  The KV
    block is ``compile_mode.flash_block_size()`` unless ``block_kv`` is
    given.  The running max, sum and accumulator start from the first
    block's (the reference's -inf / 0 / 0 start folded in: the same
    values), so that under a mesh they take the blocks' placements.
    Returns (B, Sq, Hq, Dh) in q.dtype.
    """
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    blk = min(block_kv or compile_mode.flash_block_size(), Skv)
    if Skv % blk:
        raise ValueError(f"Skv={Skv} must be a multiple of the block {blk}")
    dev = q.device
    qg = q.reshape(B, Sq, Hkv, G, Dh).float()
    scale = Dh ** -0.5
    q_pos = q_offset + torch.arange(Sq, device=dev)
    m = l = acc = None
    for start in range(0, Skv, blk):
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                         k[:, start:start + blk].float()) * scale
        if causal:
            k_pos = start + torch.arange(blk, device=dev)
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                            float("-inf"))
        if bias is not None:
            s = s + bias
        m_new = s.amax(dim=-1) if m is None else torch.maximum(
            m, s.amax(dim=-1))
        # guard fully-masked rows (m_new = -inf): exp(-inf - -inf) -> nan
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p,
                          v[:, start:start + blk].float())
        if m is None:
            l, acc = p.sum(dim=-1), pv
        else:
            corr = torch.exp(torch.where(torch.isfinite(m), m - m_safe,
                                         float("-inf")))
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + pv
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
    if isinstance(cache_len, int):
        valid = (pos < cache_len)[None]  # (1, S)
    else:
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
    return reshape_last(x @ grad_placed(w.reshape(D, H * Dh)), H, Dh)


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
    q = shard(_proj(x, params["wq"]), "batch", "seq", "heads", "head_dim")
    if kv_override is None:
        k = shard(_proj(x, params["wk"]), "batch", "seq", "kv_heads",
                  "head_dim")
        v = shard(_proj(x, params["wv"]), "batch", "seq", "kv_heads",
                  "head_dim")
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    else:
        k, v = kv_override

    if kv_cache is not None:
        k_cache, v_cache = kv_cache
        S_new = k.shape[1]
        idx = int(cache_len) - S_new
        _write_rows(k_cache, k, idx)
        _write_rows(v_cache, v, idx)
        k_cache = shard(k_cache, "batch", "kv_seq", "kv_heads", "head_dim")
        v_cache = shard(v_cache, "batch", "kv_seq", "kv_heads", "head_dim")
        if S_new == 1:
            out = (kops.decode_attention(q, k_cache, v_cache, int(cache_len))
                   if use_kernel else
                   _attend(decode_attention, q, k_cache, v_cache, cache_len))
        elif idx == 0 and S_new == k_cache.shape[1]:
            # a prefill that fills the cache: its rows are the new k / v
            # (which a mesh does not split along the sequence), so this is
            # the no-cache forward's attention, K5 included
            k_new, v_new = k.to(k_cache.dtype), v.to(v_cache.dtype)
            out = (kops.flash_attention(q, k_new, v_new, causal=True)
                   if use_kernel else
                   _attend(flash_attention, q, k_new, v_new, causal=True))
        else:
            # chunked prefill: causal flash over the cache; the causal mask
            # with q_offset ignores the unwritten tail positions.
            out = _attend(flash_attention, q, k_cache, v_cache, causal=True,
                          q_offset=idx)
        k, v = k_cache, v_cache
    elif use_kernel and kv_override is not None and q.shape[1] == 1:
        # cross-attention at a decode step: one query row against all the
        # memory rows is K6's function with cache_len = S_src
        out = kops.decode_attention(q, k, v, k.shape[1])
    elif use_kernel:
        out = kops.flash_attention(q, k, v, causal=causal)
    else:
        out = _attend(flash_attention, q, k, v, causal=causal)

    Hq, Dh, D = params["wo"].shape
    out = grad_placed(out.reshape(*out.shape[:2], Hq * Dh)) @ grad_placed(
        params["wo"].reshape(Hq * Dh, D))
    return shard(out, "batch", "seq", "act_embed"), (k, v)


def _attend(fn, q, k, v, *args, **kw):
    """``fn(q, k, v, ...)``: a plain attention core.  Under a mesh (DTensor
    arguments) each rank attends its own (batch, head) shard, as an SPMD
    program does: DTensor plans no product over two split batch axes
    (batch and heads).  q, k and v must then share their placements, split
    evenly, with the sequences whole; otherwise (kv heads that do not
    divide the axis, a split sequence) all three keep only the batch's."""
    mesh = getattr(q, "device_mesh", None)
    if mesh is None:
        return fn(q, k, v, *args, **kw)
    from torch.distributed.tensor import DTensor

    if q.shape[1] == 1 and _seq_split(k):
        # one query row against a sequence-split cache (decode): DTensor's
        # own plan splits the scores along the cache; it has no product of
        # a head-split q with it, so q's heads are gathered
        return fn(shard(q, "batch", "seq", None, "head_dim"), k, v, *args,
                  **kw)
    split = [split_counts(t) for t in (q, k, v)]
    if not (q.placements == k.placements == v.placements) or any(
            1 in c or any(t.shape[d] % n for d, n in c.items())
            for t, c in zip((q, k, v), split)):
        q, k, v = (shard(t, "batch", None, None, None) for t in (q, k, v))
    out = fn(q.to_local(), k.to_local(), v.to_local(), *args, **kw)
    return DTensor.from_local(out.contiguous(), mesh, q.placements,
                              run_check=False, shape=q.shape,
                              stride=q.stride())


def _write_rows(cache, new, idx: int):
    """cache[:, idx:idx + S_new] = new, in place.  A cache whose sequence
    axis is split across ranks (a DTensor sharded on dim 1) takes the
    reference's masked select over the whole cache instead: a row slice
    of a split axis would gather and re-scatter the cache."""
    S, S_new = cache.shape[1], new.shape[1]
    new = new.to(cache.dtype)
    if not _seq_split(cache):
        cache[:, idx:idx + S_new] = new
        return
    if S_new == S:  # a prefill that fills the cache: one redistribution
        cache.copy_(new)
        return
    # every rank holds the new rows and selects those of its own shard
    new = shard(new, "batch", None, None, None)
    if S_new > 1:
        new = torch.nn.functional.pad(new, (0, 0, 0, 0, idx, S - idx - S_new))
    pos = torch.arange(S, device=cache.device)
    rows = ((pos >= idx) & (pos < idx + S_new))[None, :, None, None]
    cache.copy_(torch.where(rows, new, cache))


def _seq_split(cache) -> bool:
    return any(p.is_shard(1) for p in getattr(cache, "placements", ()))
