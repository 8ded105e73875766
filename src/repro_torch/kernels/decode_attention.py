"""K6: flash-decode (one query token against a KV cache) for Hopper,
beside its plain PyTorch version.

Port of ``repro/kernels/decode_attention.py::decode_attention_pallas``:

  decode_attention_cuda   (K6) <- decode_attention_pallas; plain: decode_attention_plain

The CUDA source is ``csrc/attention.cu`` (its header note gives the bound
and the design).  Both versions compute what the Pallas body computes:
float32 scores ``(q . k) * D**-0.5``, positions at or past the scalar
``cache_len`` masked to ``NEG_INF = -1e30``, the online softmax over KV
blocks, ``l`` floored at 1e-30, the output in q's dtype, query head h
reading KV head ``h // (Hq // Hkv)``.  The kernel reads only the keys
below ``cache_len``: the masked tail contributes exactly 0 once a real
key has set the running max, which key 0 always does.

``cache_len`` is a Python int (or a 0-d CPU tensor): the model knows the
length on the host, so the launch needs no device-to-host read.  It must
be at least 1; past the cache's length it means the whole cache, as in
the Pallas kernel.  The wrapper counts its launches in
``decode_attention_cuda.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.flash_attention import (NEG_INF, attention_lib,
                                                 block_contract,
                                                 check_operands, raise_on)

_VP = ctypes.c_void_p


def _length(cache_len) -> int:
    if isinstance(cache_len, torch.Tensor) and cache_len.device.type != "cpu":
        raise ValueError("cache_len must be a host int (or CPU tensor): a "
                         "device tensor would cost a sync per launch")
    n = int(cache_len)
    if n < 1:
        raise ValueError(f"cache_len={n} must be >= 1")
    return n


def decode_attention_plain(q, k_cache, v_cache, cache_len, *, block_k=128):
    """Plain version of K6: the Pallas body's loop over KV blocks.

    q: (B, 1, Hq, D); caches (B, S, Hkv, D); cache_len: scalar int.
    Returns (B, 1, Hq, D) in q's dtype."""
    B, _, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    G = Hq // Hkv
    blk = block_contract(S, block_k, "S")
    n = _length(cache_len)
    scale = D ** -0.5
    qg = q.float().reshape(B, Hkv, G, D)
    m = torch.full((B, Hkv, G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, G, D), dtype=torch.float32, device=q.device)
    for start in range(0, S, blk):
        kb = k_cache[:, start:start + blk].float()
        vb = v_cache[:, start:start + blk].float()
        s = torch.einsum("bhgd,bkhd->bhgk", qg, kb) * scale
        k_pos = start + torch.arange(blk, device=q.device)
        s = torch.where(k_pos < n, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgk,bkhd->bhgd", p, vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, 1, Hq, D).to(q.dtype)


def decode_attention_cuda(q, k_cache, v_cache, cache_len, *, block_k=128):
    """K6 on the card: same contract and results (within float32
    rounding) as ``decode_attention_plain``.  ``block_k`` keeps the
    reference's divisibility contract (S a multiple of min(block_k, S));
    the kernel streams the valid keys without blocks."""
    dtype, Hkv = check_operands(q, (k_cache, v_cache),
                                ("q", "k_cache", "v_cache"), q.device)
    B, one, Hq, D = q.shape
    if one != 1:
        raise ValueError(f"q must be (B, 1, Hq, D), got {tuple(q.shape)}")
    S = k_cache.shape[1]
    block_contract(S, block_k, "S")
    n = min(_length(cache_len), S)
    out = torch.empty_like(q)
    if out.numel():
        err = attention_lib().decode_attention_launch(
            _VP(q.data_ptr()), _VP(k_cache.data_ptr()),
            _VP(v_cache.data_ptr()), _VP(out.data_ptr()), B, S, Hq, Hkv, D, n,
            D ** -0.5, dtype, _VP(torch.cuda.current_stream(q.device)
                                  .cuda_stream))
        raise_on(err, "decode_attention launch")
        decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
