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
the Pallas kernel.

The kernel splits the valid keys as ``split_plan`` says; each split
leaves float32 partials (m, l, acc) that a second kernel merges as
``merge_partials_plain`` does (``decode_partials_plain`` is the plain
form of one split's work).  ``decode_attention_cuda.launches`` counts
calls: one per attention layer per decode step, though a call with more
than one split is two device launches.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels.flash_attention import (NEG_INF, attention_lib,
                                                 block_contract,
                                                 check_operands, raise_on,
                                                 raw_stream)

_SMS = 132        # streaming multiprocessors of an H100 SXM
_MIN_KEYS = 256   # keys of the shortest split worth a block of its own
_TILE = 64        # keys of the kernel's tile (csrc/attention.cu kDecTK)


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


@functools.lru_cache(maxsize=None)
def split_plan(B: int, Hkv: int, n: int) -> tuple:
    """The kernel's split of the valid keys [0, n): ((start, stop), ...),
    contiguous, non-empty, each but the last a multiple of the kernel's
    64-key tile long.  As many splits as put about one block on every SM
    (B * Hkv blocks a split), and none shorter than ``_MIN_KEYS`` keys:
    on the card more splits than that only add partials to merge, and
    B * Hkv >= 132 (or a short cache, as in the serving loop) is one split
    and one launch."""
    if n < 1:
        raise ValueError(f"n={n} must be >= 1")
    splits = max(1, min(_SMS // max(B * Hkv, 1), n // _MIN_KEYS))
    size = -(-(-(-n // splits)) // _TILE) * _TILE
    return tuple((s, min(n, s + size)) for s in range(0, n, size))


def decode_partials_plain(q, k_cache, v_cache, start, stop):
    """One split's work in plain torch: float32 (m, l, acc) of the keys
    [start, stop) in one softmax pass.  q: (B, 1, Hq, D); returns m, l
    (B, Hq) and acc (B, Hq, D), unnormalised."""
    B, _, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    qg = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg,
                     k_cache[:, start:stop].float()) * D ** -0.5
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    acc = torch.einsum("bhgk,bkhd->bhgd", p, v_cache[:, start:stop].float())
    return (m.reshape(B, Hq), p.sum(dim=-1).reshape(B, Hq),
            acc.reshape(B, Hq, D))


def merge_partials_plain(m, l, acc):
    """Plain version of the merge kernel: the splits' partials m, l
    (..., P) and acc (..., P, D) combined in split order into the
    normalised float32 output (..., D)."""
    M = m.amax(dim=-1, keepdim=True)
    w = torch.exp(m - M)
    L = torch.clamp_min((l * w).sum(dim=-1), 1e-30)
    return (acc * w[..., None]).sum(dim=-2) / L[..., None]


def decode_attention_cuda(q, k_cache, v_cache, cache_len, *, block_k=128):
    """K6 on the card: same contract and results (within float32
    rounding) as ``decode_attention_plain``.  ``block_k`` keeps the
    reference's divisibility contract (S a multiple of min(block_k, S));
    the kernel streams the valid keys in its own 64-key tiles, split as
    ``split_plan`` says."""
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
        plan = split_plan(B, Hkv, n)
        P = len(plan)
        pm = pl = pa = None  # float32 partials (m, l, acc) of P > 1 splits
        if P > 1:
            part = torch.empty(B * Hq * P * (D + 2), dtype=torch.float32,
                               device=q.device)
            pm = part.data_ptr()
            pl = pm + 4 * B * Hq * P
            pa = pl + 4 * B * Hq * P
        err = attention_lib().decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), pm, pl, pa, B, S, Hq, Hkv, D, n, plan[0][1], P,
            D ** -0.5, dtype, raw_stream(q.device))
        raise_on(err, "decode_attention launch")
        decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
