"""K5: flash attention (GQA, causal or full, online softmax) for Hopper,
beside its plain PyTorch version.

Port of ``repro/kernels/flash_attention.py::flash_attention_pallas``:

  flash_attention_cuda   (K5) <- flash_attention_pallas; plain: flash_attention_plain

The CUDA source is ``csrc/attention.cu`` (built by ``build.py`` at first
use; its header note gives the bound and the design).  Both versions
compute what the Pallas body computes: inputs converted to float32,
scores ``(q . k) * D**-0.5``, causal positions from 0 with masked scores
at ``NEG_INF = -1e30``, the online softmax over KV blocks in float32,
``l`` floored at 1e-30, the output in q's dtype; query head h reads KV
head ``h // (Hq // Hkv)`` (by index, K/V never repeated).  The
reference's block contract is kept and raised on, not padded: Sq and Skv
must be multiples of ``min(block_q, Sq)`` and ``min(block_k, Skv)``.

The wrapper counts its launches in ``flash_attention_cuda.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_SOURCE = "attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # codes of csrc/attention.cu
HEAD_DIMS = (32, 64, 128)  # the head sizes the CUDA kernels are built for
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# What K5/K6 are held to against their plain versions (and the plain
# versions against the Pallas kernels).  float32: the reference's kernel
# bar (tests/test_kernels.py:20-22).  bfloat16: both sides compute in
# float32 and round once, so where the float32 results straddle a rounding
# edge they differ by one bf16 ulp, at most 2**-7 of the value; the bar
# allows two, plus 1e-4 near 0 (the float32 differences are about 2e-6).
# The reference's bf16 bar, 2e-2 absolute, is as large as a typical output
# at the serving shapes and passes a kernel that drops one key in sixteen.
TOLERANCE = {torch.float32: dict(rtol=2e-5, atol=2e-5),
             torch.bfloat16: dict(rtol=1.6e-2, atol=1e-4)}


@functools.lru_cache(maxsize=None)
def attention_lib():
    """The attention kernels' library (built on first use), with its C
    signatures; shared with ``decode_attention``."""
    lib = build.load(_SOURCE)
    lib.attention_error_string.argtypes = [_I]
    lib.attention_error_string.restype = ctypes.c_char_p
    lib.flash_attention_launch.argtypes = [_VP] * 4 + [_I] * 7 + [_F, _I, _VP]
    lib.flash_attention_launch.restype = _I
    lib.decode_attention_launch.argtypes = [_VP] * 7 + [_I] * 8 + [_F, _I,
                                                                   _VP]
    lib.decode_attention_launch.restype = _I
    return lib


def raw_stream(device) -> int:
    """The handle of PyTorch's current stream on ``device``, as an int
    (the private binding skips building a ``torch.cuda.Stream`` object,
    microseconds a call on the decode loop's host-bound path)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def raise_on(err: int, what: str):
    if err != 0:
        msg = attention_lib().attention_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def block_contract(S: int, block: int, what: str) -> int:
    """The reference's block size ``min(block, S)``; raises unless it
    divides S."""
    blk = min(block, S)
    if blk < 1 or S % blk:
        raise ValueError(f"{what}={S} must be a multiple of its block "
                         f"min({block}, {S})={blk}")
    return blk


def check_operands(q, kv, names, device):
    """Dtype, layout, head and alignment checks shared by K5 and K6.
    ``kv``: the (k, v) pair; returns (dtype code, Hkv)."""
    if q.device.type != "cuda":
        raise ValueError(f"{names[0]} must be a CUDA tensor for the CUDA "
                         f"kernel, got {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{names[0]} must be float32 or bfloat16, got "
                        f"{q.dtype}")
    B, _, Hq, D = q.shape
    Hkv = kv[0].shape[2]
    for x, name in zip((q, *kv), names):
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype} like "
                            f"{names[0]}, got {x.dtype}")
        if x.dim() != 4 or x.shape[0] != B or x.shape[3] != D:
            raise ValueError(f"{name} must be (B={B}, S, H, D={D}), got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if kv[1].shape != kv[0].shape:
        raise ValueError(f"{names[2]} {tuple(kv[1].shape)} must match "
                         f"{names[1]} {tuple(kv[0].shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not built: the CUDA kernels take "
                         f"{HEAD_DIMS}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    if B * Hq > 65535:
        raise ValueError(f"B * Hq = {B * Hq} exceeds the grid's 65535")
    return _DTYPES[q.dtype], Hkv


def flash_attention_plain(q, k, v, *, causal=True, block_q=128,
                          block_k=128):
    """Plain version of K5: the Pallas body's loop over KV blocks.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D).  Returns (B, Sq, Hq, D)
    in q's dtype.  (Query blocks do not change the math, so all query
    rows run at once.)"""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    G = Hq // Hkv
    block_contract(Sq, block_q, "Sq")
    blk = block_contract(Skv, block_k, "Skv")
    scale = D ** -0.5
    qg = q.float().reshape(B, Sq, Hkv, G, D)
    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, G, Sq, D), dtype=torch.float32,
                      device=q.device)
    q_pos = torch.arange(Sq, device=q.device)
    for start in range(0, Skv, blk):
        kb = k[:, start:start + blk].float()
        vb = v[:, start:start + blk].float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kb) * scale
        if causal:
            k_pos = start + torch.arange(blk, device=q.device)
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p,
                                                   vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)


def flash_attention_cuda(q, k, v, *, causal=True, block_q=128, block_k=128):
    """K5 on the card: same contract and results as
    ``flash_attention_plain`` (within float32 rounding; in bfloat16 P
    enters the tensor cores as a hi + lo pair of bf16).  ``block_q`` /
    ``block_k`` keep the reference's divisibility contract; the kernels
    tile by their own: 128 query rows and 128-key K/V tiles on the tensor
    cores (bfloat16), 64 rows and 32-key tiles on the CUDA cores
    (float32)."""
    dtype, Hkv = check_operands(q, (k, v), ("q", "k", "v"), q.device)
    B, Sq, Hq, D = q.shape
    Skv = k.shape[1]
    block_contract(Sq, block_q, "Sq")
    block_contract(Skv, block_k, "Skv")
    out = torch.empty_like(q)
    if out.numel():
        err = attention_lib().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Skv, Hq, Hkv, D, int(bool(causal)), D ** -0.5, dtype,
            raw_stream(q.device))
        raise_on(err, "flash_attention launch")
        flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
