"""K4: the Mamba2 / SSD within-chunk dual form for Hopper, beside its
plain PyTorch version.

Port of ``repro/kernels/ssd_chunk.py::ssd_chunk_pallas`` (oracle
``repro/kernels/ref.py::ssd_chunk_ref``):

  ssd_chunk_cuda   (K4) <- ssd_chunk_pallas; plain: ssd_chunk_plain

For each (batch * chunk, head) cell both versions compute, in float32,

  xbar   = x * dt                      cs = cumsum(dt * A)
  L[i,j] = exp(cs[i] - cs[j]) for i >= j, else 0
  y_diag = (C B^T o L) xbar            (Q, p)
  states = (B * decay)^T xbar          (p, n), decay = exp(cs[Q-1] - cs)

The cross-chunk recurrence stays in ``models/ssm.py``.  The CUDA source
is ``csrc/ssd_chunk.cu`` (built by ``build.py`` at first use; its header
note gives the bound and the design): the products run on the tensor
cores in 3xTF32 (each operand split into tf32 hi + lo, three products),
and one block forms C B^T once for a run of heads of one group
(``ssd_plan`` picks how many).

B and C come head-expanded, (b, nc, Q, h, n) as the reference passes
them, or at group granularity, (b, nc, Q, g, n) with g dividing h: head
i reads group i // (h // g).  The function is the same; the group form
saves writing and reading the expanded copies (h / g times the bytes).
The wrapper counts its launches in ``ssd_chunk_cuda.launches``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build

_SOURCE = "ssd_chunk"
# The shapes the kernel takes.  Within them a block's shared memory
# (``ssd_smem``) stays at most 217 KiB of the 227 KiB.
MAX_Q = 128            # the longest chunk (ssm.py's cap)
HEAD_DIMS = (16, 32, 64, 128)  # the head sizes p it is built for
MAX_STATE = 128        # d_state n: a multiple of 4, at most this
# What K4 is held to against its plain version, and the plain version
# against the Pallas kernel: the reference's kernel-vs-oracle bar
# (tests/test_kernels.py:103-106).  Both compute in float32; they differ
# in summation order only.
TOLERANCE = dict(rtol=1e-4, atol=1e-4)
_VP, _I = ctypes.c_void_p, ctypes.c_int
MAX_HEADS = 16         # heads a block shares C B^T over
P_CHUNK = 64           # head-dim columns a block takes at a time


def _heads(Bm, h: int):
    """(b, nc, Q, g, n) with g dividing h -> (b, nc, Q, h, n): head i
    takes group i // (h // g) (``jnp.repeat`` on the group axis)."""
    g = Bm.shape[3]
    if g < 1 or h % g:
        raise ValueError(f"B/C have {g} groups, which must divide the "
                         f"{h} heads")
    return Bm if g == h else Bm.repeat_interleave(h // g, dim=3)


def ssd_chunk_plain(x, dt, A, B, C):
    """Plain version of K4: ``ref.ssd_chunk_ref`` in torch.

    x: (b, nc, Q, h, p); dt: (b, nc, Q, h); A: (h,); B, C: (b, nc, Q, h
    or g, n).  Returns (y_diag (b, nc, Q, h, p), states (b, nc, h, p, n))
    in the inputs' dtype (float32 on the model's path)."""
    h = x.shape[3]
    Bh, Ch = _heads(B, h), _heads(C, h)
    dA_cs = torch.cumsum(dt * A, dim=2)
    xbar = x * dt[..., None]
    Q = x.shape[2]
    seg = dA_cs[..., :, None, :] - dA_cs[..., None, :, :]  # (b,nc,Q,Q,h)
    mask = torch.ones((Q, Q), dtype=torch.bool,
                      device=x.device).tril()[None, None, :, :, None]
    L = torch.exp(torch.where(mask, seg, float("-inf")))  # 0 above
    scores = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh)
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", scores * L, xbar)
    decay = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)
    states = torch.einsum("bcjhn,bcjh,bcjhp->bchpn", Bh, decay, xbar)
    return y_diag, states


@functools.lru_cache(maxsize=None)
def ssd_lib():
    """K4's library (built on first use), with its C signatures."""
    lib = build.load(_SOURCE)
    lib.ssd_chunk_error_string.argtypes = [_I]
    lib.ssd_chunk_error_string.restype = ctypes.c_char_p
    lib.ssd_chunk_launch.argtypes = [_VP] * 7 + [_I] * 7 + [_VP]
    lib.ssd_chunk_launch.restype = _I
    return lib


@dataclasses.dataclass(frozen=True)
class SSDPlan:
    """How K4 runs a call: ``heads`` heads of one group a block (C B^T
    formed once for them), ``blocks`` blocks of 256 threads, ``smem``
    bytes of dynamic shared memory a block."""
    heads: int
    blocks: int
    smem: int


def ssd_smem(Q: int, p: int, n: int, heads: int) -> int:
    """Dynamic shared memory of a K4 block (``ssd_layout`` in
    csrc/ssd_chunk.cu): B and C, and two x slots of min(p, 64) columns, as
    TMA boxes of 32 columns and Q rounded up to 16 rows; dt, cs and decay
    of its heads; three mbarriers; 1024 bytes for aligning the swizzled
    boxes.  Each region is rounded up to 16 bytes."""
    r16 = lambda b: -(-b // 16) * 16
    QP = -(-Q // 16) * 16
    box = 128 * QP
    boxes = 2 * -(-n // 32) + 2 * -(-min(p, P_CHUNK) // 32)
    return boxes * box + 3 * r16(4 * heads * QP) + 32 + 1024


def ssd_plan(BC: int, Q: int, h: int, g: int, p: int, n: int,
             sms: int) -> SSDPlan:
    """K4's heads per block for a call, from its sizes alone.

    A block (8 warps) takes one cell, one group and up to ``MAX_HEADS`` of
    the group's h / g heads (a power of two; the last block of a group may
    hold fewer), and runs alone on its SM.  Cost model: ceil(blocks /
    sms) waves, each as long as one block's work, C B^T (Q^2 n / 2 causal
    products) plus its heads' (Q^2 p / 2 + Q p n each); the cheapest
    wins, ties to fewer heads (more blocks in flight)."""
    hpg = h // g
    best = None
    hb = 1
    while hb <= min(MAX_HEADS, hpg):
        blocks = BC * g * -(-hpg // hb)
        work = Q * Q * n / 2 + hb * (Q * Q * p / 2 + Q * p * n)
        cost = -(-blocks // sms) * work
        if best is None or cost < best[0]:
            best = (cost, SSDPlan(hb, blocks, ssd_smem(Q, p, n, hb)))
        hb *= 2
    return best[1]


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x, dt, A, B, C):
    """Device, dtype, layout and shape checks; returns (b*nc, Q, h, g, p,
    n)."""
    names = ("x", "dt", "A", "B", "C")
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor for the CUDA kernel, got "
                         f"{x.device}")
    for t, name in zip((x, dt, A, B, C), names):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, expected {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if x.dim() != 5:
        raise ValueError(f"x must be (b, nc, Q, h, p), got {tuple(x.shape)}")
    b, nc, Q, h, p = x.shape
    if dt.shape != (b, nc, Q, h):
        raise ValueError(f"dt must be {(b, nc, Q, h)}, got {tuple(dt.shape)}")
    if A.shape != (h,):
        raise ValueError(f"A must be ({h},), got {tuple(A.shape)}")
    if B.dim() != 5 or B.shape[:3] != (b, nc, Q) or C.shape != B.shape:
        raise ValueError(f"B and C must both be (b={b}, nc={nc}, Q={Q}, h or "
                         f"g, n), got {tuple(B.shape)} and {tuple(C.shape)}")
    g, n = B.shape[3], B.shape[4]
    if g < 1 or h % g:
        raise ValueError(f"B/C have {g} groups, which must divide the {h} "
                         f"heads")
    if not 1 <= Q <= MAX_Q:
        raise ValueError(f"chunk length Q={Q} not in [1, {MAX_Q}]")
    if p not in HEAD_DIMS:
        raise ValueError(f"head dim p={p} not built: the kernel takes "
                         f"{HEAD_DIMS}")
    if n % 4 or not 4 <= n <= MAX_STATE:
        raise ValueError(f"state size n={n} must be a multiple of 4 in "
                         f"[4, {MAX_STATE}]")
    if b * nc * h > 2**31 - 1:
        raise ValueError(f"grid (b*nc={b * nc}, h={h}) too large")
    return b * nc, Q, h, g, p, n


def ssd_chunk_cuda(x, dt, A, B, C):
    """K4 on the card: same contract and results (within ``TOLERANCE``)
    as ``ssd_chunk_plain``, for float32 CUDA tensors with Q <= 128, p in
    HEAD_DIMS and n a multiple of 4 up to 128.  The plan taken is left on
    ``ssd_chunk_cuda.plan``."""
    BC, Q, h, g, p, n = _check(x, dt, A, B, C)
    b, nc = x.shape[:2]
    index = x.device.index
    plan = ssd_plan(BC, Q, h, g, p, n, _sms(
        torch.cuda.current_device() if index is None else index))
    ssd_chunk_cuda.plan = plan
    y = torch.empty_like(x)
    st = torch.empty((b, nc, h, p, n), dtype=torch.float32, device=x.device)
    if BC and h:
        err = ssd_lib().ssd_chunk_launch(
            _VP(x.data_ptr()), _VP(dt.data_ptr()), _VP(A.data_ptr()),
            _VP(B.data_ptr()), _VP(C.data_ptr()), _VP(y.data_ptr()),
            _VP(st.data_ptr()), BC, Q, h, g, p, n, plan.heads,
            _VP(torch.cuda.current_stream(x.device).cuda_stream))
        if err != 0:
            msg = ssd_lib().ssd_chunk_error_string(err).decode()
            raise RuntimeError(f"ssd_chunk launch: CUDA error {err} ({msg})")
        ssd_chunk_cuda.launches += 1
    return y, st


ssd_chunk_cuda.launches = 0
ssd_chunk_cuda.plan = None
