"""OnAlgo hot-loop kernels for Hopper, each beside its plain PyTorch version.

Port of ``repro/kernels/onalgo_step.py`` (Pallas, TPU) and of the
oracles in ``repro/kernels/ref.py``:

  onalgo_duals_cuda    (K3) <- onalgo_duals_pallas;   plain: onalgo_duals_plain
  onalgo_chunked_cuda  (K1) <- onalgo_chunked_pallas; plain: onalgo_chunked_plain
  onalgo_tiled_cuda    (K2) <- onalgo_tiled_pallas;   plain: onalgo_chunked_plain

The CUDA sources are ``csrc/onalgo_step.cu`` (built by ``build.py`` at
first use); its header note gives each kernel's bound and design.  The
TPU layout is not carried over: no lane/row padding, no (K, N, C) stream
layout.  ``j`` and the overlay streams are row-major (T, N), the shared
(M,) tables are read with row stride 0, and ``off`` comes back as bool.

The plain versions fix one summation order (``row_sum``; device sums in
float64) and the per-slot scalars (``step_tables``), and the kernels
reproduce both, so on the same inputs a kernel's decisions, visit counts
and duals equal its plain version's bit for bit.  Against the JAX
reference, which sums in XLA's order, duals agree to allclose and
decisions exactly except at float ties.

Each wrapper counts its launches in a plain int attribute
(``onalgo_chunked_cuda.launches`` ...), so a run can show it went through
the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import build

_WARP = 32
_SOURCE = "onalgo_step"
_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ROLLOUT_ARGS = ([_VP] * 4 + [_VP, _LL] * 3 + [_VP] * 11 + [_I] * 3)
_DUALS_BLOCK_N = 256  # devices per block of K3
_MAX_BLOCKS: dict = {}


# --------------------------------------------------------------------------
# shared pieces of the plain versions and the wrappers

def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum an (N, M) tensor over M in the kernels' order: lane l of a warp
    adds columns l, l + 32, ... in turn, then the 32 lane sums are halved
    (16, 8, 4, 2, 1) as ``__shfl_down_sync`` does."""
    N, M = x.shape
    x = F.pad(x, (0, -M % _WARP)).view(N, -1, _WARP)
    acc = x[:, 0]
    for c in range(1, x.shape[1]):
        acc = acc + x[:, c]
    width = _WARP
    while width > 1:
        width //= 2
        acc = acc[:, :width] + acc[:, width:2 * width]
    return acc[:, 0]


def step_tables(a, beta, t0: int, T: int):
    """float32 (T,) step sizes a / t^beta and reciprocals 1 / t for the
    slots t = t0 + 1 .. t0 + T (float32 arithmetic)."""
    t = np.arange(int(t0) + 1, int(t0) + T + 1, dtype=np.float32)
    a_seq = np.float32(float(a)) / t ** np.float32(float(beta))
    inv_t = np.float32(1.0) / t
    return a_seq.astype(np.float32), inv_t.astype(np.float32)


def _check(x, name, dtype, shape, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return x


def _table(x, name, N, M, device):
    """A value table for the kernels: (M,) shared (row stride 0) or (N, M)
    per device (row stride M).  Returns (tensor, row stride)."""
    if tuple(x.shape) == (M,):
        return _check(x, name, torch.float32, (M,), device), 0
    return _check(x, name, torch.float32, (N, M), device), M


def _scalar(x, device):
    """A fresh (1,) float32 device tensor holding scalar ``x`` (the kernels
    may write it)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).reshape(1).clone()
    return torch.full((1,), float(x), dtype=torch.float32, device=device)


def _ptr(x):
    return _VP(None if x is None else x.data_ptr())


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernels' library (built on first use), with its C signatures."""
    lib = build.load(_SOURCE)
    lib.onalgo_error_string.argtypes = [_I]
    lib.onalgo_error_string.restype = ctypes.c_char_p
    lib.onalgo_threads_per_block.argtypes = []
    lib.onalgo_threads_per_block.restype = _I
    lib.onalgo_duals_launch.argtypes = (
        [_VP] * 4 + [_LL, _VP, _LL, _VP, _LL] + [_VP] * 3 + [_I] * 3 + [_VP])
    lib.onalgo_duals_launch.restype = _I
    lib.onalgo_chunked_max_blocks.argtypes = [ctypes.POINTER(_I)]
    lib.onalgo_chunked_max_blocks.restype = _I
    lib.onalgo_chunked_launch.argtypes = _ROLLOUT_ARGS + [_I, _VP]
    lib.onalgo_chunked_launch.restype = _I
    lib.onalgo_tiled_launch.argtypes = _ROLLOUT_ARGS + [_I, _VP]
    lib.onalgo_tiled_launch.restype = _I
    return lib


def _raise_on(err: int, what: str):
    if err != 0:
        msg = _lib().onalgo_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def _stream(device):
    return _VP(torch.cuda.current_stream(device).cuda_stream)


def _cuda_device(x, name):
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor for the CUDA kernel, "
                         f"got {x.device}")
    return x.device


# --------------------------------------------------------------------------
# K3: single-slot policy + dual subgradients

def onalgo_duals_plain(lam, mu, rho, o_tab, h_tab, w_tab, B):
    """Plain version of K3 (port of ``ref.onalgo_duals_ref``).

    lam (N,), mu (), rho (N, M), tables (M,) or (N, M), B (N,).  Returns
    (g_pow (N,), load ()):
      y[n, j] = 1{lam_n o_j + mu h_j < w_j, w_j > 0}
      g_pow_n = sum_j o_j rho_nj y_nj - B_n;  load = sum_nj h_j rho_nj y_nj
    """
    N, M = rho.shape
    mu = torch.as_tensor(mu, dtype=torch.float32, device=rho.device)
    o, h, w = (t.expand(N, M) for t in (o_tab, h_tab, w_tab))
    price = lam[:, None] * o + mu * h
    ry = torch.where((price < w) & (w > 0), rho, 0.0)
    g_pow = row_sum(o * ry) - B
    load = row_sum(h * ry).double().sum().float()
    return g_pow, load


def onalgo_duals_cuda(lam, mu, rho, o_tab, h_tab, w_tab, B):
    """K3 on the card: same contract as ``onalgo_duals_plain``.  One block
    per 256 devices writes g_pow and a float64 load partial; the partials
    are summed here, as the reference sums its tile partials outside the
    kernel."""
    dev = _cuda_device(rho, "rho")
    N, M = rho.shape
    _check(rho, "rho", torch.float32, (N, M), dev)
    _check(lam, "lam", torch.float32, (N,), dev)
    _check(B, "B", torch.float32, (N,), dev)
    o, os_ = _table(o_tab, "o_tab", N, M, dev)
    h, hs = _table(h_tab, "h_tab", N, M, dev)
    w, ws = _table(w_tab, "w_tab", N, M, dev)
    mu_t = _scalar(mu, dev)
    g_pow = torch.empty((N,), dtype=torch.float32, device=dev)
    part = torch.empty((-(-N // _DUALS_BLOCK_N),), dtype=torch.float64,
                       device=dev)
    if N:
        err = _lib().onalgo_duals_launch(
            _ptr(lam), _ptr(mu_t), _ptr(rho), _ptr(o), os_, _ptr(h), hs,
            _ptr(w), ws, _ptr(B), _ptr(g_pow), _ptr(part), N, M,
            _DUALS_BLOCK_N, _stream(dev))
        _raise_on(err, "onalgo_duals launch")
        onalgo_duals_cuda.launches += 1
    return g_pow, part.sum().float()


onalgo_duals_cuda.launches = 0


# --------------------------------------------------------------------------
# K1 / K2: the fused T-slot rollout

def onalgo_chunked_plain(j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab, B,
                         H, a, beta, *, t0=0, slot_values=None):
    """Plain version of K1 and K2 (port of ``ref.onalgo_chunked_ref``),
    slot-sequential.

    j_seq (T, N) state indices; lam0 (N,), mu0 (), counts0 (N, M): the
    algorithm state entering slot t0 + 1.  o/h/w tables ((M,) or (N, M)),
    B (N,) and H () are already in the dual space.  ``slot_values``:
    optional (o, h, w) raw (T, N) streams (service overlay, dual space)
    driving the realized decision instead of the table gather, gated on
    j > 0.  Returns (offload (T, N) bool, mu_seq (T,), lam_norm_seq (T,),
    lam (N,), mu (), counts (N, M)); the inputs are not modified.
    """
    T, N = j_seq.shape
    M = counts0.shape[-1]
    dev = j_seq.device
    a_seq, inv_t = step_tables(a, beta, t0, T)
    o, h, w = (t.float().expand(N, M) for t in (o_tab, h_tab, w_tab))
    B = torch.as_tensor(B, dtype=torch.float32, device=dev).expand(N)
    H = torch.as_tensor(H, dtype=torch.float32, device=dev)
    lam = lam0.float().clone()
    mu = torch.as_tensor(mu0, dtype=torch.float32, device=dev).clone()
    counts = counts0.float().clone()
    rows = torch.arange(N, device=dev)
    off = torch.empty((T, N), dtype=torch.bool, device=dev)
    mu_seq = torch.empty((T,), dtype=torch.float32, device=dev)
    lnorm = torch.empty((T,), dtype=torch.float32, device=dev)
    for s in range(T):
        j = j_seq[s].long()
        counts[rows, j] += 1.0
        rho = counts * float(inv_t[s])
        if slot_values is None:
            o_now, h_now, w_now = o[rows, j], h[rows, j], w[rows, j]
            task = torch.ones_like(j, dtype=torch.bool)
        else:
            o_now, h_now, w_now = (sv[s] for sv in slot_values)
            task = j > 0
        off[s] = (lam * o_now + mu * h_now < w_now) & (w_now > 0) & task
        price = lam[:, None] * o + mu * h
        ry = torch.where((price < w) & (w > 0), rho, 0.0)
        a_t = float(a_seq[s])
        lam = torch.clamp_min(lam + a_t * (row_sum(o * ry) - B), 0.0)
        load = row_sum(h * ry).double().sum().float()
        mu = torch.clamp_min(mu + a_t * (load - H), 0.0)
        mu_seq[s] = mu
        lnorm[s] = torch.sqrt((lam * lam).double().sum().float() + mu * mu)
    return off, mu_seq, lnorm, lam, mu, counts


def _rollout_args(j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab, B, H, a,
                  beta, t0, slot_values):
    """Validate a rollout's operands and allocate its outputs; returns
    (device, T, N, args(partials) -> the ctypes arguments before the
    trailing launch arguments, results tuple).  Outputs: off, mu_seq, lnorm; lam0 /
    counts0 are updated in place and mu is a fresh (1,) buffer."""
    dev = _cuda_device(j_seq, "j_seq")
    T, N = j_seq.shape
    M = counts0.shape[-1]
    _check(j_seq, "j_seq", torch.int32, (T, N), dev)
    if j_seq.numel():  # the kernels index the tables with j
        lo, hi = torch.stack(torch.aminmax(j_seq)).tolist()
        if lo < 0 or hi >= M:
            raise ValueError(f"j_seq holds state indices in [{lo}, {hi}], "
                             f"outside [0, {M})")
    _check(lam0, "lam0", torch.float32, (N,), dev)
    _check(counts0, "counts0", torch.float32, (N, M), dev)
    _check(B, "B", torch.float32, (N,), dev)
    o, os_ = _table(o_tab, "o_tab", N, M, dev)
    h, hs = _table(h_tab, "h_tab", N, M, dev)
    w, ws = _table(w_tab, "w_tab", N, M, dev)
    if slot_values is None:
        sv = (None, None, None)
    else:
        sv = tuple(_check(x, f"slot_values[{i}]", torch.float32, (T, N), dev)
                   for i, x in enumerate(slot_values))
    mu = _scalar(mu0, dev)
    H_t = _scalar(H, dev)
    a_np, inv_np = step_tables(a, beta, t0, T)
    a_seq = torch.from_numpy(a_np).to(dev)
    inv_t = torch.from_numpy(inv_np).to(dev)
    off = torch.empty((T, N), dtype=torch.bool, device=dev)
    mu_seq = torch.empty((T,), dtype=torch.float32, device=dev)
    lnorm = torch.empty((T,), dtype=torch.float32, device=dev)

    # Temporaries freed after the (asynchronous) launch are safe: the
    # caching allocator reuses a block only for later work on this stream.
    def args(partials):
        return [_ptr(j_seq), *(_ptr(x) for x in sv), _ptr(o), os_, _ptr(h),
                hs, _ptr(w), ws, _ptr(B), _ptr(H_t), _ptr(a_seq),
                _ptr(inv_t), _ptr(lam0), _ptr(mu), _ptr(counts0), _ptr(off),
                _ptr(mu_seq), _ptr(lnorm), _ptr(partials), T, N, M]

    return dev, T, N, args, (off, mu_seq, lnorm, lam0, mu, counts0)


def _max_blocks(dev) -> int:
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in _MAX_BLOCKS:
        out = _I(0)
        with torch.cuda.device(key):
            _raise_on(_lib().onalgo_chunked_max_blocks(ctypes.byref(out)),
                      "onalgo_chunked occupancy query")
        _MAX_BLOCKS[key] = out.value
    return _MAX_BLOCKS[key]


def onalgo_chunked_cuda(j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab, B,
                        H, a, beta, *, t0=0, slot_values=None):
    """K1 on the card: the whole T-slot rollout in one cooperative launch
    (grid at most the co-resident block count; one grid sync per slot).

    Same contract and results as ``onalgo_chunked_plain``, except that
    ``lam0`` and ``counts0`` are updated IN PLACE and returned as the
    final lam / counts: the caller hands over state it no longer holds.
    """
    dev, T, N, args, out = _rollout_args(
        j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab, B, H, a, beta, t0,
        slot_values)
    if T == 0:
        return (*out[:4], out[4].reshape(()), out[5])
    warps = _lib().onalgo_threads_per_block() // _WARP
    grid = max(1, min(_max_blocks(dev), -(-N // warps)))
    partials = torch.empty((2, grid, 2), dtype=torch.float64, device=dev)
    err = _lib().onalgo_chunked_launch(*args(partials), grid, _stream(dev))
    _raise_on(err, "onalgo_chunked cooperative launch")
    onalgo_chunked_cuda.launches += 1
    return (*out[:4], out[4].reshape(()), out[5])


onalgo_chunked_cuda.launches = 0


def onalgo_tiled_cuda(j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab, B, H,
                      a, beta, *, block_n=256, t0=0, slot_values=None):
    """K2 on the card: per slot, a tile pass over ceil(N / block_n) blocks
    (rho update, decision, lam step, float64 tile partials of load and
    lam^2) and a one-warp pass reducing the partials in tile order into
    mu, mu_seq and lnorm.  No co-residency needed, so any N runs.

    Same contract as ``onalgo_chunked_cuda`` (``lam0`` / ``counts0``
    updated in place); one wrapper call enqueues 2 T kernels and counts
    as one launch."""
    if block_n < 1:
        raise ValueError(f"block_n={block_n} must be >= 1")
    dev, T, N, args, out = _rollout_args(
        j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab, B, H, a, beta, t0,
        slot_values)
    if T == 0:
        return (*out[:4], out[4].reshape(()), out[5])
    partials = torch.empty((-(-N // block_n), 2), dtype=torch.float64,
                           device=dev)
    err = _lib().onalgo_tiled_launch(*args(partials), block_n, _stream(dev))
    _raise_on(err, "onalgo_tiled launch")
    onalgo_tiled_cuda.launches += 1
    return (*out[:4], out[4].reshape(()), out[5])


onalgo_tiled_cuda.launches = 0


# name -> wrapper, for the launch counts
KERNELS = {"onalgo_chunked": onalgo_chunked_cuda,
           "onalgo_tiled": onalgo_tiled_cuda,
           "onalgo_duals": onalgo_duals_cuda}
