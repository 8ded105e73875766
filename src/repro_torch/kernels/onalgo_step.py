"""OnAlgo hot-loop kernels for Hopper, each beside its plain PyTorch version.

Port of ``repro/kernels/onalgo_step.py`` (Pallas, TPU) and of the
oracles in ``repro/kernels/ref.py``:

  onalgo_duals_cuda    (K3) <- onalgo_duals_pallas;   plain: onalgo_duals_plain
  onalgo_chunked_cuda  (K1) <- onalgo_chunked_pallas; plain: onalgo_chunked_plain
  onalgo_tiled_cuda    (K2) <- onalgo_tiled_pallas;   plain: onalgo_chunked_plain
  onalgo_chunked_topo_cuda (K1-topo) <- onalgo_chunked_pallas, assoc / H_k
  onalgo_tiled_topo_cuda   (K2-topo) <- onalgo_tiled_pallas, assoc / H_k
                           plain (both): onalgo_chunked_plain(assoc=, H_k=)
  onalgo_chunked_cells_cuda, onalgo_tiled_cells_cuda (K1 / K2 with a cell
      axis: a sweep grid in one call) <- jax.vmap of K1 / K2 in the
      reference's chunked sweep;   plain: onalgo_cells_plain

The TPU kernels' two topology layouts (``topo_binned``: a one-hot
(N, K_pad) mask, or the binned (hi, lo) pair of products) map to the one
pair of topology kernels here: a direct gather of ``mu[assoc[n]]`` and a
per-cloudlet reduction of float64 partials in a fixed order.

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

The topology forms sum each cloudlet's load in float64 in another fixed
order than the plain version's (device order), so their duals agree
with it to the last float32 rounding of a float64 sum, in practice bit
for bit.

Each wrapper counts its launches in a plain int attribute
(``onalgo_chunked_cuda.launches`` ...), so a run can show it went through
the kernel.  A walk that calls a rollout once per slab hands every call
one :class:`RolloutRun`, which makes the wrappers' host-side checks and
uploads once per walk instead of once per call.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import build

_WARP = 32
_SOURCE = "onalgo_step"
_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ROLLOUT_ARGS = ([_VP] * 4 + [_VP, _LL] * 3 + [_VP] * 11 + [_I] * 3 + [_VP])
_TOPO_ARGS = [_VP, _LL] + [_VP] * 5 + [_I]
DUALS_ROWS = 128  # the most devices a block of K3 takes (csrc kDualsRows)
_DUALS_COUNTERS = 128  # K3's done counters a device, one a stream
_DUALS_SLOTS: dict = {}  # device index -> {stream handle: counter pointer}
_MAX_BLOCKS: dict = {}  # (device, K or None) -> co-resident blocks
_RES_WARPS = (4, 2, 1)  # warps a resident block, the largest that fits
COUNT_LIMIT = 65535  # the resident route keeps visit counts as uint16
STAMPS = 8  # columns of a ``stamps`` tensor: (T, STAMPS) int64
# The intervals between a kernel's per-slot stamps, by (route, topology).
SLOT_SPLIT = {
    ("streaming", False): ("device phase + block partial", "grid.sync wait",
                           "mu step"),
    ("streaming", True): ("device phase", "serial K-row",
                          "block sums + K-row write", "sync 1 wait",
                          "cloudlets", "sync 2 wait"),
    ("resident", False): ("device phase", "block partial", "grid.sync wait",
                          "mu step"),
    ("resident", True): ("device phase + K-row", "block sums + K-row write",
                         "sync 1 wait", "cloudlets", "sync 2 wait"),
    ("cells", False): ("device phase + partials (group 0)",
                       "slot sync wait", "mu step + hand-off"),
    ("tiled", False): ("mu step of the slot before", "device phase",
                       "tile partials", "other blocks + launch boundary"),
    ("tiled", True): ("device phase", "K-rows + lam^2 partials",
                      "other blocks + launch boundary 1", "cloudlets",
                      "other blocks + lnorm", "launch boundary 2"),
}
TILED_THREADS = 256  # the widest block of K2 / K2-topo


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


def _check_ranges(j_seq=None, M: int = 0, assoc=None, K: int = 0):
    """Raise unless j_seq's state indices lie in [0, M) and assoc's
    cloudlet ids in [0, K) (either may be None); reads the ranges back."""
    for what, name, bound, x in (("j_seq", "state indices", M, j_seq),
                                 ("assoc", "cloudlet ids", K, assoc)):
        if x is None or not x.numel():
            continue
        lo, hi = torch.stack(torch.aminmax(x)).tolist()
        if lo < 0 or hi >= bound:
            raise ValueError(f"{what} holds {name} in [{lo}, {hi}], outside "
                             f"[0, {bound})")


class RolloutRun:
    """The rollout wrappers' per-call host work, done once per run.

    A streaming walk calls a rollout once per slab.  Without a run, each
    call reads back max(counts0) and the ranges of j (and of assoc) and
    uploads its step tables: a host synchronization per slab, which would
    serialize a walk meant to enqueue slab t + 1 while slab t runs.  A run
    made at the walk's start (``start`` the first slot's t0, ``end`` one
    past the last slot) keeps every check and makes each once:

      * counts: max(counts0) is read once (``_counts_max``, one
        synchronize); a call at slot t0 takes max + (t0 - start) as its
        bound, since a slot adds one visit per device, so the uint16
        layouts are chosen only where the counts stay exact;
      * step tables: uploaded once for [start, end), sliced per call;
      * ranges of j and assoc: the kernels hold every value they read to
        its range and set a bit of the run's device flag ``bad`` for one
        outside it (csrc ``in_range``), so nothing is read back per call
        and no access leaves its table; ``finish`` reads the flag at the
        run's end and raises.  The plain version checks its CPU tensors
        at once (there is nothing to wait for).

    Pass it as ``run=`` to every rollout call of the walk (wrappers and
    plain version alike), then call ``finish``."""

    def __init__(self, counts0: torch.Tensor, a, beta, start: int, end: int):
        self.start, self.end = int(start), int(end)
        self.a, self.beta = float(a), float(beta)
        self._max0 = _counts_max(counts0)
        a_np, inv_np = step_tables(a, beta, start, end - start)
        dev = counts0.device
        self._a_seq = torch.from_numpy(a_np).to(dev)
        self._inv_t = torch.from_numpy(inv_np).to(dev)
        self.bad = torch.zeros((1,), dtype=torch.int32, device=dev)
        self._bounds = {}  # flag bit -> (what, name, bound) to report

    def counts_max(self, t0: int):
        """Bound on max(counts) entering slot t0 + 1 (None: not
        non-negative integers)."""
        return None if self._max0 is None else self._max0 + (t0 - self.start)

    def steps(self, a, beta, t0: int, T: int):
        """(a_seq, inv_t) device slices for slots t0 + 1 .. t0 + T."""
        if (float(a), float(beta)) != (self.a, self.beta):
            raise ValueError(f"rollout step rule ({a}, {beta}) differs from "
                             f"the run's ({self.a}, {self.beta})")
        i = t0 - self.start
        if i < 0 or t0 + T > self.end:
            raise ValueError(f"slots [{t0}, {t0 + T}) outside the run's "
                             f"[{self.start}, {self.end})")
        return self._a_seq[i:i + T], self._inv_t[i:i + T]

    def note(self, j_seq=None, M: int = 0, assoc=None, K: int = 0):
        """A kernel call reads j_seq (state indices in [0, M)) and / or
        assoc (cloudlet ids in [0, K)): the kernel flags them in ``bad``,
        and ``finish`` reports them with these bounds."""
        if j_seq is not None:
            self._bounds[1] = ("j_seq", "state indices", M)
        if assoc is not None:
            self._bounds[2] = ("assoc", "cloudlet ids", K)

    def finish(self):
        """Read the kernels' range flag (one synchronize) and raise if a
        call of the run read a j or an assoc outside its range."""
        if not self._bounds:
            return
        bad = int(self.bad.item())
        for bit, (what, name, bound) in sorted(self._bounds.items()):
            if bad & bit:
                raise ValueError(f"{what} holds {name} outside [0, {bound})")


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
        [_VP] * 4 + [_LL, _VP, _LL, _VP, _LL] + [_VP] * 5 + [_I] * 4
        + [_VP])
    lib.onalgo_duals_launch.restype = _I
    lib.onalgo_chunked_max_blocks.argtypes = [ctypes.POINTER(_I)]
    lib.onalgo_chunked_max_blocks.restype = _I
    lib.onalgo_chunked_launch.argtypes = _ROLLOUT_ARGS + [_VP, _I, _VP]
    lib.onalgo_chunked_launch.restype = _I
    lib.onalgo_tiled_launch.argtypes = (
        _ROLLOUT_ARGS + [_VP, _LL, _VP, _VP, _VP, _VP, _I]
        + [_VP] + [_I] * 6 + [_VP, _VP, _VP, _I, _LL, _LL, _VP])
    lib.onalgo_tiled_launch.restype = _I
    lib.onalgo_tiled_smem.argtypes = [_I] * 6
    lib.onalgo_tiled_smem.restype = _LL
    lib.onalgo_resident_launch.argtypes = (
        _ROLLOUT_ARGS + [_VP, _LL, _VP, _VP, _VP, _VP, _I]
        + [_VP, _I, _I, _I, _VP])
    lib.onalgo_resident_launch.restype = _I
    lib.onalgo_resident_smem.argtypes = [_I] * 5
    lib.onalgo_resident_smem.restype = _LL
    lib.onalgo_cells_launch.argtypes = (
        [_VP, _VP, _LL, _LL, _VP, _LL] + [_VP] * 12 + [_I] * 3 + [_VP]
        + [_I] * 7 + [_VP, _VP])
    lib.onalgo_cells_launch.restype = _I
    lib.onalgo_cells_smem.argtypes = [_I] * 7
    lib.onalgo_cells_smem.restype = _LL
    lib.onalgo_device_limits.argtypes = [ctypes.POINTER(_I)] * 2
    lib.onalgo_device_limits.restype = _I
    lib.onalgo_topo_max_k.argtypes = [ctypes.POINTER(_I)]
    lib.onalgo_topo_max_k.restype = _I
    lib.onalgo_chunked_topo_max_blocks.argtypes = [_I, ctypes.POINTER(_I)]
    lib.onalgo_chunked_topo_max_blocks.restype = _I
    lib.onalgo_chunked_topo_launch.argtypes = (_ROLLOUT_ARGS + _TOPO_ARGS
                                                + [_VP, _I, _VP])
    lib.onalgo_chunked_topo_launch.restype = _I
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


def duals_smem(rows: int, M: int, cols: int, o_per_device: bool) -> int:
    """Bytes of shared memory a K3 block of ``rows`` devices takes with its
    rows in chunks of ``cols`` columns (csrc ``duals_layout``): the
    mbarrier; the rho rows, and the o rows when o is per device, whole with
    16 bytes of slack (cols == M) or a chunk in rows of cols | 1 floats;
    a chunk of each shared (M,) table; every part rounded up to 16."""
    r16 = lambda nbytes: -(-nbytes // 16) * 16
    tile = r16(rows * M * 4 + 16 if cols == M else rows * (cols | 1) * 4)
    chunk = r16(cols * 4)
    return 16 + tile + (tile if o_per_device else chunk) + 2 * chunk


@functools.lru_cache(maxsize=None)
def duals_plan(M: int, o_per_device: bool, smem_optin: int):
    """K3's (devices a block, columns a chunk): whole rows (cols == M) for
    the most devices, a multiple of 32 up to ``DUALS_ROWS``, whose rows fit
    ``smem_optin``; where 32 whole rows do not fit (M above 880 with
    o per device, 1660 with shared tables), 32 devices and their rows in
    chunks of the widest multiple of 32 columns that fits, so every M
    runs."""
    for rows in range(DUALS_ROWS, 0, -_WARP):
        if duals_smem(rows, M, M, o_per_device) <= smem_optin:
            return rows, M
    per_col = 4 * (2 * _WARP + 2 if o_per_device else _WARP + 3)
    cols = min(M - 1, smem_optin // per_col) // _WARP * _WARP
    while cols and duals_smem(_WARP, M, cols, o_per_device) > smem_optin:
        cols -= _WARP
    if not cols:
        raise ValueError(f"{smem_optin} B of shared memory hold no chunk of "
                         f"32 rows by 32 columns")
    return _WARP, cols


@functools.lru_cache(maxsize=None)
def _duals_counters(index: int) -> torch.Tensor:
    """K3's done counters on CUDA device ``index``, zero from the start."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("onalgo_duals_cuda: call it once on this device "
                           "before capturing a graph that calls it")
    return torch.zeros((_DUALS_COUNTERS,), dtype=torch.int32,
                       device=f"cuda:{index}")


def _duals_done(index: int, stream: int):
    """The done counter of K3's calls on ``stream`` of device ``index``: one
    a stream, so calls on different streams may run at once (calls on one
    stream run in turn, and the kernel's last block sets the counter back
    to zero)."""
    slots = _DUALS_SLOTS.setdefault(index, {})
    if stream not in slots:
        if len(slots) == _DUALS_COUNTERS:
            raise RuntimeError(f"onalgo_duals_cuda: more than "
                               f"{_DUALS_COUNTERS} streams on cuda:{index}")
        slots[stream] = _VP(_duals_counters(index).data_ptr()
                            + 4 * len(slots))
    return slots[stream]


def onalgo_duals_cuda(lam, mu, rho, o_tab, h_tab, w_tab, B):
    """K3 on the card: same contract as ``onalgo_duals_plain``, g_pow bit
    for bit, any N and M.  One launch: each block stages its devices' rows
    (``duals_plan``), writes g_pow and a float64 load partial, and the last
    block to finish sums the partials in a fixed order into ``load`` (so
    two calls give the same bits; load is held to the plain version's at
    rtol 1e-5, which sums in device order).  mu is read where it lies when
    it is a float32 scalar on the card, else copied there first.  Calls on
    different streams may overlap; a captured graph keeps its capture
    stream's counter, so do not replay it alongside a call on that
    stream."""
    dev = _cuda_device(rho, "rho")
    N, M = rho.shape
    _check(rho, "rho", torch.float32, (N, M), dev)
    _check(lam, "lam", torch.float32, (N,), dev)
    _check(B, "B", torch.float32, (N,), dev)
    o, os_ = _table(o_tab, "o_tab", N, M, dev)
    h, hs = _table(h_tab, "h_tab", N, M, dev)
    w, ws = _table(w_tab, "w_tab", N, M, dev)
    if not (isinstance(mu, torch.Tensor) and mu.device == dev
            and mu.dtype == torch.float32 and mu.numel() == 1):
        mu = _scalar(mu, dev)
    g_pow = torch.empty((N,), dtype=torch.float32, device=dev)
    if not N:
        return g_pow, torch.zeros((), dtype=torch.float32, device=dev)
    index = _index(dev)
    rows, cols = duals_plan(M, os_ != 0, _device_limits(index)[1])
    load = torch.empty((), dtype=torch.float32, device=dev)
    part = torch.empty((-(-N // rows),), dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().onalgo_duals_launch(
        _ptr(lam), _ptr(mu), _ptr(rho), _ptr(o), os_, _ptr(h), hs, _ptr(w),
        ws, _ptr(B), _ptr(g_pow), _ptr(part), _duals_done(index, stream),
        _ptr(load), N, M, rows, cols, _VP(stream))
    _raise_on(err, f"onalgo_duals launch (M={M})")
    onalgo_duals_cuda.launches += 1
    return g_pow, load


onalgo_duals_cuda.launches = 0


# --------------------------------------------------------------------------
# K1 / K2: the fused T-slot rollout

def onalgo_chunked_plain(j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab, B,
                         H, a, beta, *, t0=0, slot_values=None, assoc=None,
                         H_k=None, run=None):
    """Plain version of K1 and K2 and of their topology forms (port of
    ``ref.onalgo_chunked_ref``), slot-sequential.

    j_seq (T, N) state indices; lam0 (N,), mu0 (), counts0 (N, M): the
    algorithm state entering slot t0 + 1.  o/h/w tables ((M,) or (N, M)),
    B (N,) and H () are already in the dual space.  ``slot_values``:
    optional (o, h, w) raw (T, N) streams (service overlay, dual space)
    driving the realized decision instead of the table gather, gated on
    j > 0.  ``assoc`` ((N,) static or (T, N), int ids in [0, K)) and
    ``H_k`` (K,) (dual space) run the multi-cloudlet duals: mu0 is then
    (K,), device n is priced by ``mu[assoc[n]]``, each cloudlet's load is
    the float64 sum of its devices' row loads in device order, and ``H``
    is not used.  Returns (offload (T, N) bool, mu_seq (T,) or (T, K),
    lam_norm_seq (T,), lam (N,), mu () or (K,), counts (N, M)); the inputs
    are not modified.  ``run``: a :class:`RolloutRun`; with one, the
    call's ranges are checked at once (the wrappers' contract; without
    it the plain version indexes the tables with j unchecked).
    """
    if (assoc is None) != (H_k is None):
        raise ValueError("assoc and H_k must be passed together")
    topo = assoc is not None
    T, N = j_seq.shape
    M = counts0.shape[-1]
    dev = j_seq.device
    if run is not None:
        _check_ranges(j_seq, M, assoc, 0 if H_k is None else H_k.shape[0])
    a_seq, inv_t = step_tables(a, beta, t0, T)
    o, h, w = (t.float().expand(N, M) for t in (o_tab, h_tab, w_tab))
    B = torch.as_tensor(B, dtype=torch.float32, device=dev).expand(N)
    H = torch.as_tensor(H, dtype=torch.float32, device=dev)
    lam = lam0.float().clone()
    mu = torch.as_tensor(mu0, dtype=torch.float32, device=dev).clone()
    counts = counts0.float().clone()
    rows = torch.arange(N, device=dev)
    off = torch.empty((T, N), dtype=torch.bool, device=dev)
    mu_seq = torch.empty((T, *mu.shape), dtype=torch.float32, device=dev)
    lnorm = torch.empty((T,), dtype=torch.float32, device=dev)
    if topo:
        H_k = torch.as_tensor(H_k, dtype=torch.float32, device=dev)
        K = H_k.shape[0]
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
        if topo:
            a_now = (assoc[s] if assoc.ndim == 2 else assoc).long()
            mu_n = mu[a_now]
            mu_col = mu_n[:, None]
        else:
            mu_n = mu_col = mu
        off[s] = (lam * o_now + mu_n * h_now < w_now) & (w_now > 0) & task
        price = lam[:, None] * o + mu_col * h
        ry = torch.where((price < w) & (w > 0), rho, 0.0)
        a_t = float(a_seq[s])
        lam = torch.clamp_min(lam + a_t * (row_sum(o * ry) - B), 0.0)
        lam2 = (lam * lam).double().sum().float()
        if topo:
            load = torch.zeros((K,), dtype=torch.float64, device=dev
                               ).index_add_(0, a_now,
                                            row_sum(h * ry).double())
            mu = torch.clamp_min(mu + a_t * (load.float() - H_k), 0.0)
            lnorm[s] = torch.sqrt(lam2 + (mu * mu).double().sum().float())
        else:
            load = row_sum(h * ry).double().sum().float()
            mu = torch.clamp_min(mu + a_t * (load - H), 0.0)
            lnorm[s] = torch.sqrt(lam2 + mu * mu)
        mu_seq[s] = mu
    return off, mu_seq, lnorm, lam, mu, counts


def _rollout_args(j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab, B, H, a,
                  beta, t0, slot_values, K=None, run=None):
    """Validate a rollout's operands and allocate its outputs; returns
    (device, T, N, args(partials) -> the ctypes arguments before the
    trailing launch arguments, results tuple).  Outputs: off, mu_seq,
    lnorm; lam0 / counts0 are updated in place and mu is a fresh (1,)
    buffer, or with ``K`` (topology) a fresh (K,) copy of mu0 and mu_seq
    (T, K).  With a ``run`` (:class:`RolloutRun`) the kernel flags a j
    out of range in the run's ``bad`` (read at the run's end) and the
    step tables are the run's; without one j is checked here."""
    dev = _cuda_device(j_seq, "j_seq")
    T, N = j_seq.shape
    M = counts0.shape[-1]
    _check(j_seq, "j_seq", torch.int32, (T, N), dev)
    if run is not None:
        run.note(j_seq, M)
        bad = run.bad
    else:  # the kernels index the tables with j
        _check_ranges(j_seq, M)
        bad = _unset_flag(_index(dev))
    _check(lam0, "lam0", torch.float32, (N,), dev)
    _check(counts0, "counts0", torch.float32, (N, M), dev)
    _check(B, "B", torch.float32, (N,), dev)
    o, os_ = _table(o_tab, "o_tab", N, M, dev)
    if o.data_ptr() % 16:  # the resident route copies o in 16-byte units
        o = o.clone()
    h, hs = _table(h_tab, "h_tab", N, M, dev)
    w, ws = _table(w_tab, "w_tab", N, M, dev)
    if slot_values is None:
        sv = (None, None, None)
    else:
        sv = tuple(_check(x, f"slot_values[{i}]", torch.float32, (T, N), dev)
                   for i, x in enumerate(slot_values))
    if K is None:
        mu = _scalar(mu0, dev)
    else:
        mu = _check(mu0, "mu0", torch.float32, (K,), dev).clone()
    H_t = _scalar(H, dev)
    if run is not None:
        a_seq, inv_t = run.steps(a, beta, t0, T)
    else:
        a_np, inv_np = step_tables(a, beta, t0, T)
        a_seq = torch.from_numpy(a_np).to(dev)
        inv_t = torch.from_numpy(inv_np).to(dev)
    off = torch.empty((T, N), dtype=torch.bool, device=dev)
    mu_seq = torch.empty((T,) if K is None else (T, K), dtype=torch.float32,
                         device=dev)
    lnorm = torch.empty((T,), dtype=torch.float32, device=dev)

    # Temporaries freed after the (asynchronous) launch are safe: the
    # caching allocator reuses a block only for later work on this stream.
    def args(partials):
        return [_ptr(j_seq), *(_ptr(x) for x in sv), _ptr(o), os_, _ptr(h),
                hs, _ptr(w), ws, _ptr(B), _ptr(H_t), _ptr(a_seq),
                _ptr(inv_t), _ptr(lam0), _ptr(mu), _ptr(counts0), _ptr(off),
                _ptr(mu_seq), _ptr(lnorm), _ptr(partials), T, N, M,
                _ptr(bad)]

    return dev, T, N, args, (off, mu_seq, lnorm, lam0, mu, counts0)


def _index(dev) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


@functools.lru_cache(maxsize=None)
def _unset_flag(index: int) -> torch.Tensor:
    """The range flag of calls without a run, which check their ranges
    before the launch: the kernels never set it."""
    return torch.zeros((1,), dtype=torch.int32, device=torch.device(
        "cuda", index))


def _max_blocks(dev, K=None) -> int:
    """Co-resident blocks of K1 (``K`` None) or of K1-topo for K
    cloudlets, on ``dev``."""
    index = _index(dev)
    if (index, K) not in _MAX_BLOCKS:
        out = _I(0)
        with torch.cuda.device(index):
            if K is None:
                err = _lib().onalgo_chunked_max_blocks(ctypes.byref(out))
            else:
                err = _lib().onalgo_chunked_topo_max_blocks(
                    K, ctypes.byref(out))
            _raise_on(err, "onalgo_chunked occupancy query")
        _MAX_BLOCKS[index, K] = out.value
    return _MAX_BLOCKS[index, K]


@dataclasses.dataclass(frozen=True)
class ChunkedPlan:
    """How K1 / K1-topo run a call: ``route`` "resident" (each block's
    device state in shared memory for all T slots) or "streaming" (the
    rows re-read from device memory every slot); ``grid`` cooperative
    blocks of ``warps`` warps; resident: ``per`` devices a block and
    ``smem`` bytes of dynamic shared memory; ``why`` the reason."""
    route: str
    grid: int
    warps: int
    per: int
    smem: int
    why: str


def resident_smem(per: int, M: int, K: int, warps: int,
                  o_per_device: bool) -> int:
    """Dynamic shared memory of a resident block (``res_layout`` in
    csrc/onalgo_step.cu): mbarriers; uint16 counts in rows of Mp >= M
    (Mp = 2 mod 4); lam and B; the (M,) h, w and o tables; two o tiles of
    32 * warps rows when o is (N, M); with K cloudlets the float64 K-row
    and two sets of per-warp group sums; the reduction scratch.  Each
    region is rounded up to 16 bytes."""
    r16 = lambda n: -(-n // 16) * 16
    Mp = M + (6 - M % 4) % 4
    Mq = -(-M // 4) * 4
    lists = 2 * warps * _WARP if K else 0
    return (16 + r16(per * Mp * 2) + 2 * r16(per * 4) + r16(3 * Mq * 4)
            + (r16(2 * warps * _WARP * M * 4) if o_per_device else 0)
            + r16(K * 8) + r16(lists * 4) + r16(lists * 8)
            + r16(warps * 16 + 16))


def _streaming_plan(N: int, stream_blocks: int, stream_warps: int,
                    why: str) -> ChunkedPlan:
    """The streaming route: one warp per device in turn, on at most
    ``stream_blocks`` blocks of ``stream_warps`` warps."""
    grid = max(1, min(stream_blocks, -(-N // stream_warps)))
    return ChunkedPlan("streaming", grid, stream_warps, 0, 0, why)


def chunked_plan(N: int, M: int, T: int, counts_max, K: int,
                 smem_optin: int, sms: int, stream_blocks: int,
                 stream_warps: int, *, o_per_device: bool = True,
                 hw_per_device: bool = False) -> ChunkedPlan:
    """Choose K1's (``K`` = 0) or K1-topo's route for a call by size alone.

    Resident when the visit counts fit uint16 (``counts_max``, the largest
    of counts0, or None when counts0 is not non-negative integers: max +
    T <= 65535), the h and w tables are (M,), and a block of ``per`` =
    ceil(N / sms) devices (rounded up to 32) fits ``smem_optin`` bytes of
    shared memory with 4, 2 or 1 warps; one block per SM (``sms`` blocks
    at most).  Otherwise streaming, on at most ``stream_blocks`` (the
    streaming kernel's co-resident count) blocks of ``stream_warps``
    warps (the library's block width)."""
    def streaming(why):
        return _streaming_plan(N, stream_blocks, stream_warps, why)

    if N == 0:
        return streaming("no devices")
    if counts_max is None:
        return streaming("counts0 is not non-negative integers")
    if counts_max + T > COUNT_LIMIT:
        return streaming(f"max(counts0) + T = {counts_max + T} > "
                         f"{COUNT_LIMIT}")
    if hw_per_device:
        return streaming("h or w is a per-device (N, M) table")
    per = -(-N // sms)
    per = -(-per // _WARP) * _WARP
    for warps in _RES_WARPS:
        smem = resident_smem(per, M, K, warps, o_per_device)
        if smem <= smem_optin:
            return ChunkedPlan("resident", -(-N // per), warps, per, smem,
                               f"{smem} B of shared memory a block")
    return streaming(f"{resident_smem(per, M, K, 1, o_per_device)} B of "
                     f"shared memory a block > {smem_optin}")


def _counts_max(counts0):
    """The largest visit count, or None unless counts0 holds non-negative
    integers."""
    if not counts0.numel():
        return 0
    lo, hi, frac = torch.stack([counts0.min(), counts0.max(),
                                torch.frac(counts0).abs().max()]).tolist()
    if not (lo >= 0 and frac == 0 and math.isfinite(hi)):
        return None
    return int(hi)


@functools.lru_cache(maxsize=None)
def _device_limits(index: int):
    """(SM count, opt-in shared memory per block) of CUDA device ``index``."""
    sms, optin = _I(0), _I(0)
    with torch.cuda.device(index):
        _raise_on(_lib().onalgo_device_limits(ctypes.byref(sms),
                                              ctypes.byref(optin)),
                  "device attribute query")
    return sms.value, optin.value


def _call_counts_max(counts0, t0, run):
    """max(counts0) of a call: the run's bound, else read from counts0."""
    return _counts_max(counts0) if run is None else run.counts_max(t0)


def _plan_for(dev, T, N, M, K, counts_max, o_tab, h_tab, w_tab, streaming):
    """The plan of a call on ``dev``; ``streaming`` (a test hook) takes the
    streaming route whatever the sizes."""
    blocks = _max_blocks(dev, K or None)
    warps = _lib().onalgo_threads_per_block() // _WARP
    if streaming:
        return _streaming_plan(N, blocks, warps, "forced")
    sms, optin = _device_limits(_index(dev))
    return chunked_plan(N, M, T, counts_max, K, optin, sms,
                        blocks, warps, o_per_device=o_tab.ndim == 2,
                        hw_per_device=h_tab.ndim == 2 or w_tab.ndim == 2)


def _check_stamps(stamps, T, dev):
    if stamps is not None:
        _check(stamps, "stamps", torch.int64, (T, STAMPS), dev)


def _resident(args, plan, topo, stamps, dev):
    """Launch the resident kernel; ``topo`` the ctypes topology arguments
    (assoc, slot stride, H_k, kpart, lam2p, mu2p, K) or None."""
    topo = topo or (_ptr(None), 0, _ptr(None), _ptr(None), _ptr(None),
                    _ptr(None), 0)
    return _lib().onalgo_resident_launch(
        *args, *topo, _ptr(stamps), plan.per, plan.warps, plan.grid,
        _stream(dev))


def onalgo_chunked_cuda(j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab, B,
                        H, a, beta, *, t0=0, slot_values=None, stamps=None,
                        run=None, _streaming=False):
    """K1 on the card: the whole T-slot rollout in one cooperative launch
    (one grid sync per slot), on the route ``chunked_plan`` picks by size:
    "resident" keeps each block's counts, lam and tables in shared memory
    for all T slots; "streaming" re-reads them from device memory every
    slot.  The route and plan taken are left on
    ``onalgo_chunked_cuda.route`` / ``.plan``.

    Same contract and results as ``onalgo_chunked_plain``, except that
    ``lam0`` and ``counts0`` are updated IN PLACE and returned as the
    final lam / counts: the caller hands over state it no longer holds.
    ``stamps``: an optional (T, STAMPS) int64 CUDA tensor into which block
    0 writes per-slot timestamps (ns; ``SLOT_SPLIT`` names the intervals).
    ``run``: the walk's :class:`RolloutRun` (counts bound, step tables,
    range flag), so the call reads nothing back.
    """
    dev, T, N, args, out = _rollout_args(
        j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab, B, H, a, beta, t0,
        slot_values, run=run)
    if T == 0:
        return (*out[:4], out[4].reshape(()), out[5])
    _check_stamps(stamps, T, dev)
    plan = _plan_for(dev, T, N, counts0.shape[-1], 0,
                     _call_counts_max(counts0, t0, run), o_tab, h_tab,
                     w_tab, _streaming)
    partials = torch.empty((2, plan.grid, 2), dtype=torch.float64,
                           device=dev)
    if plan.route == "resident":
        err = _resident(args(partials), plan, None, stamps, dev)
    else:
        err = _lib().onalgo_chunked_launch(*args(partials), _ptr(stamps),
                                           plan.grid, _stream(dev))
    _raise_on(err, f"onalgo_chunked cooperative launch ({plan.route})")
    onalgo_chunked_cuda.launches += 1
    onalgo_chunked_cuda.route, onalgo_chunked_cuda.plan = plan.route, plan
    return (*out[:4], out[4].reshape(()), out[5])


onalgo_chunked_cuda.launches = 0
onalgo_chunked_cuda.route = onalgo_chunked_cuda.plan = None


@dataclasses.dataclass(frozen=True)
class TiledPlan:
    """How K2 / K2-topo run a call: the visit counts kept for the call as
    ``counts`` ("uint16" or "float32") in rows of ``stride`` entries;
    blocks of ``threads`` threads (one per device) walking units of
    ``unit_tiles`` tiles of block_n devices, each taken in ``passes``
    passes; ``grid`` blocks a slot, one an SM; ``smem`` bytes of dynamic
    shared memory a block; ``why`` the count route's reason."""
    counts: str
    stride: int
    threads: int
    unit_tiles: int
    passes: int
    grid: int
    smem: int
    why: str


def tiled_smem(threads: int, M: int, stride: int, esize: int,
               o_per_device: bool, cells: int = 1) -> int:
    """Dynamic shared memory of a tiled block (``tiled_layout`` in
    csrc/onalgo_step.cu): four mbarriers; two stages of ``threads`` rows
    of o when o is (N, M), at least 48 bytes a thread (the reduction
    scratch that reuses them); two stages of as many count rows of
    ``stride`` entries of ``esize`` bytes; 16 bytes of lead in each stage;
    the (h, w') pairs (a row a cell) and, when o is (M,), o; the
    reduction scratch; with a cell axis, the ``cells``' mu.  Each region
    is rounded up to 16 bytes."""
    r16 = lambda n: -(-n // 16) * 16
    Mq = -(-M // 4) * 4
    o_rows = threads * M * 4 if o_per_device else 0
    return (32 + 2 * r16(max(o_rows, 48 * threads) + 16)
            + 2 * r16(threads * stride * esize + 16) + Mq * 8 * cells
            + (0 if o_per_device else Mq * 4) + 16 * threads
            + (r16(4 * cells) if cells > 1 else 0))


def tiled_plan(N: int, M: int, T: int, counts_max, block_n: int,
               o_per_device: bool, sms: int, smem_optin: int,
               cells: int = 1) -> TiledPlan:
    """K2's / K2-topo's layout for a call, from its sizes and values alone.

    Counts: uint16 in rows of Mp = M + (6 - M mod 4) mod 4 entries (the
    resident layout) when they stay exact (``counts_max``, the largest of
    counts0 or None when counts0 is not non-negative integers: max + T <=
    65535), else float32 in rows of M | 1; either way 32 rows fall in 32
    banks.  Blocks: the widest multiple of 32 threads up to 256 whose two
    ring stages fit ``smem_optin``.  A unit is floor(threads / block_n)
    tiles (the threads rounded up to 32), or one tile taken in passes
    when block_n is wider.  Grid: a block per SM (``sms``; the kernel
    takes up to 255 registers a thread), at most one per unit (of all
    ``cells``: the sweeps' cell axis)."""
    if counts_max is not None and counts_max + T <= COUNT_LIMIT:
        counts, esize, stride = "uint16", 2, M + (6 - M % 4) % 4
        why = f"max(counts0) + T = {counts_max + T} <= {COUNT_LIMIT}"
    else:
        counts, esize, stride = "float32", 4, M | 1
        why = ("counts0 is not non-negative integers" if counts_max is None
               else f"max(counts0) + T = {counts_max + T} > {COUNT_LIMIT}")
    for width in range(TILED_THREADS, 0, -_WARP):
        if block_n <= width:
            tpb = width // block_n
            threads = -(-tpb * block_n // _WARP) * _WARP
        else:
            tpb, threads = 1, width
        smem = tiled_smem(threads, M, stride, esize, o_per_device, cells)
        if smem <= smem_optin:
            n_units = -(-(-(-N // block_n)) // tpb)  # ceil(n_tiles / tpb)
            return TiledPlan(counts, stride, threads, tpb,
                             -(-min(N, tpb * block_n) // threads),
                             max(1, min(cells * n_units, sms)), smem, why)
    raise ValueError(
        f"M={M}: a block of 32 devices needs "
        f"{tiled_smem(_WARP, M, stride, esize, o_per_device)} B of shared "
        f"memory, more than the card's {smem_optin}")


def _tiled(args, dev, T, N, M, block_n, counts_max, o_tab, topo, stamps,
           wrapper):
    """Plan and enqueue a K2 / K2-topo call: ``args`` the rollout's ctypes
    arguments, ``counts_max`` the bound on max(counts0), ``topo`` the
    topology's (assoc, slot stride, H_k, kpart, lam2p, mu2p, K) or None.
    Leaves the plan on ``wrapper.plan``."""
    _check_stamps(stamps, T, dev)
    index = _index(dev)
    plan = tiled_plan(N, M, T, counts_max, block_n,
                      o_tab.ndim == 2, *_device_limits(index))
    scratch = torch.empty((N * plan.stride,), device=dev, dtype=(
        torch.int16 if plan.counts == "uint16" else torch.float32))
    mus = torch.empty((2,), dtype=torch.float32, device=dev)
    ticket = torch.zeros((2,), dtype=torch.int32, device=dev)
    topo = topo or (_ptr(None), 0, _ptr(None), _ptr(None), _ptr(None),
                    _ptr(None), 0)
    err = _lib().onalgo_tiled_launch(
        *args, *topo, _ptr(scratch), int(plan.counts == "uint16"),
        plan.stride, block_n, plan.unit_tiles, plan.threads, plan.grid,
        _ptr(mus), _ptr(ticket), _ptr(stamps), 1, 0, 0, _stream(dev))
    _raise_on(err, f"{wrapper.__name__} launch")
    wrapper.launches += 1
    wrapper.plan = plan


def onalgo_tiled_cuda(j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab, B, H,
                      a, beta, *, block_n=256, t0=0, slot_values=None,
                      stamps=None, run=None):
    """K2 on the card: the rollout tiled over N in tiles of ``block_n``
    devices, one launch a slot and no co-residency, so any N runs.  A
    launch has one block per SM walk units of tiles through a two-stage
    ring of TMA copies (one thread a device), keeps the visit counts for
    the call as uint16 or float32 (``tiled_plan``; the plan is left on
    ``onalgo_tiled_cuda.plan``) and writes a float64 (load, lam^2)
    partial per tile; every block of the next launch reduces them in tile
    order into that slot's mu (block 0 writing mu_seq and lnorm), and the
    last slot's last block into the final mu.  Slots after the first are
    programmatic dependent launches.

    Same contract as ``onalgo_chunked_cuda`` (``lam0`` / ``counts0``
    updated in place, ``stamps`` (T, STAMPS) int64 for block 0's per-slot
    timestamps, ``SLOT_SPLIT["tiled", False]`` naming the intervals,
    ``run`` as there); one wrapper call enqueues T kernels and counts as
    one launch."""
    if block_n < 1:
        raise ValueError(f"block_n={block_n} must be >= 1")
    dev, T, N, args, out = _rollout_args(
        j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab, B, H, a, beta, t0,
        slot_values, run=run)
    if T == 0:
        return (*out[:4], out[4].reshape(()), out[5])
    partials = torch.empty((2, -(-N // block_n), 2), dtype=torch.float64,
                           device=dev)
    _tiled(args(partials), dev, T, N, counts0.shape[-1], block_n,
           _call_counts_max(counts0, t0, run), o_tab, None, stamps,
           onalgo_tiled_cuda)
    return (*out[:4], out[4].reshape(()), out[5])


onalgo_tiled_cuda.launches = 0
onalgo_tiled_cuda.plan = None


def _topo_args(assoc, H_k, T, N, dev, run=None):
    """Validate a topology's operands for the kernels: ``assoc`` int32 (N,)
    static or (T, N) row-major (read one slot row at a time), ids in
    [0, K) (flagged by the kernel into the ``run``'s ``bad`` when one
    is given, else checked here); ``H_k`` float32 (K,) with K at most
    what a block's shared memory holds.
    Returns (assoc, slot stride, H_k, K)."""
    _cuda_device(assoc, "assoc")
    if H_k.ndim != 1 or H_k.shape[0] < 1:
        raise ValueError(f"H_k must have shape (K,) with K >= 1, got "
                         f"{tuple(H_k.shape)}")
    K = H_k.shape[0]
    _check(H_k, "H_k", torch.float32, (K,), dev)
    k_max = _topo_max_k(_index(dev))
    if K > k_max:
        raise ValueError(f"K={K} cloudlets: the topology kernels hold a "
                         f"dense row of K doubles per block, at most "
                         f"K={k_max} on this card")
    shape = (N,) if assoc.ndim == 1 else (T, N)
    _check(assoc, "assoc", torch.int32, shape, dev)
    if run is not None:
        run.note(assoc=assoc, K=K)
    else:
        _check_ranges(assoc=assoc, K=K)
    return assoc, (0 if assoc.ndim == 1 else N), H_k, K


@functools.lru_cache(maxsize=None)
def _topo_max_k(index: int) -> int:
    """Largest K the topology kernels take on CUDA device ``index``."""
    out = _I(0)
    with torch.cuda.device(index):
        _raise_on(_lib().onalgo_topo_max_k(ctypes.byref(out)),
                  "topology kernels' shared memory query")
    return out.value


def _topo_operands(j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab, B, H, a,
                   beta, t0, slot_values, assoc, H_k, run=None):
    """Validate a topology rollout's operands (``_topo_args``,
    ``_rollout_args``); returns (dev, T, N, K, the ctypes (assoc, slot
    stride, H_k), args, out)."""
    if assoc is None or H_k is None:
        raise ValueError("assoc and H_k must be passed together")
    dev = _cuda_device(j_seq, "j_seq")
    T, N = j_seq.shape
    assoc, a_ts, H_k, K = _topo_args(assoc, H_k, T, N, dev, run)
    dev, T, N, args, out = _rollout_args(
        j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab, B, H, a, beta, t0,
        slot_values, K=K, run=run)
    return dev, T, N, K, (_ptr(assoc), a_ts, _ptr(H_k)), args, out


def onalgo_chunked_topo_cuda(j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab,
                             B, H, a, beta, *, t0=0, slot_values=None,
                             assoc=None, H_k=None, stamps=None, run=None,
                             _streaming=False):
    """K1-topo on the card: the K-cloudlet rollout in one cooperative launch
    (two grid syncs per slot: per-cloudlet partials, then the published
    mu), on the route ``chunked_plan`` picks (see ``onalgo_chunked_cuda``;
    the resident route also keeps the block's K-row of float64 cloudlet
    loads in shared memory).  Same contract and results as
    ``onalgo_chunked_plain(assoc=, H_k=)`` (``H`` unused), with ``lam0`` /
    ``counts0`` updated in place; mu0 (K,) is copied; ``run`` as in
    ``onalgo_chunked_cuda``.  Raises unless ``assoc`` and ``H_k`` are
    given."""
    dev, T, N, K, topo, args, out = _topo_operands(
        j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab, B, H, a, beta, t0,
        slot_values, assoc, H_k, run)
    if T == 0 or N == 0:
        return out
    _check_stamps(stamps, T, dev)
    plan = _plan_for(dev, T, N, counts0.shape[-1], K,
                     _call_counts_max(counts0, t0, run), o_tab, h_tab,
                     w_tab, _streaming)
    G = plan.grid
    f64 = dict(dtype=torch.float64, device=dev)
    kpart = torch.empty((G, K), **f64)
    lam2p, mu2p = torch.empty((2 * G,), **f64), torch.empty((2 * G,), **f64)
    if plan.route == "resident":
        err = _resident(args(None), plan, (
            *topo, _ptr(kpart), _ptr(lam2p), _ptr(mu2p), K), stamps, dev)
    else:
        rowload = torch.empty((N,), dtype=torch.float32, device=dev)
        err = _lib().onalgo_chunked_topo_launch(
            *args(None), *topo, _ptr(rowload), _ptr(kpart), _ptr(lam2p),
            _ptr(mu2p), K, _ptr(stamps), G, _stream(dev))
    _raise_on(err, f"onalgo_chunked_topo cooperative launch ({plan.route})")
    onalgo_chunked_topo_cuda.launches += 1
    onalgo_chunked_topo_cuda.route = plan.route
    onalgo_chunked_topo_cuda.plan = plan
    return out


onalgo_chunked_topo_cuda.launches = 0
onalgo_chunked_topo_cuda.route = onalgo_chunked_topo_cuda.plan = None


def onalgo_tiled_topo_cuda(j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab,
                           B, H, a, beta, *, block_n=256, t0=0,
                           slot_values=None, assoc=None, H_k=None,
                           stamps=None, run=None):
    """K2-topo on the card: per slot the device launch of
    ``onalgo_tiled_cuda`` (each tile adding its devices' row loads into
    its dense float64 row of K cloudlet loads in a fixed order, and its
    lam^2 partial) and a cloudlet launch (one block per 32 cloudlets: the
    loads over the tile rows, the mu_k ascent, mu_seq; its last block
    forms lnorm).  Any N runs.  Same contract as
    ``onalgo_chunked_topo_cuda``; ``stamps``, ``run`` and the plan
    (``onalgo_tiled_topo_cuda.plan``) as in ``onalgo_tiled_cuda``
    (``SLOT_SPLIT["tiled", True]``); one wrapper call enqueues 2 T
    kernels and counts as one launch."""
    if block_n < 1:
        raise ValueError(f"block_n={block_n} must be >= 1")
    dev, T, N, K, topo, args, out = _topo_operands(
        j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab, B, H, a, beta, t0,
        slot_values, assoc, H_k, run)
    if T == 0 or N == 0:
        return out
    n_tiles = -(-N // block_n)
    f64 = dict(dtype=torch.float64, device=dev)
    kpart = torch.empty((n_tiles, K), **f64)
    lam2p = torch.empty((n_tiles,), **f64)
    mu2p = torch.empty((-(-K // _WARP),), **f64)
    _tiled(args(None), dev, T, N, counts0.shape[-1], block_n,
           _call_counts_max(counts0, t0, run), o_tab,
           (*topo, _ptr(kpart), _ptr(lam2p), _ptr(mu2p), K), stamps,
           onalgo_tiled_topo_cuda)
    return out


onalgo_tiled_topo_cuda.launches = 0
onalgo_tiled_topo_cuda.plan = None


# --------------------------------------------------------------------------
# K1 / K2 with a cell axis: G cells of one grid (the chunked sweep), each
# with its own step rule, budgets, duals and visit counts, over one trace

def _cell_of(x, g):
    """Cell g's table of a cell-axis table (3-D: per cell; else shared)."""
    return x[g] if x.ndim == 3 else x


def onalgo_cells_plain(j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab, B, H,
                       a, beta, *, t0=0):
    """Plain version of the cell-axis K1 and K2: ``onalgo_chunked_plain``
    per cell, stacked.

    j_seq (T, N) shared by the G cells; lam0 (G, N), mu0 (G,), counts0
    (G, N, M); each table shared ((M,) or (N, M)) or per cell ((G, 1, M) or
    (G, N, M)), in the dual space; B (G, N), H (G,); a, beta: G step-rule
    values.  Returns (offload (G, T, N) bool, mu_seq (G, T), lam_norm_seq
    (G, T), lam (G, N), mu (G,), counts (G, N, M)); the inputs are not
    modified."""
    G = lam0.shape[0]
    outs = [onalgo_chunked_plain(
        j_seq, lam0[g], mu0[g], counts0[g], _cell_of(o_tab, g),
        _cell_of(h_tab, g), _cell_of(w_tab, g), B[g], H[g], a[g], beta[g],
        t0=t0) for g in range(G)]
    return tuple(torch.stack(x) for x in zip(*outs))


def cells_smem(per: int, M: int, width: int, lane_groups: int, stages: int,
               V: int, o_per_device: bool) -> int:
    """Dynamic shared memory of a cell-axis K1 block (``cells_layout`` in
    csrc/onalgo_step.cu): the groups' mbarriers (o per device); for each of
    V virtual blocks of ``per`` devices uint16 counts in rows of Mp, lam, B
    and the cell's (h, w') pairs; o when it is shared, else ``stages`` o
    tiles of ``width`` rows for each of ``lane_groups`` groups; the groups'
    reduction scratch; the V virtual blocks' partials; the cells' mu.  Each
    region is rounded up to 16 bytes."""
    r16 = lambda n: -(-n // 16) * 16
    Mp = M + (6 - M % 4) % 4
    Mq = -(-M // 4) * 4
    ring = lane_groups * stages
    return ((r16(8 * ring) if o_per_device else 0) + r16(V * per * Mp * 2)
            + 2 * r16(V * per * 4) + r16(V * Mq * 8)
            + (0 if o_per_device else Mq * 4)
            + (r16(ring * width * M * 4) if o_per_device else 0)
            + r16(lane_groups * width // _WARP * 16) + r16(V * 16)
            + r16(V * 4))


CELLS_MAX_THREADS = 512  # the widest cell-axis block (csrc kCellsMaxThreads)
CELLS_MAX_GROUPS = 15  # lane groups a block: named barriers 1..15
# A launch's per-slot grid sync and mu step, in passes of a lane group
# (0.6 of one at 9c (ii) on an H100): the plan weighs fewer launches
# against fewer passes a slot by it.
CELLS_SLOT_PASSES = 1


@dataclasses.dataclass(frozen=True)
class CellsPlan:
    """How the cell-axis K1 runs a grid: ``route`` "cells" (the cell-axis
    kernel: each cell cut into ``single``'s blocks, ``V`` of them a
    physical block, one cooperative launch of ``grid`` blocks and
    ``smem`` bytes a group) or "per-cell" (one launch a cell on K1's own
    route, ``single``); ``groups`` the (first cell, cells) of each launch;
    ``group_width`` threads a lane group (min(single.per, the single call's
    block)), ``lane_groups`` groups a block side by side, ``stages`` o'
    tiles staged a group, ``passes`` tiles a group walks in turn a slot;
    ``why`` the reason."""
    route: str
    groups: tuple
    V: int
    grid: int
    smem: int
    single: ChunkedPlan
    why: str
    group_width: int = 0
    lane_groups: int = 1
    stages: int = 0
    passes: int = 0


def _cells_lanes(V: int, per: int, width: int, M: int, smem_optin: int,
                o_per_device: bool = True):
    """(lane groups, stages) of a cell-axis block of V virtual blocks: the
    most groups of ``width`` threads (at most V, CELLS_MAX_GROUPS and
    CELLS_MAX_THREADS threads) whose one o' stage each fits
    ``smem_optin``, then the most stages up to a group's tiles a slot
    (with that many, its tiles stay loaded); None when not even one group
    fits."""
    tiles = -(-per // width)
    fits = lambda P, S: cells_smem(per, M, width, P, S, V,
                                   o_per_device) <= smem_optin
    for P in range(min(V, CELLS_MAX_GROUPS, CELLS_MAX_THREADS // width),
                   0, -1):
        if fits(P, 1):
            items = -(-V // P) * tiles
            S = 1
            while S < items and fits(P, S + 1):
                S += 1
            return P, S
    return None


def cells_plan(G: int, N: int, M: int, T: int, counts_max, smem_optin: int,
               sms: int, stream_blocks: int, stream_warps: int, *,
               o_per_device: bool = True,
               hw_per_device: bool = False) -> CellsPlan:
    """Plan a G-cell grid for the cell-axis K1, by size alone.

    Every cell is cut as a single-cell call of its N is (``chunked_plan``,
    so each cell's sums run in that call's order), and its devices map to
    the threads of a lane group of that call's width.  Where that call is
    resident, the cells go to the cell-axis kernel in L launches of about
    G / L cells, each of V = ceil(cells Gc / sms) virtual blocks a block
    (one block an SM) walked by ``_cells_lanes``'s lane groups in
    ceil(V / groups) passes a slot; L is the count with the least
    L * (passes + CELLS_SLOT_PASSES), the fewest launches on a tie.  Where
    the single call is not resident (counts past uint16, per-device h or
    w, a block too large), each cell is one launch on K1's own route."""
    single = chunked_plan(N, M, T, counts_max, 0, smem_optin, sms,
                          stream_blocks, stream_warps,
                          o_per_device=o_per_device,
                          hw_per_device=hw_per_device)
    per_cell = tuple((g, 1) for g in range(G))
    if single.route != "resident":
        return CellsPlan("per-cell", per_cell, 1, single.grid, single.smem,
                         single, f"one cell a launch on K1's own route: "
                         f"{single.why}")
    Gc, per = single.grid, single.per
    width = min(per, _WARP * single.warps)
    tiles = -(-per // width)
    best = None
    for gs in sorted({-(-G // L) for L in range(1, G + 1)}, reverse=True):
        V = -(-gs * Gc // sms)
        lanes = _cells_lanes(V, per, width, M, smem_optin, o_per_device)
        if lanes is None:
            continue
        launches = -(-G // gs)
        passes = -(-V // lanes[0]) * tiles
        cost = launches * (passes + CELLS_SLOT_PASSES)
        if best is None or cost < best[0]:
            best = (cost, gs, V, lanes, passes)
    if best is None:
        return CellsPlan("per-cell", per_cell, 1, single.grid, single.smem,
                         single, f"one cell a launch on K1's own route: "
                         f"a cell's {Gc} blocks do not fit the cell layout")
    _, gs, V, (P, S), passes = best
    groups = tuple((g0, min(gs, G - g0)) for g0 in range(0, G, gs))
    smem = cells_smem(per, M, width, P, S, V, o_per_device)
    return CellsPlan(
        "cells", groups, V, -(-gs * Gc // V), smem, single,
        f"{len(groups)} launch(es) of up to {gs} cells: {Gc} blocks of "
        f"{per} devices a cell, {V} a block in {P} lane group(s) of "
        f"{width} threads, {passes} pass(es) a slot, {S} o' stage(s) a "
        f"group, {smem} B of shared memory", width, P, S, passes)


def _cells_operands(j_seq, lam0, mu0, counts0, B, H, a, beta, t0):
    """Validate a cell-axis rollout's state and scalars; returns (dev, G,
    T, N, M, a_seq (G, T), inv_t (T,), mu (G,) copy, outputs off, mu_seq,
    lnorm)."""
    dev = _cuda_device(j_seq, "j_seq")
    T, N = j_seq.shape
    G, M = counts0.shape[0], counts0.shape[-1]
    _check(j_seq, "j_seq", torch.int32, (T, N), dev)
    _check(lam0, "lam0", torch.float32, (G, N), dev)
    _check(counts0, "counts0", torch.float32, (G, N, M), dev)
    _check(B, "B", torch.float32, (G, N), dev)
    _check(H, "H", torch.float32, (G,), dev)
    mu = _check(mu0, "mu0", torch.float32, (G,), dev).clone()
    if len(a) != G or len(beta) != G:
        raise ValueError(f"a and beta must hold G={G} values")
    _check_ranges(j_seq, M)
    steps = [step_tables(a[g], beta[g], t0, T) for g in range(G)]
    a_seq = torch.from_numpy(np.stack([x for x, _ in steps])).to(dev)
    inv_t = torch.from_numpy(step_tables(1.0, 0.0, t0, T)[1]).to(dev)
    off = torch.empty((G, T, N), dtype=torch.bool, device=dev)
    mu_seq = torch.empty((G, T), dtype=torch.float32, device=dev)
    lnorm = torch.empty((G, T), dtype=torch.float32, device=dev)
    return dev, G, T, N, M, a_seq, inv_t, mu, off, mu_seq, lnorm


def _cells_table(x, name, G, N, M, dev, per_device=False):
    """A cell-axis table on the card: (M,) or (N, M) shared, or (G, 1, M) /
    (G, N, M) per cell; ``per_device``: a (G, 1, M) table of a one-device
    fleet is its (N, M) rows (o), else one shared row (h).  Returns
    (tensor, row stride, cell stride)."""
    if x.ndim == 3:
        rows = x.shape[1]
        if rows not in (1, N):
            raise ValueError(f"{name} must have shape ({G}, 1, {M}) or "
                             f"({G}, {N}, {M}), got {tuple(x.shape)}")
        _check(x, name, torch.float32, (G, rows, M), dev)
        by_row = rows == N and (N > 1 or per_device)
        return x, (M if by_row else 0), rows * M
    return (*_table(x, name, N, M, dev), 0)


def _cell_args(j_seq, lam0, mu, counts0, o, h, h_cs, w, B, H, a, beta, g, M):
    """Cell g's operands for a single-cell call."""
    return (j_seq, lam0[g], mu[g], counts0[g], _cell_of(o, g),
            _cell_of(h, g).reshape(M) if h_cs == M else _cell_of(h, g),
            _cell_of(w, g), B[g], H[g], a[g], beta[g])


def onalgo_chunked_cells_cuda(j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab,
                              B, H, a, beta, *, t0=0, stamps=None):
    """The cell-axis K1 on the card: a G-cell grid in one cooperative
    launch (or the plan's groups of cells, each one launch; ``cells_plan``,
    the plan taken left on ``onalgo_chunked_cells_cuda.plan``).  Same
    contract as ``onalgo_cells_plain`` and, cell for cell, the results of
    G ``onalgo_chunked_cuda`` calls bit for bit; ``lam0`` and ``counts0``
    are updated in place.  Each launch of the cell-axis kernel counts one;
    where the plan takes one cell a launch on K1's own route, each cell is
    an ``onalgo_chunked_cuda`` call and counts there.  ``stamps``: as
    ``onalgo_chunked_cuda``'s, written by block 0's first lane group of
    each launch (``SLOT_SPLIT["cells", False]``; the per-cell route writes
    none)."""
    dev, G, T, N, M, a_seq, inv_t, mu, off, mu_seq, lnorm = _cells_operands(
        j_seq, lam0, mu0, counts0, B, H, a, beta, t0)
    _check_stamps(stamps, T, dev)
    o, os_, o_cs = _cells_table(o_tab, "o_tab", G, N, M, dev, True)
    h, hs, h_cs = _cells_table(h_tab, "h_tab", G, N, M, dev)
    w, ws, w_cs = _cells_table(w_tab, "w_tab", G, N, M, dev)
    out = (off, mu_seq, lnorm, lam0, mu, counts0)
    if T == 0 or G == 0:
        return out
    index = _index(dev)
    sms, optin = _device_limits(index)
    plan = cells_plan(G, N, M, T, _counts_max(counts0), optin, sms,
                      _max_blocks(dev), _lib().onalgo_threads_per_block()
                      // _WARP, o_per_device=os_ != 0,
                      hw_per_device=hs != 0 or ws != 0 or w_cs != 0)
    onalgo_chunked_cells_cuda.plan = plan
    if plan.route == "per-cell":
        for g in range(G):
            res = onalgo_chunked_cuda(*_cell_args(
                j_seq, lam0, mu, counts0, o, h, h_cs, w, B, H, a, beta, g,
                M), t0=t0)
            off[g], mu_seq[g], lnorm[g], mu[g] = res[0], res[1], res[2], \
                res[4]
    else:
        if os_ and o_cs and (o_cs % 4 or o.data_ptr() % 16):
            # the bulk copies need each cell's o rows 16-byte aligned
            o_cs = -(-o_cs // 4) * 4
            packed = torch.empty((G, o_cs), dtype=torch.float32, device=dev)
            packed[:, :N * M] = o.reshape(G, -1)
            o = packed
        elif os_ and o.data_ptr() % 16:
            o = o.clone()
        single = plan.single
        bad = _unset_flag(index)
        for g0, gs in plan.groups:
            part = torch.empty((2, gs * single.grid, 2), dtype=torch.float64,
                               device=dev)
            err = _lib().onalgo_cells_launch(
                _ptr(j_seq), _VP(o.data_ptr() + 4 * g0 * o_cs), os_, o_cs,
                _VP(h.data_ptr() + 4 * g0 * h_cs), h_cs, _ptr(w),
                _ptr(B[g0]), _ptr(H[g0:]), _ptr(a_seq[g0]), _ptr(inv_t),
                _ptr(lam0[g0]), _ptr(mu[g0:]), _ptr(counts0[g0]),
                _ptr(off[g0]), _ptr(mu_seq[g0]), _ptr(lnorm[g0]),
                _ptr(part), T, N, M, _ptr(bad), gs, single.grid, plan.V,
                single.per, plan.group_width, plan.lane_groups, plan.stages,
                _ptr(stamps), _stream(dev))
            _raise_on(err, f"onalgo_cells cooperative launch (cells "
                      f"{g0}..{g0 + gs - 1})")
            onalgo_chunked_cells_cuda.launches += 1
    return out


onalgo_chunked_cells_cuda.launches = 0
onalgo_chunked_cells_cuda.plan = None


def onalgo_tiled_cells_cuda(j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab,
                            B, H, a, beta, *, block_n=256, t0=0):
    """The cell-axis K2 on the card: the G cells' tiles walked by the
    blocks of one launch a slot (units run over (cell, tile)), each cell's
    mu reduced from its own tiles by the next slot's blocks, any N; one
    call counts one.  With per-device (N, M) h or w tables each cell is an
    ``onalgo_tiled_cuda`` call, counted there (the plan's ``why`` says
    so).  Same contract as ``onalgo_cells_plain`` and, cell for cell, the
    results of G ``onalgo_tiled_cuda`` calls bit for bit; ``lam0`` and
    ``counts0`` are updated in place; the plan is left on
    ``onalgo_tiled_cells_cuda.plan``."""
    if block_n < 1:
        raise ValueError(f"block_n={block_n} must be >= 1")
    dev, G, T, N, M, a_seq, inv_t, mu, off, mu_seq, lnorm = _cells_operands(
        j_seq, lam0, mu0, counts0, B, H, a, beta, t0)
    o, os_, o_cs = _cells_table(o_tab, "o_tab", G, N, M, dev, True)
    h, hs, h_cs = _cells_table(h_tab, "h_tab", G, N, M, dev)
    w, ws, w_cs = _cells_table(w_tab, "w_tab", G, N, M, dev)
    out = (off, mu_seq, lnorm, lam0, mu, counts0)
    if T == 0 or G == 0 or N == 0:
        return out
    if hs or ws or w_cs:  # the (N, M) h / w kernels take no cell axis
        for g in range(G):
            res = onalgo_tiled_cuda(*_cell_args(
                j_seq, lam0, mu, counts0, o, h, h_cs, w, B, H, a, beta, g,
                M), block_n=block_n, t0=t0)
            off[g], mu_seq[g], lnorm[g], mu[g] = res[0], res[1], res[2], \
                res[4]
        onalgo_tiled_cells_cuda.plan = dataclasses.replace(
            onalgo_tiled_cuda.plan,
            why=f"one cell a launch (h or w per device); "
                f"{onalgo_tiled_cuda.plan.why}")
        return out
    index = _index(dev)
    plan = tiled_plan(N, M, T, _counts_max(counts0), block_n, os_ != 0,
                      *_device_limits(index), cells=G)
    n_tiles = -(-N // block_n)
    scratch = torch.empty((G * N * plan.stride,), device=dev, dtype=(
        torch.int16 if plan.counts == "uint16" else torch.float32))
    mus = torch.empty((2 * G,), dtype=torch.float32, device=dev)
    ticket = torch.zeros((2,), dtype=torch.int32, device=dev)
    part = torch.empty((2, G, n_tiles, 2), dtype=torch.float64, device=dev)
    H_t = H.contiguous()
    err = _lib().onalgo_tiled_launch(
        _ptr(j_seq), _ptr(None), _ptr(None), _ptr(None), _ptr(o), os_,
        _ptr(h), hs, _ptr(w), ws, _ptr(B), _ptr(H_t), _ptr(a_seq),
        _ptr(inv_t), _ptr(lam0), _ptr(mu), _ptr(counts0), _ptr(off),
        _ptr(mu_seq), _ptr(lnorm), _ptr(part), T, N, M,
        _ptr(_unset_flag(index)), _ptr(None), 0, _ptr(None), _ptr(None),
        _ptr(None), _ptr(None), 0, _ptr(scratch),
        int(plan.counts == "uint16"), plan.stride, block_n, plan.unit_tiles,
        plan.threads, plan.grid, _ptr(mus), _ptr(ticket), _ptr(None), G,
        o_cs, h_cs, _stream(dev))
    _raise_on(err, "onalgo_tiled_cells launch")
    onalgo_tiled_cells_cuda.launches += 1
    onalgo_tiled_cells_cuda.plan = plan
    return out


onalgo_tiled_cells_cuda.launches = 0
onalgo_tiled_cells_cuda.plan = None


# name -> wrapper, for the launch counts
KERNELS = {"onalgo_chunked": onalgo_chunked_cuda,
           "onalgo_tiled": onalgo_tiled_cuda,
           "onalgo_chunked_cells": onalgo_chunked_cells_cuda,
           "onalgo_tiled_cells": onalgo_tiled_cells_cuda,
           "onalgo_chunked_topo": onalgo_chunked_topo_cuda,
           "onalgo_tiled_topo": onalgo_tiled_topo_cuda,
           "onalgo_duals": onalgo_duals_cuda}
