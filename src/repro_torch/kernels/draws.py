"""The workload draws for Hopper, beside their plain PyTorch version.

A hand-written kernel with no TPU counterpart: in the reference, XLA
fuses this work inside the jitted lowering
(``repro/workload/service.py:63``, ``repro/serve/compile.py:100``,
``repro/workload/streaming.py:157``).  It is written by hand because no
PyTorch call computes jax's threefry (``torch.rand`` is Philox):

  draws_cuda   (the draws kernel) <- none (XLA-fused); plain: draws_plain

One function draws a window of a counter-addressed process: the service
workload (``ServiceProcess``: arrival chain, image ids, held channel
rate) or the mobility walk (``WalkProcess``: the held association), over
the covering blocks [b0, b0 + nb) of ``ROW_BLOCK`` slots, resumed from
the state entering block b0, in one of two forms:

  * slab: rows [off, off + length) of the window, (length, n_cols);
  * boundary: the state ENTERING each block, (nb, n_cols), nothing of
    size (T, N) (the streaming lowerings' pass over the horizon).

``n0`` / ``n_cols`` take device columns [n0, n0 + n_cols) addressed by
their absolute counters, equal to the same columns of the full-width
draw.  The plain version is the eager code (``workload/streams.py``:
``uniform_block_range``, ``markov_chain``, ``hold_resample_from``); the
kernel (``csrc/draws.cu``, its header note gives the bound) equals it
bit for bit: uniforms, levels, chain states, holds and boundary states.
``draws_cuda.launches`` counts calls, one kernel each.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.workload import streams

_SOURCE = "draws"
_VP, _I, _LL, _U, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_uint, ctypes.c_float)
RB = streams.ROW_BLOCK


@dataclasses.dataclass(frozen=True)
class ServiceProcess:
    """The service workload of ``seed`` over N devices (stream
    STREAM_SERVICE, 4 channels): the ON/OFF chain (p_on, p_stay; started
    from STREAM_ARRIVAL_INIT's u < p_init), image ids in [0, pool_size),
    and the channel rate in [0, num_rates) redrawn w.p. p_change (and at
    slot 0).  Probabilities are float32 values."""

    seed: int
    N: int
    pool_size: int
    num_rates: int
    p_on: float
    p_stay: float
    p_init: float
    p_change: float

    sid = streams.STREAM_SERVICE
    channels = 4


@dataclasses.dataclass(frozen=True)
class WalkProcess:
    """The mobility walk of ``seed`` over N devices and K cloudlets
    (stream STREAM_TOPOLOGY, 2 channels): each slot a device hands over
    w.p. p_handover (a float32 value) to a cloudlet drawn uniformly, and
    starts at n % K."""

    seed: int
    N: int
    K: int
    p_handover: float

    sid = streams.STREAM_TOPOLOGY
    channels = 2


def _window(proc, b0, nb, off, length, n0, n_cols, boundary):
    """Checked (b0, nb, off, length, n0, n_cols) of a call."""
    n_cols = proc.N - n0 if n_cols is None else n_cols
    if not (b0 >= 0 and nb >= 1 and 0 <= n0 and n_cols >= 1
            and n0 + n_cols <= proc.N):
        raise ValueError(f"draws: blocks [{b0}, {b0} + {nb}), columns "
                         f"[{n0}, {n0} + {n_cols}) outside N={proc.N}")
    if boundary:
        return b0, nb, 0, 0, n0, n_cols
    length = nb * RB - off if length is None else length
    if not (off >= 0 and length >= 1 and off + length <= nb * RB):
        raise ValueError(f"draws: rows [{off}, {off} + {length}) outside "
                         f"the {nb} covering blocks")
    return b0, nb, off, length, n0, n_cols


def _device(device) -> torch.device:
    """``device`` with a CUDA index filled in (the current device's)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@functools.lru_cache(maxsize=None)
def _stream_key(seed: int, sid: int):
    return streams.stream_key(seed, sid)


def _entry(proc, entry, b0, n_cols, device):
    """The checked state entering block b0: a tuple of (n_cols,) tensors
    ((on bool, rate int32) / (assoc int32,)), or None for the fresh start
    (block 0 only)."""
    if entry is None:
        if b0 != 0:
            raise ValueError("draws: a start past block 0 needs the state "
                             "entering it")
        return None
    want = ((torch.bool, torch.int32) if isinstance(proc, ServiceProcess)
            else (torch.int32,))
    entry = tuple(entry)
    if len(entry) != len(want):
        raise ValueError(f"draws: entry holds {len(entry)} tensors, "
                         f"expected {len(want)}")
    for x, dt in zip(entry, want):
        if (x.dtype != dt or tuple(x.shape) != (n_cols,)
                or x.device != device or not x.is_contiguous()):
            raise ValueError(f"draws: entry tensors must be contiguous "
                             f"{[str(d) for d in want]} of shape "
                             f"({n_cols},) on {device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    return entry


def draws_plain(proc, b0: int, nb: int, entry=None, *, off: int = 0,
                length: Optional[int] = None, n0: int = 0,
                n_cols: Optional[int] = None, boundary: bool = False,
                device) -> tuple:
    """Plain version of the draws kernel (the eager workload code).

    Slab form: returns (on (L, n) bool, img (L, n) int32, rates (L, n)
    int32) for a ServiceProcess, (assoc (L, n) int32,) for a WalkProcess,
    rows [off, off + length) of blocks [b0, b0 + nb) (length None: to the
    window's end).  Boundary form: (on_entry (nb, n) bool, rate_entry
    (nb, n) int32) / (entry (nb, n) int32,), the state entering each
    block.  ``entry`` is the state entering block b0 (see ``_entry``)."""
    device = _device(device)
    b0, nb, off, length, n0, n_cols = _window(proc, b0, nb, off, length,
                                              n0, n_cols, boundary)
    entry = _entry(proc, entry, b0, n_cols, device)
    service = isinstance(proc, ServiceProcess)
    cols = ({} if (n0, n_cols) == (0, proc.N)
            else dict(n0=n0, n_cols=n_cols))
    if entry is None:
        n = torch.arange(n0, n0 + n_cols, dtype=torch.int64, device=device)
        if service:
            key = streams.stream_key(proc.seed, streams.STREAM_ARRIVAL_INIT)
            entry = (streams.uniform_from_counts(key, n) < proc.p_init,
                     torch.zeros((n_cols,), dtype=torch.int32,
                                 device=device))
        else:
            entry = ((n % proc.K).to(torch.int32),)

    def walk(b, rows, state):
        """The processes over ``rows`` slots of blocks b, b + 1, ...
        resumed from ``state``: (per-slot tensors, the state after)."""
        u = streams.uniform_block_range(proc.seed, proc.sid, b,
                                        -(-rows // RB), proc.N,
                                        proc.channels, device=device,
                                        **cols)[:, :rows]
        if not service:
            assoc = streams.hold_resample_from(
                u[0] < proc.p_handover,
                streams.levels_from_uniform(u[1], proc.K), state[0])
            return (assoc,), (assoc[-1],)
        on = streams.markov_chain(u[0], state[0], proc.p_on, proc.p_stay)
        g_t = b * RB + torch.arange(rows, device=device)
        change = (u[2] < proc.p_change) | (g_t == 0)[:, None]
        rates = streams.hold_resample_from(
            change, streams.levels_from_uniform(u[3], proc.num_rates),
            state[1])
        img = streams.levels_from_uniform(u[1], proc.pool_size)
        return (on, img, rates), (on[-1], rates[-1])

    if not boundary:
        out, _ = walk(b0, off + length, entry)
        return tuple(x[off:] for x in out)
    states = [entry]
    for b in range(b0, b0 + nb - 1):  # block by block: O(RB * n) live
        states.append(walk(b, RB, states[-1])[1])
    return tuple(torch.stack(s) for s in zip(*states))


def _ptr(x):
    return _VP(None if x is None else x.data_ptr())


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel's library (built on first use), with its C signatures."""
    lib = build.load(_SOURCE)
    lib.draws_error_string.argtypes = [_I]
    lib.draws_error_string.restype = ctypes.c_char_p
    lib.draws_launch.argtypes = (
        [_I, _I, _U, _U, _U, _U, _LL, _LL, _I, _LL, _I, _I, _I, _VP, _VP]
        + [_F] * 4 + [_I, _I] + [_VP] * 6)
    lib.draws_launch.restype = _I
    return lib


def draws_cuda(proc, b0: int, nb: int, entry=None, *, off: int = 0,
               length: Optional[int] = None, n0: int = 0,
               n_cols: Optional[int] = None, boundary: bool = False,
               device) -> tuple:
    """The draws kernel on the card: same contract and results as
    ``draws_plain``, bit for bit, in one launch on the current stream.
    The block keys are folded in the kernel from the stream key (Python
    ints here, as ``streams.stream_key`` reckons them), so a call uploads
    nothing and reads nothing back."""
    device = _device(device)
    if device.type != "cuda":
        raise ValueError(f"draws_cuda: device must be CUDA, got {device}")
    b0, nb, off, length, n0, n_cols = _window(proc, b0, nb, off, length,
                                              n0, n_cols, boundary)
    entry = _entry(proc, entry, b0, n_cols, device)
    service = isinstance(proc, ServiceProcess)
    k0, k1 = _stream_key(proc.seed, proc.sid)
    if service:
        ik0, ik1 = _stream_key(proc.seed, streams.STREAM_ARRIVAL_INIT)
        probs = (proc.p_on, proc.p_stay, proc.p_init, proc.p_change)
        levels = (proc.pool_size, proc.num_rates)
        on_in, held_in = (None, None) if entry is None else entry
    else:
        ik0 = ik1 = 0
        probs = (proc.p_handover, 0.0, 0.0, 0.0)
        levels = (proc.K, 0)
        on_in, held_in = None, (None if entry is None else entry[0])
    i32 = dict(dtype=torch.int32, device=device)
    b8 = dict(dtype=torch.bool, device=device)
    on = img = held = on_entry = held_entry = None
    if boundary:
        on_entry = torch.empty((nb, n_cols), **b8) if service else None
        held_entry = torch.empty((nb, n_cols), **i32)
        out = (on_entry, held_entry) if service else (held_entry,)
    else:
        if service:
            on = torch.empty((length, n_cols), **b8)
            img = torch.empty((length, n_cols), **i32)
        held = torch.empty((length, n_cols), **i32)
        out = (on, img, held) if service else (held,)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _lib().draws_launch(
            int(service), int(boundary), k0, k1, ik0, ik1, proc.N, n0,
            n_cols, b0, nb, off, length, _ptr(on_in), _ptr(held_in),
            *probs, *levels, _ptr(on), _ptr(img), _ptr(held),
            _ptr(on_entry), _ptr(held_entry), _VP(stream))
    if err != 0:
        msg = _lib().draws_error_string(err).decode()
        raise RuntimeError(f"draws launch: CUDA error {err} ({msg})")
    draws_cuda.launches += 1
    return out


draws_cuda.launches = 0

# name -> wrapper, for the launch counts
KERNELS = {"draws": draws_cuda}
