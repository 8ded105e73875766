"""Counter-based random streams, bit-exact to the JAX package's draws.

Port of ``repro/workload/streams.py``.  The value feeding process channel
``c`` at slot ``t`` for device ``n`` of stream ``sid`` is a pure function
of ``(seed, sid, c, t, n)``: stream ``sid`` owns the threefry key
``fold_in(PRNGKey(seed), sid)``, each block of ``ROW_BLOCK`` slots owns
``fold_in(stream_key, t // ROW_BLOCK)``, and ``(t % ROW_BLOCK, c, n)``
indexes the block's counters.

The generator is threefry-2x32 written on int64 tensors masked to 32 bits
(torch's uint32 has few CUDA ops).  ``uniform`` reproduces
``jax.random.uniform`` with jax's partitionable counter layout: element
``i`` of the flattened shape takes ``(x0, x1) = threefry2x32(key, (i >>
32, i & 0xFFFFFFFF))`` and maps ``x0 ^ x1`` to [0, 1) by putting its top
23 bits into a float32 mantissa.  Keys are plain ``(k0, k1)`` Python
ints; the same threefry code runs on ints (keys) and tensors (draws).
"""

from __future__ import annotations

from typing import Optional

import torch

# --- RNG contract versions -------------------------------------------------
RNG_LEGACY_HOST = 0  # v0: host-order numpy draws (golden fixture only)
RNG_COUNTER = 1  # v1: counter-based streams (this module)

# --- stream ids (one per independent random process) -----------------------
STREAM_SERVICE = 1
STREAM_ARRIVAL_INIT = 2
STREAM_SCENARIO = 3
STREAM_TOPOLOGY = 4

# Slots per block key (a v1 contract constant).
ROW_BLOCK = 64

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of counter words (x0, x1) under key (k0,
    k1).  Works on Python ints and on int64 tensors holding 32-bit words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int):
    """``jax.random.PRNGKey(seed)`` as a (k0, k1) pair."""
    seed = int(seed)
    return ((seed >> 32) & _M32, seed & _M32)


def fold_in(key, data: int):
    """``jax.random.fold_in(key, data)``."""
    data = int(data)
    return threefry2x32(key[0], key[1], (data >> 32) & _M32, data & _M32)


def uniform_from_counts(key, counts: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform``'s float32 draws restricted to the given
    64-bit counters (an int64 tensor of any shape): element i of a
    flattened shape takes ``threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))``
    in jax's partitionable layout, so any sub-rectangle of counters equals
    the same elements of the full draw."""
    x0, x1 = threefry2x32(key[0], key[1], counts >> 32, counts & _M32)
    bits = ((x0 ^ x1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def uniform(key, shape, *, device) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32 in [0, 1))."""
    n = 1
    for d in shape:
        n *= int(d)
    i = torch.arange(n, dtype=torch.int64, device=device)
    return uniform_from_counts(key, i).reshape(tuple(shape))


def stream_key(seed, sid: int):
    """The threefry key owning stream ``sid`` of workload ``seed``."""
    return fold_in(prng_key(seed), sid)


def _block_keys(seed, sid: int, n_blocks: int, b0: int = 0):
    """Keys of blocks [b0, b0 + n_blocks): block b is ``fold_in(stream_key,
    b)``, independent of the horizon."""
    skey = stream_key(seed, sid)
    return [fold_in(skey, b0 + b) for b in range(n_blocks)]


def uniform_block_range(seed, sid: int, b0: int, n_blocks: int, N: int,
                        channels: int, n0: Optional[int] = None,
                        n_cols: Optional[int] = None, *,
                        device) -> torch.Tensor:
    """(channels, n_blocks * ROW_BLOCK, n_cols or N) U[0, 1) slab covering
    blocks [b0, b0 + n_blocks) of stream ``sid``.  Drawn block by block,
    so temporaries stay O(ROW_BLOCK * channels * N) whatever the horizon.

    With ``n0`` / ``n_cols`` only device columns [n0, n0 + n_cols) are
    drawn, each addressed by its ABSOLUTE flat counter ``(r * channels +
    c) * N + n0 + dn`` split into (hi, lo) words as ``uniform`` splits
    them, so the result equals slicing the full-width draw (past 2^32
    counters too) from O(rows * n_cols) work."""
    if (n0 is None) != (n_cols is None):
        raise ValueError("n0 and n_cols must be passed together")
    width = N if n_cols is None else n_cols
    if n_cols is not None:
        r = torch.arange(ROW_BLOCK, dtype=torch.int64, device=device)
        c = torch.arange(channels, dtype=torch.int64, device=device)
        dn = torch.arange(n_cols, dtype=torch.int64, device=device)
        counts = ((r[:, None, None] * channels + c[None, :, None]) * N
                  + n0 + dn[None, None, :])
    out = torch.empty((channels, n_blocks * ROW_BLOCK, width),
                      dtype=torch.float32, device=device)
    for b, key in enumerate(_block_keys(seed, sid, n_blocks, b0)):
        vals = (uniform(key, (ROW_BLOCK, channels, N), device=device)
                if n_cols is None else uniform_from_counts(key, counts))
        out[:, b * ROW_BLOCK:(b + 1) * ROW_BLOCK] = vals.permute(1, 0, 2)
    return out


def uniform_block(seed, sid: int, T: int, N: int, channels: int, *,
                  device) -> torch.Tensor:
    """(channels, T, N) U[0, 1) grid addressed by (seed, sid, c, t, n)."""
    n_blocks = -(-T // ROW_BLOCK)
    return uniform_block_range(seed, sid, 0, n_blocks, N, channels,
                               device=device)[:, :T]


def levels_from_uniform(u: torch.Tensor, num_levels: int) -> torch.Tensor:
    """floor(u * L) as int32, clamped at L - 1 (float32 rounding)."""
    idx = torch.floor(u * num_levels).to(torch.int32)
    return torch.clamp(idx, max=num_levels - 1)


def markov_chain(u: torch.Tensor, s0: torch.Tensor, p_on, p_stay
                 ) -> torch.Tensor:
    """(T, N) bool two-state Markov chain from per-slot uniforms ``u``.

    OFF -> ON w.p. ``p_on``; ON stays ON w.p. ``p_stay``; ``s0`` (N,) is
    the state entering slot 0's transition.  The reference evaluates the
    same chain as an associative scan over per-slot maps; boolean maps
    compose exactly, so the slot loop here gives identical states."""
    go_on = u < p_on
    stay_on = u < p_stay
    out = torch.empty(u.shape, dtype=torch.bool, device=u.device)
    s = s0
    for t in range(u.shape[0]):
        s = torch.where(s, stay_on[t], go_on[t])
        out[t] = s
    return out


def hold_resample_from(change: torch.Tensor, candidates: torch.Tensor,
                       entry: torch.Tensor) -> torch.Tensor:
    """(T, N) piecewise-constant process resuming from ``entry`` (N,): at
    each ``change`` slot the value jumps to that slot's candidate, else it
    holds."""
    out = torch.empty_like(candidates)
    v = entry
    for t in range(change.shape[0]):
        v = torch.where(change[t], candidates[t], v)
        out[t] = v
    return out
