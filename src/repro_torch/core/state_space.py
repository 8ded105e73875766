"""Quantized system state space J = O x H x W (paper Sec. II).

Port of ``repro/core/state_space.py``.  Each device's per-slot state is
``j = (o, h, w)``: transmit power (W), cloudlet cycles and quantized gain.
State 0 is the null state (no task): all its values are zero, so it never
offloads and contributes nothing to the constraints.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class StateSpace:
    """Finite per-device state space with flat value tables.

    o_levels / h_levels / w_levels: level values (tuples, hashable);
    include_null: state 0 is the no-task state and real states start at 1.
    """

    o_levels: tuple
    h_levels: tuple
    w_levels: tuple
    include_null: bool = True

    @property
    def num_levels(self) -> tuple:
        return (len(self.o_levels), len(self.h_levels), len(self.w_levels))

    @property
    def M(self) -> int:
        lo, lh, lw = self.num_levels
        return lo * lh * lw + (1 if self.include_null else 0)

    def encode(self, io, ih, iw):
        """Map level indices -> flat state index (null-aware)."""
        lo, lh, lw = self.num_levels
        base = (io * lh + ih) * lw + iw
        return base + (1 if self.include_null else 0)

    def tables(self, device, dtype=torch.float32):
        """Return (o_tab, h_tab, w_tab), each (M,), on ``device``."""
        o = np.asarray(self.o_levels, np.float64)
        h = np.asarray(self.h_levels, np.float64)
        w = np.asarray(self.w_levels, np.float64)
        og, hg, wg = np.meshgrid(o, h, w, indexing="ij")
        tabs = [og.reshape(-1), hg.reshape(-1), wg.reshape(-1)]
        if self.include_null:
            tabs = [np.concatenate([np.zeros(1), t]) for t in tabs]
        return tuple(torch.tensor(t, dtype=dtype, device=device)
                     for t in tabs)


def default_paper_space(num_w: int = 8) -> StateSpace:
    """State space parameterized by the paper's testbed measurements.

    Power: the fitted curve p(r) = -0.00037 r^2 + 0.0214 r + 0.1277 W at
    WiFi rates 10, 25 and 40 Mbps (Fig. 2b).  Cycles: the cloudlet CNN
    task's 441 +/- 90 Mcycles (Fig. 2c) at -1, 0 and +1 sigma.  Gains: a
    uniform grid of ``num_w`` levels over [0, 0.25] (Fig. 3b)."""
    rates = np.array([10.0, 25.0, 40.0])  # Mbps
    p = -0.00037 * rates**2 + 0.0214 * rates + 0.1277  # Watts
    cycles = np.array([441 - 90, 441.0, 441 + 90]) * 1e6  # cycles/task
    gains = np.linspace(0.0, 0.25, num_w)
    return StateSpace(tuple(p.tolist()), tuple(cycles.tolist()),
                      tuple(gains.tolist()))


@dataclasses.dataclass
class RhoEstimator:
    """Streaming empirical state distribution rho_t (per device).

    counts: (N, M) float32 visit counts; t: slots recorded so far (a host
    int, so reading it never waits for the device)."""

    counts: torch.Tensor
    t: int

    @staticmethod
    def create(num_devices: int, M: int, *, device) -> "RhoEstimator":
        return RhoEstimator(
            counts=torch.zeros((num_devices, M), dtype=torch.float32,
                               device=device),
            t=0)

    def update(self, j_idx: torch.Tensor) -> "RhoEstimator":
        """Record current per-device state indices j_idx (N,); returns a
        new estimator and leaves this one's counts untouched."""
        rows = torch.arange(self.counts.shape[0], device=self.counts.device)
        counts = self.counts.clone()
        # one index per row: a plain gather + put, no accumulating scatter
        # (which sorts its indices on CUDA)
        counts[rows, j_idx.long()] += 1.0
        return RhoEstimator(counts=counts, t=self.t + 1)

    @property
    def rho(self) -> torch.Tensor:
        """(N, M) empirical distribution; uniform-safe at t=0.  The divisor
        is a tensor on the counts' device: CUDA divides by a host scalar
        as a product with its reciprocal, which rounds otherwise than the
        CPU's (and the reference's) division."""
        return self.counts / _divisor(max(self.t, 1), self.counts)


_DIVISORS: dict = {}  # (device, dtype) -> 1, 2, ..., n on that device


def _divisor(t: int, like: torch.Tensor) -> torch.Tensor:
    """t as a 0-dim tensor on ``like``'s device and dtype: a view into a
    table of 1 .. n made once (grown by doubling), so a slot loop adds no
    kernel for it."""
    key = (like.device, like.dtype)
    table = _DIVISORS.get(key)
    if table is None or table.numel() < t:
        n = max(1024, 1 << (t - 1).bit_length())
        table = torch.arange(1, n + 1, dtype=like.dtype, device=like.device)
        _DIVISORS[key] = table
    return table[t - 1]


def empirical_rho(trace: torch.Tensor, M: int) -> torch.Tensor:
    """Exact empirical distribution of a whole (T, N) trace -> (N, M)."""
    one_hot = torch.nn.functional.one_hot(trace.long(), M).float()
    return one_hot.mean(dim=0)
