"""Fleet traffic/state trace generators (paper Sec. VI.A/VI.C).

Port of ``repro/data/traces.py``.  Two regimes:
  * ``iid_trace`` — per-slot independent tasks; exact true rho available.
  * ``bursty_trace`` — the paper's evaluation traffic: sensor-activated
    cameras emit task bursts (geometric gaps, uniform 5-10 slot bursts),
    with a Markov-modulated channel driving the power cost (non-iid).

Traces are drawn on the host with numpy's ``default_rng``, so a seed gives
the reference's trace and ``true_rho`` exactly; the result is moved to
``device`` (None -> cuda).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.fleet import Trace
from repro_torch.core.state_space import StateSpace
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    T: int
    N: int
    task_prob: float = 0.6  # per-slot task probability (iid) / burst density
    seed: int = 0
    # bursty parameters (slots)
    burst_len_lo: int = 5
    burst_len_hi: int = 10
    mean_gap: float = 8.0
    # Markov channel: P(stay) for the 2-state (good/bad) power process
    channel_stay: float = 0.9


def _level_probs(rng, L, concentration=3.0):
    return rng.dirichlet(np.full(L, concentration))


def _dloc_from_w(rng, w_vals, noise=0.08):
    """Local confidence anti-correlated with the offloading gain."""
    d = 1.0 - w_vals + rng.normal(0, noise, size=w_vals.shape)
    return np.clip(d, 0.0, 1.0)


def w_table(space: StateSpace) -> np.ndarray:
    """The (M,) float32 gain table as numpy (the generators' lookup)."""
    return space.tables("cpu")[2].numpy()


def _finish(j, d_local, rho_row, N, M, device):
    """(Trace, (N, M) rho) on ``device`` from host arrays."""
    dev = resolve_device(device)
    rho = np.broadcast_to(rho_row, (N, M)).astype(np.float32)
    return (Trace(j_idx=torch.tensor(j, dtype=torch.int32, device=dev),
                  d_local=torch.tensor(d_local, dtype=torch.float32,
                                       device=dev)),
            torch.tensor(rho, device=dev))


def iid_trace(space: StateSpace, spec: TraceSpec, probs=None, *,
              device=None):
    """IID trace. Returns (Trace, true_rho (N, M))."""
    rng = np.random.default_rng(spec.seed)
    Lo, Lh, Lw = space.num_levels
    if probs is None:
        probs = (_level_probs(rng, Lo), _level_probs(rng, Lh),
                 _level_probs(rng, Lw))
    po, ph, pw = (np.asarray(p, np.float64) for p in probs)

    io = rng.choice(Lo, size=(spec.T, spec.N), p=po)
    ih = rng.choice(Lh, size=(spec.T, spec.N), p=ph)
    iw = rng.choice(Lw, size=(spec.T, spec.N), p=pw)
    j = np.asarray(space.encode(io, ih, iw))
    task = rng.random((spec.T, spec.N)) < spec.task_prob
    j = np.where(task, j, 0)
    d_local = _dloc_from_w(rng, w_table(space)[j])

    # exact stationary distribution (the same for every device)
    joint = po[:, None, None] * ph[None, :, None] * pw[None, None, :]
    rho_row = np.concatenate([[1.0 - spec.task_prob],
                              spec.task_prob * joint.reshape(-1)])
    return _finish(j, d_local, rho_row, spec.N, space.M, device)


def bursty_trace(space: StateSpace, spec: TraceSpec, probs=None, *,
                 device=None):
    """Bursty, Markov-modulated (non-iid) trace. Returns (Trace,
    approx_rho): an alternating renewal ON/OFF task process per device
    (OFF ~ Geometric(1/mean_gap), ON ~ Uniform{burst_len_lo..hi}) and a
    2-state Markov channel choosing a low- or high-cost-biased power
    level; approx_rho is the analytic stationary distribution."""
    rng = np.random.default_rng(spec.seed)
    Lo, Lh, Lw = space.num_levels
    if probs is None:
        probs = (None, _level_probs(rng, Lh), _level_probs(rng, Lw))
    _, ph, pw = probs
    ph = np.asarray(ph if ph is not None else _level_probs(rng, Lh))
    pw = np.asarray(pw if pw is not None else _level_probs(rng, Lw))

    # good / bad channel power-level distributions
    bias = np.linspace(2.0, 0.5, Lo)
    p_good = bias / bias.sum()
    p_bad = bias[::-1] / bias.sum()

    # ON/OFF renewal per device
    on = np.zeros((spec.T, spec.N), bool)
    for n in range(spec.N):
        t = int(rng.integers(0, spec.burst_len_hi))
        while t < spec.T:
            ln = int(rng.integers(spec.burst_len_lo, spec.burst_len_hi + 1))
            on[t:t + ln, n] = True
            t += ln + 1 + int(rng.geometric(1.0 / spec.mean_gap))

    # Markov channel per device
    ch = np.zeros((spec.T, spec.N), np.int64)
    ch[0] = rng.integers(0, 2, spec.N)
    flips = rng.random((spec.T, spec.N)) > spec.channel_stay
    for t in range(1, spec.T):
        ch[t] = np.where(flips[t], 1 - ch[t - 1], ch[t - 1])

    # two-table categorical draw by inverse CDF
    u = rng.random((spec.T, spec.N))
    cdf_g, cdf_b = np.cumsum(p_good), np.cumsum(p_bad)
    io_g = np.clip(np.searchsorted(cdf_g, u, side="right"), 0, Lo - 1)
    io_b = np.clip(np.searchsorted(cdf_b, u, side="right"), 0, Lo - 1)
    io = np.where(ch == 0, io_g, io_b)

    ih = rng.choice(Lh, size=(spec.T, spec.N), p=ph)
    iw = rng.choice(Lw, size=(spec.T, spec.N), p=pw)
    j = np.asarray(space.encode(io, ih, iw))
    j = np.where(on, j, 0)
    d_local = _dloc_from_w(rng, w_table(space)[j])

    # analytic stationary rho: P(on) x the channel's (1/2, 1/2) mixture
    mean_on = (spec.burst_len_lo + spec.burst_len_hi) / 2.0
    p_on = mean_on / (mean_on + 1.0 + spec.mean_gap)
    po_st = 0.5 * p_good + 0.5 * p_bad
    joint = po_st[:, None, None] * ph[None, :, None] * pw[None, None, :]
    rho_row = np.concatenate([[1.0 - p_on], p_on * joint.reshape(-1)])
    return _finish(j, d_local, rho_row, spec.N, space.M, device)


def load_profile_trace(space: StateSpace, spec: TraceSpec, bursts_per_min,
                       *, device=None):
    """Trace with a target burst rate (paper Fig. 6 x-axis: bursts/min);
    one slot is one second, so the rate sets mean_gap."""
    mean_on = (spec.burst_len_lo + spec.burst_len_hi) / 2.0
    gap = max(60.0 / max(bursts_per_min, 1e-6) - mean_on, 1.0)
    spec = dataclasses.replace(spec, mean_gap=gap)
    return bursty_trace(space, spec, device=device)
