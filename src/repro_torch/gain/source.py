"""Gain sources: where the offloading-gain estimate comes from.

Port of ``repro/gain/source.py``.  The paper's devices offload only when
they *predict* a significant gain (eq. 1: w = phi_hat - v * sigma).  A
:class:`GainSource` resolves to the per-image ``(phi_hat, sigma)`` tables
behind the one value lowering (``serve.compile._lower_values``) that every
engine consumes — the slot loop, the rollout kernels' ``slot_values``
streams, the streaming slabs and the live gateway all sit ABOVE the
tables, so swapping the source never touches an engine.

  :class:`TableGain` — the pool's own phi_hat/sigma tables (the oracle
    when the pool carries true gains): the same float32 tables
    ``gain_source=None`` builds, so it is bit for bit today's decisions.

  :class:`OverlayGain` — the risk adjustment pre-folded into one raw gain
    table (``w = clip(phi - v*sigma, 0, 1)``, sigma = 0 downstream).
    ``risk_adjusted_gain`` is elementwise, so it commutes with the per-slot
    image gather: the ``w`` stream, and every decision, equal the table
    source's.

  :class:`ModelGain` — a predictor (ridge or the SSD head, see
    :mod:`repro_torch.gain.model`) fills the tables from the pool images'
    local-classifier probabilities, snapped by default onto a
    ``num_w_levels``-point gain grid; ``to_pool_tables()`` freezes them
    back into a ``PrecomputedPool``, and ``TableGain`` over that pool
    replays the live model bit for bit.

Every method that makes tensors takes ``device`` (None -> cuda).  The
snap reproduces the reference's float32 arithmetic: ``jnp.quantile``'s
linear interpolation (its compiled CPU program fuses the high term's
product into the sum) and ``jnp.linspace``'s levels as XLA computes them
(``i * (hi * (1 / (L - 1)))``, the end point ``hi`` itself).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.onalgo import risk_adjusted_gain
from repro_torch.device import resolve_device


class GainTables(NamedTuple):
    """Resolved per-image gain tables, float32 (S,) tensors."""

    phi_hat: torch.Tensor
    sigma: torch.Tensor


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=torch.float32, device=device)


class GainSource:
    """Frozen interface: a source of the per-image gain-table pair.

    Implementations are frozen dataclasses.  Contract:

      * ``tables(pool, sim, device=)`` -> :class:`GainTables`, float32 (S,)
        tensors congruent with the pool;
      * ``space(pool, sim, device=)`` -> the :class:`StateSpace`
        calibrated to those tables;
      * ``to_pool_tables(pool, sim, device=)`` -> a new ``PrecomputedPool``
        with the resolved tables frozen in (float64 copies of the exact
        float32 values);
      * ``resolve(pool, sim, device=)`` -> (tables, space) from ONE
        resolution: what ``serve.compile`` calls, once per compile.
    """

    def tables(self, pool, sim, *, device=None) -> GainTables:
        raise NotImplementedError

    def _space_for(self, pool, sim, gt: GainTables):
        """The space calibrated to resolved tables (float64, the same
        arithmetic ``pool_space`` applies to a pool's own arrays)."""
        from repro_torch.serve.simulator import calibrated_space
        return calibrated_space(gt.phi_hat.cpu().double().numpy(),
                                gt.sigma.cpu().double().numpy(),
                                num_w=sim.num_w_levels, v_risk=sim.v_risk)

    def space(self, pool, sim, *, device=None):
        return self._space_for(pool, sim,
                               self.tables(pool, sim, device=device))

    def resolve(self, pool, sim, *, device=None):
        gt = self.tables(pool, sim, device=device)
        return gt, self._space_for(pool, sim, gt)

    def to_pool_tables(self, pool, sim, *, device=None):
        """Freeze the resolved tables into a new pool (all other arrays
        shared) — a trained model exported back to the oracle format."""
        gt = self.tables(pool, sim, device=device)
        return dataclasses.replace(
            pool, phi_hat=gt.phi_hat.cpu().double().numpy(),
            sigma=gt.sigma.cpu().double().numpy())


@dataclasses.dataclass(frozen=True)
class TableGain(GainSource):
    """The pool's phi_hat/sigma tables verbatim (the oracle): the float32
    tables ``gain_source=None`` uploads."""

    def tables(self, pool, sim, *, device=None) -> GainTables:
        dev = resolve_device(device)
        return GainTables(_f32(pool.phi_hat, dev), _f32(pool.sigma, dev))

    def _space_for(self, pool, sim, gt):
        from repro_torch.serve.simulator import pool_space
        return pool_space(pool, num_w=sim.num_w_levels, v_risk=sim.v_risk)


@dataclasses.dataclass(frozen=True)
class OverlayGain(GainSource):
    """Risk pre-folded into one raw gain table (sigma = 0 downstream).

    The float32 ops :func:`risk_adjusted_gain` applies inside the lowering
    are applied to the whole (S,) table up front; ``w - v*0`` and the clip
    are identities on values already in [0, 1], so the raw ``w`` stream,
    and every decision, equal the table source's.  The state space stays
    pool-calibrated (the same realized distribution)."""

    def tables(self, pool, sim, *, device=None) -> GainTables:
        base = TableGain().tables(pool, sim, device=device)
        phi = risk_adjusted_gain(base.phi_hat, base.sigma,
                                 float(np.float32(sim.v_risk)))
        return GainTables(phi, torch.zeros_like(base.sigma))

    def _space_for(self, pool, sim, gt):
        from repro_torch.serve.simulator import pool_space
        return pool_space(pool, num_w=sim.num_w_levels, v_risk=sim.v_risk)


def grid_levels(num_levels: int, hi) -> torch.Tensor:
    """``jnp.linspace(0.0, hi, num_levels)`` in float32 as the reference's
    compiled program forms it: level i is ``i * (hi * r)`` with r the
    float32 reciprocal of ``num_levels - 1``, the last level ``hi``
    itself.  ``hi`` a float32 scalar tensor (its device is the grid's)."""
    hi = torch.as_tensor(hi, dtype=torch.float32)
    L = int(num_levels)
    if L == 1:
        return torch.zeros((1,), dtype=torch.float32, device=hi.device)
    r = float(np.float32(1.0) / np.float32(L - 1))
    i = torch.arange(L - 1, dtype=torch.float32, device=hi.device)
    return torch.cat([i * (hi * r), hi.reshape(1)])


def snap_to_grid(values: torch.Tensor, num_levels: int, hi) -> torch.Tensor:
    """Snap float32 values onto a uniform ``num_levels``-point grid over
    [0, hi]: the nearest level by float32 distance, ties to the lower
    level (the idiom of ``quantize_states_device``).  Grid values are
    returned exactly, so snapped tables survive a float64 pool round trip
    bit for bit."""
    values = values.float()
    hi = torch.as_tensor(hi, dtype=torch.float32).to(values.device)
    levels = grid_levels(num_levels, hi)
    idx = torch.argmin(torch.abs(values[:, None] - levels[None, :]), dim=1)
    return levels[idx]


def quantile_f32(values: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(values, q)`` (linear interpolation) in float32 as
    the reference's compiled program forms it: position q * (n - 1) in
    float32, weights 1 - frac and frac, and the high term's product fused
    into the sum (one rounding, here through float64).  A float32 scalar
    tensor on ``values``' device."""
    s = torch.sort(values.float().reshape(-1)).values
    n = s.shape[0]
    pos = np.float32(q) * np.float32(n - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    w_hi = np.float32(pos - np.float32(lo))
    w_lo = np.float32(np.float32(1.0) - w_hi)
    low_term = s[lo] * float(w_lo)
    return (s[hi].double() * float(w_hi) + low_term.double()).float()


@dataclasses.dataclass(frozen=True, eq=False)
class ModelGain(GainSource):
    """A trained predictor in the loop.

    ``model`` is any object with ``apply(probs) -> (phi_hat, sigma)`` over
    float32 (S, C) local-classifier probabilities, computed on ``probs``'
    device (:class:`~repro_torch.gain.model.RidgeGainModel`,
    :class:`~repro_torch.gain.model.SeqGainModel`); ``local_probs`` is the
    pool images' (S, C) local softmax output.  With ``quantize=True``
    (default) the predicted phi table is snapped onto a
    ``sim.num_w_levels``-point grid over [0, max(q_0.999(phi), 0.1)], so
    it takes at most ``num_w_levels`` values and freezing via
    ``to_pool_tables()`` round-trips bit for bit through a ``TableGain``.
    """

    model: object
    local_probs: np.ndarray
    quantize: bool = True

    def tables(self, pool, sim, *, device=None) -> GainTables:
        dev = resolve_device(device)
        probs = _f32(self.local_probs, dev)
        if probs.ndim != 2 or probs.shape[0] != len(pool.local_correct):
            raise ValueError(
                f"local_probs shape {tuple(probs.shape)} does not cover the "
                f"pool's {len(pool.local_correct)} images")
        phi, sig = self.model.apply(probs)
        phi = torch.clamp(phi.float(), 0.0, 1.0)
        sig = torch.clamp_min(sig.float(), 0.0)
        if self.quantize:
            hi = torch.clamp_min(quantile_f32(phi, 0.999), 0.1)
            phi = snap_to_grid(phi, sim.num_w_levels, hi)
        return GainTables(phi, sig)


def as_gain_source(source) -> GainSource:
    """Normalize a ``gain_source=`` argument: None -> TableGain, a
    string name -> the trivial sources, a GainSource passes through."""
    if source is None:
        return TableGain()
    if isinstance(source, GainSource):
        return source
    if isinstance(source, str):
        named = {"table": TableGain, "overlay": OverlayGain}
        if source in named:
            return named[source]()
        raise ValueError(f"unknown gain source {source!r}; named sources: "
                         f"{sorted(named)} (ModelGain needs a model)")
    raise TypeError(f"not a GainSource: {source!r}")
