"""The benchmark's image pool and the state space calibrated to it.

A frozen copy of the program's generators, so that a later change to the
program cannot move the yardstick: ``synthetic_gain_problem`` and
``oracle_pool`` (``repro_torch/gain/train.py``: a softmax over C classes
per image, gains from the device's own confidence, the oracle tables
phi_hat = gain, sigma = 0.02, correctness drawn consistently with the
gains, cloudlet cycles ~ N(441e6, 90e6) clipped at 150e6) and the space
of ``serve/simulator.py::calibrated_space`` (the paper's power levels at
10 / 25 / 40 Mbps, cycles at 441e6 -/+ 90e6, ``num_w`` gain levels up to
the 0.999 quantile of the risk-adjusted gains).  numpy float64, as there.
"""

from __future__ import annotations

import dataclasses

import numpy as np

RATES = np.array([10.0, 25.0, 40.0])  # Mbps, the testbed's operating points
H_LEVELS = (441e6 - 90e6, 441e6, 441e6 + 90e6)  # cloudlet cycles a task


def power_of_rate(r):
    """The paper's Fig. 2b fitted transmit power (W) at rate r (Mbps)."""
    return -0.00037 * r**2 + 0.0214 * r + 0.1277


@dataclasses.dataclass(frozen=True)
class Pool:
    """Per-image arrays, each (S,) float64: the pool both sides get."""

    local_correct: np.ndarray
    cloud_correct: np.ndarray
    d_local: np.ndarray
    phi_hat: np.ndarray
    sigma: np.ndarray
    cycles: np.ndarray

    @property
    def S(self) -> int:
        return len(self.phi_hat)


def make_pool(S: int, C: int, seed: int) -> Pool:
    """The oracle pool over ``synthetic_gain_problem(S, C, seed)``, its
    correctness and cycles drawn from ``seed`` too."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0.0, 1.6, (S, C))
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    top1 = probs.max(-1)
    ent = -np.sum(probs * np.log(probs + 1e-9), axis=-1) / np.log(C)
    cls_offset = rng.uniform(0.0, 0.08, C)[probs.argmax(-1)]
    gains = np.clip(0.22 * (1.0 - top1) + 0.10 * ent + cls_offset
                    + rng.normal(0.0, 0.015, S), 0.0, 1.0)

    rng = np.random.default_rng(seed)
    local_correct = rng.random(S) < np.clip(top1, 0.25, 0.95)
    cloud_correct = local_correct | (rng.random(S)
                                     < np.clip(2.2 * gains, 0.0, 0.95))
    return Pool(local_correct=local_correct.astype(np.float64),
                cloud_correct=cloud_correct.astype(np.float64),
                d_local=top1.astype(np.float64),
                phi_hat=np.asarray(gains, np.float64),
                sigma=np.full(S, 0.02),
                cycles=np.clip(rng.normal(441e6, 90e6, S), 150e6, None))


def state_levels(pool: Pool, num_w: int, v_risk: float):
    """(o_levels, h_levels, w_levels) of the space calibrated to ``pool``:
    Python floats (float64), the state (io, ih, iw) at flat index
    (io * 3 + ih) * num_w + iw + 1, state 0 the null state."""
    w_all = np.clip(pool.phi_hat - v_risk * pool.sigma, 0.0, 1.0)
    w_hi = max(float(np.quantile(w_all, 0.999)), 0.1)
    return (tuple(power_of_rate(RATES).tolist()), H_LEVELS,
            tuple(np.linspace(0.0, w_hi, num_w).tolist()))
