"""Theorem-1 machinery: compute the bound terms on a realized sample path.

Port of ``repro/core/theory.py`` (host numpy, unchanged): it consumes the
series of ``fleet.simulate(..., with_true_rho=True)`` as host arrays.

Because the objective/constraints of P1 are LINEAR in y, the Lagrangian
minimizer z_t = argmin_y f(y) + lam_t^T g(y) coincides with the OnAlgo
threshold policy y_t wherever rho has mass (the threshold sign does not
depend on rho >= 0).  Hence the error term C_T of Theorem 1(a) collapses to
C_T = (1/T) sum_t lam_t^T delta_t(y_t), which ``fleet.simulate`` records as
the ``lam_delta`` series.  The bound checks here are exact, per sample path.
"""

from __future__ import annotations

import numpy as np


def _host(x) -> np.ndarray:
    """A tensor (any device) or array-like as a host numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def sigma_g(tables, B, H, N: int, precondition: bool = True,
            H_k=None) -> float:
    """Uniform bound on ||g_t(y)|| over y in Y (Assumption 1).

    rho_t is a distribution, so |sum_j o^j rho^j y^j - B_n| <= max(B_n,
    o_max - B_n) and the capacity row is bounded by max(H, N*h_max - H).
    With preconditioning (the default OnAlgo mode) every row is divided by
    its RHS first.

    With a multi-cloudlet topology pass its ``H_k`` — the single capacity
    row becomes K rows, each bounded by max(H_k, N*h_max - H_k) (a worst
    case where the whole fleet associates with cloudlet k); the engines
    precondition those rows by the scalar ``params.H``, so the bound
    divides by ``H``, not ``H_k``.
    """
    o_tab, h_tab, _ = (_host(t) for t in tables)
    o_max, h_max = float(o_tab.max()), float(h_tab.max())
    B = np.broadcast_to(_host(B).astype(np.float64), (N,))
    caps = (np.asarray([float(H)], np.float64) if H_k is None
            else _host(H_k).astype(np.float64))
    if precondition:
        per_dev = np.maximum(1.0, o_max / B - 1.0)
        cap = np.maximum(caps / float(H), N * h_max / float(H)
                         - caps / float(H))
    else:
        per_dev = np.maximum(B, np.maximum(o_max - B, 0.0))
        cap = np.maximum(caps, N * h_max - caps)
    return float(np.sqrt((per_dev**2).sum() + (cap**2).sum()))


def step_series(rule_a: float, rule_beta: float, T: int) -> np.ndarray:
    t = np.arange(1, T + 1, dtype=np.float64)
    return rule_a / t**rule_beta


def theorem1_terms(series, final_lam_norm: float, rule_a: float,
                   rule_beta: float, sig_g: float):
    """Compute every RHS term of Theorem 1 (a) and (b) on a sample path.

    ``series`` is the dict from fleet.simulate(..., with_true_rho=True);
    requires keys lam_norm (T,), lam_delta (T,), delta_norm (T,).
    Returns dict of named terms (all floats, reward convention for (a)).
    """
    lam_norm = _host(series["lam_norm"]).astype(np.float64)
    T = lam_norm.shape[0]
    a = step_series(rule_a, rule_beta, T)
    inv_a = 1.0 / a
    inv_prev = np.concatenate([[inv_a[0]], inv_a[:-1]])  # 1/a_0 := 1/a_1
    # lam_t in the theorem is the dual BEFORE the slot update; our series
    # stores the post-update value, so shift by one (lam_1 = 0).
    lam_pre = np.concatenate([[0.0], lam_norm[:-1]])

    step_term = sig_g**2 / (2 * T) * a.sum()
    growth_term = float((lam_pre**2 * (inv_a - inv_prev)).sum() / (2 * T))
    final_term = final_lam_norm**2 * inv_a[-1] / (2 * T)
    c_T = float(_host(series["lam_delta"]).astype(np.float64).mean())

    viol_first = final_lam_norm * inv_a[-1] / T
    viol_growth = float((lam_pre * (inv_a - inv_prev)).sum() / T)
    viol_delta = float(_host(series["delta_norm"]).astype(np.float64).mean())

    return {
        "C_T": c_T,
        "step_term": step_term,
        "growth_term": growth_term,
        "final_term": final_term,
        "gap_bound": c_T + step_term + growth_term - final_term,
        "viol_bound": viol_first + viol_growth + viol_delta,
    }


def empirical_gap(series, reward_star: float) -> float:
    """LHS of Theorem 1(a) in reward convention: R* - (1/T) sum_t R(y_t)."""
    return float(reward_star - _host(series["f_true"]).mean())


def empirical_violation(series) -> float:
    """LHS of Theorem 1(b): || (1/T) sum_t g(y_t) || over the N+K rows
    (K = 1 without a topology: ``g_cap`` is (T,), else (T, K))."""
    g_pow = _host(series["g_pow"]).astype(np.float64).mean(axis=0)  # (N,)
    g_cap = _host(series["g_cap"]).astype(np.float64).mean(axis=0)
    return float(np.sqrt((g_pow**2).sum() + (g_cap**2).sum()))


def positive_violation(series) -> float:
    """Practical metric: || [ (1/T) sum_t g(y_t) ]^+ || (only real
    violations)."""
    g_pow = np.clip(_host(series["g_pow"]).astype(np.float64).mean(axis=0),
                    0, None)
    g_cap = np.clip(_host(series["g_cap"]).astype(np.float64).mean(axis=0),
                    0, None)
    return float(np.sqrt((g_pow**2).sum() + (g_cap**2).sum()))
