"""Oracle benchmark: solve P1 exactly with the TRUE state distribution rho.

Port of ``repro/core/oracle.py``.  The paper's benchmark (Sec. II.C) is the
optimal static randomized policy y* of

    P1: max_{y in [0,1]^{N x M}}  sum_n sum_j w_n^j rho_n^j y_n^j
        s.t.  sum_j o_n^j rho_n^j y_n^j <= B_n          (per device n)
              sum_n sum_j h_n^j rho_n^j y_n^j <= H      (cloudlet)

which is an LP.  Two solvers:

- ``solve_lp``: exact, via scipy HiGHS on float64 inputs (host-side), the
  reference's LP, so the same y* and reward;
- ``solve_dual_ascent``: a plain torch loop of the preconditioned dual
  subgradient with primal averaging on the true rho (OnAlgo's primal and
  dual maps with zero perturbation), on the inputs' device.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from scipy.optimize import linprog

from repro_torch.core.onalgo import policy_matrix


def _np(x):
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def _broadcast_tables(tables, N, M):
    return tuple(np.broadcast_to(_np(t).astype(np.float64), (N, M))
                 for t in tables)


def solve_lp(rho, tables, B, H):
    """Exact P1 solution. rho: (N, M); tables (M,) or (N, M); B: (N,); H:
    scalar (tensors or arrays).  Returns (y_star (N, M) float64 numpy,
    reward_star) with reward = sum w rho y."""
    rho = _np(rho).astype(np.float64)
    N, M = rho.shape
    o, h, w = _broadcast_tables(tables, N, M)
    B = np.broadcast_to(_np(B).astype(np.float64), (N,))

    c = -(w * rho).reshape(-1)  # maximize -> minimize -c
    # per-device power rows (one a device), then the capacity row
    rows, cols, vals = [], [], []
    for n in range(N):
        rows.extend([n] * M)
        cols.extend(range(n * M, (n + 1) * M))
        vals.extend((o[n] * rho[n]).tolist())
    rows.extend([N] * (N * M))
    cols.extend(range(N * M))
    vals.extend((h * rho).reshape(-1).tolist())
    A = sp.csr_matrix((vals, (rows, cols)), shape=(N + 1, N * M))
    b = np.concatenate([B, [float(_np(H))]])

    res = linprog(c, A_ub=A, b_ub=b, bounds=(0.0, 1.0), method="highs")
    if not res.success:  # pragma: no cover - LP is always feasible (y=0)
        raise RuntimeError(f"oracle LP failed: {res.message}")
    y = res.x.reshape(N, M)
    return y, float((w * rho * y).sum())


def solve_dual_ascent(rho, tables, B, H, iters: int = 2000,
                      step: float = None):
    """P1 via exact dual subgradient + primal averaging (Nedic-Ozdaglar).

    The same primal/dual maps as OnAlgo, with the true rho and no state
    estimation, in float32 on rho's device; constraint rows rescaled to
    right-hand side 1 (OnAlgoParams(precondition=True)'s preconditioner),
    step a_t = step / sqrt(t + 1).  Returns (y_bar (N, M), reward(y_bar),
    max constraint violation of y_bar in the preconditioned units), as
    tensors."""
    o_tab, h_tab, w_tab = tables
    N, M = rho.shape
    dev = rho.device
    step = 1.0 if step is None else step
    B = torch.as_tensor(B, dtype=torch.float32, device=dev)
    H = torch.as_tensor(H, dtype=torch.float32, device=dev)
    o_s = o_tab.expand(N, M) / B[:, None]
    h_s = h_tab.expand(N, M) / H
    lam = torch.zeros((N,), dtype=torch.float32, device=dev)
    mu = torch.zeros((), dtype=torch.float32, device=dev)
    y_sum = torch.zeros((N, M), dtype=torch.float32, device=dev)
    for t in range(iters):
        y = policy_matrix(lam, mu, o_s, h_s, w_tab)
        g_pow = torch.sum(o_s * rho * y, dim=-1) - 1.0
        g_cap = torch.sum(h_s * rho * y) - 1.0
        # step / sqrt(t + 1) in float32 arithmetic, as the reference's
        a_t = float(np.float32(step)
                    / np.sqrt(np.float32(t) + np.float32(1.0)))
        lam = torch.clamp_min(lam + a_t * g_pow, 0.0)
        mu = torch.clamp_min(mu + a_t * g_cap, 0.0)
        y_sum = y_sum + y
    y_bar = y_sum / iters
    reward = torch.sum(w_tab.expand(N, M) * rho * y_bar)
    viol = torch.maximum(
        torch.max(torch.sum(o_s * rho * y_bar, dim=-1) - 1.0),
        torch.sum(h_s * rho * y_bar) - 1.0)
    return y_bar, reward, torch.clamp_min(viol, 0.0)
