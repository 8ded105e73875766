"""Batched hyperparameter sweeps over grids of (step rule, budgets).

Port of ``repro/scenarios/sweeps.py``.  A grid of G cells (each an
(a, beta) step rule and (B, H) budgets) shares one trace and one set of
tables.  Two engines:

  * ``scan``: ``fleet.simulate`` once per cell, the results stacked (any
    algo, the Theorem-1 series, the single-slot kernel K3 with
    ``use_kernel``); bit for bit with a loop of ``simulate`` by
    construction.  (The reference vmaps the scan; a batched scan is not
    ported yet.)
  * ``chunked``: the whole grid as ONE call of the fused rollout with a
    cell axis: K1 (``block_n=None``, ``kernels.ops.onalgo_chunked_cells``)
    or the device-tiled K2 (``onalgo_tiled_cells``), the counterpart of
    the reference's vmap of ``simulate_chunked``; bit for bit with a loop
    of per-cell ``simulate_chunked`` calls.

Every leaf of the result has a leading G axis: series (G, T), final duals
(G, N) / (G,), visit counts (G, N, M).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import fleet
from repro_torch.core.fleet import Trace, simulate, simulate_chunked
from repro_torch.core.onalgo import OnAlgoParams, OnAlgoState, StepRule
from repro_torch.core.state_space import RhoEstimator
from repro_torch.device import resolve_device


@dataclasses.dataclass
class StackedRules:
    """G step rules a / t^beta as (G,) float32 arrays."""

    a: np.ndarray
    beta: np.ndarray

    def cell(self, g: int) -> StepRule:
        return StepRule(float(self.a[g]), float(self.beta[g]))


@dataclasses.dataclass
class SweepGrid:
    """A flat grid of G sweep cells: stacked step rules + stacked params.

    rules:  :class:`StackedRules` with (G,) leaves.
    params: OnAlgoParams with B (G, N) and H (G,) leaves.
    labels: G human-readable cell names (emitted by benchmarks).
    """

    rules: StackedRules
    params: OnAlgoParams
    labels: Tuple[str, ...]

    @property
    def G(self) -> int:
        return len(self.labels)

    def cell(self, g: int) -> Tuple[StepRule, OnAlgoParams]:
        """Cell g's (rule, params)."""
        return self.rules.cell(g), OnAlgoParams(
            B=self.params.B[g], H=self.params.H[g],
            precondition=self.params.precondition)


def stack_rules(rules: Sequence[StepRule]) -> StackedRules:
    return StackedRules(
        a=np.array([r.a for r in rules], np.float32),
        beta=np.array([r.beta for r in rules], np.float32))


def stack_params(params: Sequence[OnAlgoParams]) -> OnAlgoParams:
    pre = {p.precondition for p in params}
    if len(pre) != 1:
        raise ValueError("all sweep cells must share `precondition` "
                         "(it is a static compile-time flag)")
    return OnAlgoParams(B=torch.stack([p.B for p in params]),
                        H=torch.stack([p.H for p in params]),
                        precondition=pre.pop())


def product_grid(N: int,
                 a_values: Sequence[float] = (0.5,),
                 beta_values: Sequence[float] = (0.5,),
                 B_values: Sequence[float] = (0.08,),
                 H_values: Sequence[float] = (8.82e8,), *,
                 device=None) -> SweepGrid:
    """Cross product over step rule (a, beta) x budgets (B, H), the params
    on ``device`` (None -> cuda)."""
    dev = resolve_device(device)
    rules, params, labels = [], [], []
    for a, b, B, H in itertools.product(a_values, beta_values, B_values,
                                        H_values):
        rules.append(StepRule.power(a, b))
        params.append(OnAlgoParams(
            B=torch.full((N,), B, dtype=torch.float32, device=dev),
            H=torch.tensor(H, dtype=torch.float32, device=dev)))
        labels.append(f"a={a}/beta={b}/B={B}/H={H:.3g}")
    return SweepGrid(stack_rules(rules), stack_params(params),
                     tuple(labels))


def grid_from_cells(cells: Sequence[Tuple[str, StepRule, OnAlgoParams]]
                    ) -> SweepGrid:
    """Grid from explicit (label, rule, params) cells."""
    labels, rules, params = zip(*[(l, r, p) for l, r, p in cells])
    return SweepGrid(stack_rules(rules), stack_params(params),
                     tuple(labels))


def _stack_runs(runs):
    """Stack per-cell (series, final) pairs along a leading G axis.  An
    OnAlgo final state stacks into one OnAlgoState; a baseline's states
    stay a tuple of the cells' states."""
    series = {k: torch.stack([s[k] for s, _ in runs]) for k in runs[0][0]}
    finals = [f for _, f in runs]
    if not isinstance(finals[0], OnAlgoState):
        return series, tuple(finals)
    return series, OnAlgoState(
        lam=torch.stack([f.lam for f in finals]),
        mu=torch.stack([f.mu for f in finals]),
        rho=RhoEstimator(counts=torch.stack([f.rho.counts for f in finals]),
                         t=finals[0].rho.t))


def cell_tables(o_tab, h_tab, params: OnAlgoParams):
    """The grid's tables in the dual space, as each cell's
    ``onalgo.precondition_tables`` forms them, stacked: o' = o / B_g[n]
    (G, N, M) and h' = h / H_g ((G, 1, M), or (G, N, M) for a per-device
    h),
    with unit right-hand sides; without ``precondition`` the shared
    tables and the cells' B (G, N) and H (G,)."""
    if not params.precondition:
        return o_tab, h_tab, params.B, params.H
    H = params.H.reshape(-1, 1, 1)
    return (o_tab / params.B[:, :, None], h_tab / H,
            torch.ones_like(params.B), torch.ones_like(params.H))


def _chunked_sweep(trace: Trace, tables, grid: SweepGrid, algo: str,
                   enforce_slot_capacity: bool, chunk: int,
                   block_n: Optional[int], dev):
    """The chunked engine over the grid: one cell-axis rollout call for
    the first (T // chunk) * chunk slots, each cell's tail by the plain
    slot step and its series from its offload matrix, as
    ``simulate_chunked`` does for one cell."""
    from repro_torch.kernels import ops as kops

    trace, tables, params = fleet._on(dev, trace, tables, grid.params)
    cells = [(grid.rules.cell(g), OnAlgoParams(
        B=params.B[g], H=params.H[g], precondition=params.precondition))
        for g in range(grid.G)]
    if algo != "onalgo":  # the stateless policies run no kernel
        return _stack_runs([simulate_chunked(
            trace, tables, p, r, chunk=chunk, algo=algo,
            enforce_slot_capacity=enforce_slot_capacity, device=dev)
            for r, p in cells])
    o_tab, h_tab, w_tab = tables
    T, N = trace.j_idx.shape
    G, M = grid.G, o_tab.shape[-1]
    j_seq = trace.j_idx
    T_main = (T // chunk) * chunk
    lam = torch.zeros((G, N), dtype=torch.float32, device=dev)
    mu = torch.zeros((G,), dtype=torch.float32, device=dev)
    counts = torch.zeros((G, N, M), dtype=torch.float32, device=dev)
    if T_main:
        o_s, h_s, B_eff, H_eff = cell_tables(o_tab, h_tab, params)
        kw = (dict(block_n=block_n) if block_n is not None else {})
        kern = (kops.onalgo_chunked_cells if block_n is None
                else kops.onalgo_tiled_cells)
        off, mu_seq, lnorm, lam, mu, counts = kern(
            j_seq[:T_main], lam, mu, counts, o_s, h_s, w_tab, B_eff, H_eff,
            grid.rules.a, grid.rules.beta, chunk=chunk, **kw)
    else:
        off = torch.zeros((G, 0, N), dtype=torch.bool, device=dev)
        mu_seq = lnorm = torch.zeros((G, 0), dtype=torch.float32, device=dev)
    runs = []
    for g, (rule, p) in enumerate(cells):
        off_g, mu_g, ln_g = off[g], mu_seq[g], lnorm[g]
        lam_g, mu_f, counts_g = lam[g], mu[g], counts[g]
        if T_main < T:
            state = OnAlgoState(lam=lam_g, mu=mu_f, rho=RhoEstimator(
                counts=counts_g, t=T_main))
            state, off_t, mu_t, ln_t = fleet._onalgo_tail(
                state, j_seq[T_main:], None, tables, p, rule)
            off_g = torch.cat([off_g, off_t], dim=0)
            mu_g = torch.cat([mu_g, mu_t])
            ln_g = torch.cat([ln_g, ln_t])
            lam_g, mu_f, counts_g = state.lam, state.mu, state.rho.counts
        series = fleet._series_from_offloads(
            j_seq, off_g, tables, p, mu_g, ln_g, None,
            enforce_slot_capacity)
        runs.append((series, OnAlgoState(lam=lam_g, mu=mu_f, rho=RhoEstimator(
            counts=counts_g, t=T))))
    return _stack_runs(runs)


def sweep_simulate(trace: Trace,
                   tables,
                   grid: SweepGrid,
                   algo: str = "onalgo",
                   true_rho=None,
                   with_true_rho: bool = False,
                   use_kernel: bool = False,
                   enforce_slot_capacity: bool = False,
                   engine: str = "scan",
                   chunk: int = 8,
                   block_n: Optional[int] = None, *, device=None):
    """Run every grid cell on the chosen engine, on ``device`` (None ->
    cuda; inputs are moved).

    engine="scan" runs ``simulate`` per cell (any algo, the Theorem-1
    series); engine="chunked" runs the whole grid as ONE call of the
    cell-axis rollout (``block_n`` routes device-tiled), bit for bit with
    a loop of per-cell ``simulate_chunked`` calls.  The Theorem-1 options
    (``true_rho`` / ``with_true_rho``) and ``use_kernel`` are scan-only.

    Returns (series, final_state) with a leading G axis on every leaf:
    series values are (G, T), final duals (G, N) / (G,).
    """
    dev = resolve_device(device)
    if engine == "chunked":
        if with_true_rho or true_rho is not None or use_kernel:
            raise ValueError(
                "true_rho / with_true_rho / use_kernel are scan-only "
                "sweep options; the chunked engine IS the kernel")
        return _chunked_sweep(trace, tables, grid, algo,
                              enforce_slot_capacity, chunk, block_n, dev)
    if engine != "scan":
        raise ValueError(f"unknown sweep engine {engine!r}; "
                         "expected scan | chunked")
    return _stack_runs([simulate(
        trace, tables, p, r, algo=algo,
        enforce_slot_capacity=enforce_slot_capacity, use_kernel=use_kernel,
        true_rho=true_rho, with_true_rho=with_true_rho, device=dev)
        for r, p in (grid.cell(g) for g in range(grid.G))])


def unstack_series(series: Dict[str, torch.Tensor], grid: SweepGrid):
    """Yield (label, per-cell series dict of numpy arrays), host-side."""
    arrs = {k: v.cpu().numpy() for k, v in series.items()}
    for g, label in enumerate(grid.labels):
        yield label, {k: v[g] for k, v in arrs.items()}
