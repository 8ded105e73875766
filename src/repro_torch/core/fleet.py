"""Fleet simulation: roll OnAlgo / baselines over a trace.

Port of the materialized engines of ``repro/core/fleet.py``:

  simulate          the slot loop (the reference's ``lax.scan``), any algo;
                    ``use_kernel`` routes each slot's policy + reductions
                    through the single-slot kernel (K3);
  simulate_chunked  the whole horizon through the fused rollout kernels:
                    K1 (``block_n=None``) or the device-tiled K2.

Both return (series dict of (T,) tensors, final state) with the
reference's keys and accounting.  Both take a multi-cloudlet
``topology``: the capacity dual becomes a (K,) vector (the series gain
``mu_k`` (T, K); ``mu`` becomes the cloudlet mean) and admission runs per
cloudlet; K = 1 runs the scalar path bit for bit.  The streaming and
sharded engines are not ported yet; their options raise
NotImplementedError naming the ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import numpy as np
import torch

from repro_torch.core import baselines as bl
from repro_torch.core import onalgo
from repro_torch.core.onalgo import OnAlgoParams, OnAlgoState, StepRule
from repro_torch.core.state_space import RhoEstimator
from repro_torch.device import resolve_device
from repro_torch.topology import Topology, validate_topology


def _topo_duals(topology: Optional[Topology]) -> Optional[Topology]:
    """The topology driving K-vector duals, or None when the scalar path
    applies (no topology, or K == 1: one cloudlet's dual IS mu, and the
    rollout is bit-identical to the scalar engines, with per-slot
    admission under H_k[0])."""
    return topology if (topology is not None and topology.K > 1) else None


def _on_topology(topology, T, N, dev):
    """Validate ``topology`` against the rollout's (T, N) and move it to
    ``dev``; returns (topology, topo_k)."""
    if topology is None:
        return None, None
    validate_topology(topology, T, N)
    topology = topology.to(dev)
    return topology, _topo_duals(topology)


@dataclasses.dataclass
class Trace:
    """Per-slot per-device quantized state indices + extras.

    j_idx: (T, N) int32 state indices into the StateSpace tables (0 = null).
    d_local: (T, N) float32 local-classifier confidence (for ATO), or zeros.
    """

    j_idx: torch.Tensor
    d_local: torch.Tensor

    @property
    def T(self):
        return self.j_idx.shape[0]

    @property
    def N(self):
        return self.j_idx.shape[1]

    def to(self, device) -> "Trace":
        return Trace(j_idx=self.j_idx.to(device),
                     d_local=self.d_local.to(device))


@dataclasses.dataclass
class RawOverlay:
    """Raw (unquantized) per-slot values riding alongside a quantized Trace:
    decisions and series use these, rho uses ``trace.j_idx``.

    o / h / w: (T, N) float32 observed power (W), cloudlet cycles and
      risk-adjusted predicted gain;
    correct_local / correct_cloud: (T, N) float32 — whether the local /
      cloudlet classifier got this slot's image right.
    """

    o: torch.Tensor
    h: torch.Tensor
    w: torch.Tensor
    correct_local: torch.Tensor
    correct_cloud: torch.Tensor

    def to(self, device) -> "RawOverlay":
        return RawOverlay(*(getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)))

    def slice(self, t0: int, t1: int) -> "RawOverlay":
        return RawOverlay(*(getattr(self, f.name)[t0:t1]
                            for f in dataclasses.fields(self)))


def _lookup(tab, j):
    """Value lookup for (M,) shared or (N, M) per-device tables."""
    j = j.long()
    if tab.ndim == 1:
        return tab[j]
    return torch.gather(tab, 1, j[:, None])[:, 0]


def _on(device, trace, tables, params):
    """The run's inputs moved to ``device`` (no-ops when already there)."""
    tables = tuple(t.to(device) for t in tables)
    params = OnAlgoParams(B=params.B.to(device), H=params.H.to(device),
                          precondition=params.precondition)
    return trace.to(device), tables, params


def simulate(trace: Trace, tables, params: OnAlgoParams, rule: StepRule,
             algo: str = "onalgo", ato_theta: float = 0.5,
             enforce_slot_capacity: bool = False, use_kernel: bool = False,
             true_rho=None, with_true_rho: bool = False,
             overlay: Optional[RawOverlay] = None,
             topology: Optional[Topology] = None,
             collect_decisions: bool = False, *, device=None):
    """Roll a trace through a policy, slot by slot.

    Returns (series dict of (T,) tensors, final_state).  Accounting:
    power is spent on every offload, admitted or not; the gain w is
    realized only for admitted tasks; ``enforce_slot_capacity`` drops
    tasks beyond H per slot (the paper's comparison rule); ``overlay``
    takes o/h/w from the raw streams and adds the ``correct`` series.
    ``algo``: onalgo | ato | rco | ocos | local | cloud.
    ``topology``: K-vector duals (each device priced by its current
    cloudlet), per-cloudlet admission under H_k, and the ``mu_k`` (T, K)
    series (``mu`` becomes the cloudlet mean); K = 1 is the scalar path.
    ``with_true_rho`` (needs ``true_rho`` (N, M)) adds the Theorem-1
    series evaluated under the true distribution, in the dual space:
    ``f_true``, ``g_pow`` (T, N), ``g_cap`` (T,) or (T, K),
    ``delta_norm`` and ``lam_delta`` (see ``core/theory.py``).
    ``collect_decisions`` adds the (T, N) ``offload_mask`` / ``admit_mask``.
    ``device`` (None -> cuda): where the run happens; inputs are moved.
    """
    dev = resolve_device(device)
    trace, tables, params = _on(dev, trace, tables, params)
    if overlay is not None:
        overlay = overlay.to(dev)
    o_tab, h_tab, w_tab = tables
    T, N = trace.j_idx.shape
    M = o_tab.shape[-1]
    topology, topo_k = _on_topology(topology, T, N, dev)
    if topo_k is not None:
        topo_k = topo_k.prefix(T)  # a walk may cover more slots than T
        if use_kernel:
            raise ValueError(
                "use_kernel routes the scalar-mu single-slot kernel and "
                "does not support topology.K > 1; run with "
                "use_kernel=False or through the chunked engines")
    K_mu = None if topo_k is None else topo_k.K
    if with_true_rho:
        if true_rho is None:
            raise ValueError("with_true_rho needs true_rho (N, M)")
        true_rho = torch.as_tensor(true_rho).to(device=dev,
                                                dtype=torch.float32)
        o_s, h_s, B_eff, H_eff = onalgo.precondition_tables(o_tab, h_tab,
                                                            params)
        o_s, h_s, w_full = (x.expand(N, M) for x in (o_s, h_s, w_tab))
        if topo_k is not None:
            H_k_eff = onalgo.precondition_capacities(topo_k.H_k, params)

    if algo == "onalgo":
        state = onalgo.init_state(N, M, K_mu, device=dev)
    elif algo == "ato":
        state = bl.ATOState(theta=float(np.float32(ato_theta)))
    elif algo == "rco":
        state = bl.RCOState(energy=torch.zeros((N,), dtype=torch.float32,
                                               device=dev), t=0)
    elif algo in ("ocos", "local", "cloud"):
        state = bl.OCOSState()
    else:
        raise ValueError(f"unknown algo {algo!r}")

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    keys = ["reward", "power", "power_per_dev", "load", "offloads",
            "admits", "tasks", "lam_norm", "mu"]
    if topology is not None:
        keys.append("mu_k")
    if overlay is not None:
        keys.append("correct")
    if with_true_rho:
        keys += ["f_true", "g_pow", "g_cap", "delta_norm", "lam_delta"]
    rows = {k: [] for k in keys}
    masks = ([], []) if collect_decisions else None

    for t in range(T):
        j = trace.j_idx[t]
        if overlay is None:
            o_now, h_now, w_now = (_lookup(x, j) for x in tables)
        else:
            o_now, h_now, w_now = overlay.o[t], overlay.h[t], overlay.w[t]
        task = j > 0
        assoc_now = None
        if topo_k is not None:
            assoc_now = (topo_k.assoc[t] if topo_k.time_varying
                         else topo_k.assoc)

        mu_k = None
        if algo == "onalgo":
            state, offload = onalgo.step(
                state, j, o_now, h_now, w_now, task, tables, params, rule,
                use_kernel=use_kernel, assoc=assoc_now,
                H_k=None if topo_k is None else topo_k.H_k)
            # ||(lambda, mu)||: the full dual vector norm of Theorem 1
            lam_norm = torch.sqrt(torch.sum(state.lam**2)
                                  + torch.sum(state.mu**2))
            if topo_k is None:
                mu = state.mu
            else:
                mu_k = state.mu
                mu = torch.mean(mu_k)
        else:
            if algo == "ato":
                state, offload = bl.ato_step(state, trace.d_local[t], o_now,
                                             task)
            elif algo == "rco":
                state, offload = bl.rco_step(state, o_now, params.B, task)
            elif algo == "local":
                offload = torch.zeros_like(task)
            else:  # ocos / cloud: offload every task
                state, offload = bl.ocos_step(state, task)
            lam_norm = mu = zero

        sf = algo == "ocos"
        if not enforce_slot_capacity:
            admitted = offload
        elif topology is None:
            admitted = bl.admit_by_capacity(offload, h_now, params.H, sf)
        else:
            admitted = bl.admit_by_capacity_topo(offload, h_now, assoc_now,
                                                 topology.H_k, sf)

        offload_f = offload.float()
        admit_f = admitted.float()
        task_f = task.float()
        rows["reward"].append(torch.sum(w_now * admit_f))
        rows["power"].append(torch.sum(o_now * offload_f))
        rows["power_per_dev"].append(torch.mean(o_now * offload_f))
        rows["load"].append(torch.sum(h_now * admit_f))
        rows["offloads"].append(torch.sum(offload_f))
        rows["admits"].append(torch.sum(admit_f))
        rows["tasks"].append(torch.sum(task_f))
        rows["lam_norm"].append(lam_norm)
        rows["mu"].append(mu)
        if topology is not None:
            rows["mu_k"].append(mu_k if mu_k is not None
                                else mu.expand(topology.K))
        if overlay is not None:
            rows["correct"].append(torch.sum(
                torch.where(admitted, overlay.correct_cloud[t],
                            overlay.correct_local[t]) * task_f))
        if masks is not None:
            masks[0].append(offload)
            masks[1].append(admitted)
        if with_true_rho:
            if algo == "onalgo":
                lam_, mu_, rho_t = state.lam, state.mu, state.rho.rho
            else:
                lam_ = torch.zeros((N,), dtype=torch.float32, device=dev)
                mu_ = torch.zeros(() if K_mu is None else (K_mu,),
                                  dtype=torch.float32, device=dev)
                rho_t = true_rho
            y_pol = onalgo.policy_matrix(lam_, mu_, o_s, h_s, w_tab,
                                         assoc=assoc_now)
            # f/g of the slot policy under the TRUE distribution, and the
            # perturbation terms delta_t(y_t): the rho_t - rho error
            # projected on the policy, per constraint row
            drho = rho_t - true_rho
            d_pow = torch.sum(o_s * drho * y_pol, dim=-1)
            if topo_k is None:
                g_cap = torch.sum(h_s * true_rho * y_pol) - H_eff
                d_cap = torch.sum(h_s * drho * y_pol)
            else:
                g_cap = onalgo.capacity_loads(y_pol, true_rho, h_s,
                                              assoc_now, K_mu) - H_k_eff
                d_cap = onalgo.capacity_loads(y_pol, drho, h_s, assoc_now,
                                              K_mu)
            rows["f_true"].append(torch.sum(w_full * true_rho * y_pol))
            rows["g_pow"].append(torch.sum(o_s * true_rho * y_pol, dim=-1)
                                 - B_eff)
            rows["g_cap"].append(g_cap)
            rows["delta_norm"].append(torch.sqrt(torch.sum(d_pow**2)
                                                 + torch.sum(d_cap**2)))
            rows["lam_delta"].append(torch.sum(lam_ * d_pow)
                                     + torch.sum(mu_ * d_cap))

    series = {k: (torch.stack(v) if v else
                  torch.zeros((0,), dtype=torch.float32, device=dev))
              for k, v in rows.items()}
    if masks is not None:
        empty = torch.zeros((0, N), dtype=torch.bool, device=dev)
        series["offload_mask"] = torch.stack(masks[0]) if T else empty
        series["admit_mask"] = torch.stack(masks[1]) if T else empty
    return series, state


def _series_from_offloads(j_seq, off, tables, params, mu_seq, lnorm,
                          overlay: Optional[RawOverlay],
                          enforce_slot_capacity: bool,
                          smallest_first: bool = False,
                          topology: Optional[Topology] = None,
                          t0: int = 0):
    """Whole-horizon series from the realized (T, N) offload matrix plus
    the dual series: per-slot admission over the whole matrix at once and
    the o/h/w accounting (table lookups, or the overlay streams plus the
    ``correct`` series).  ``topology`` switches admission per cloudlet
    (``t0`` locates this span in a time-varying map) and adds ``mu_k``;
    ``mu_seq`` may then be (T, K), and ``mu`` becomes its cloudlet mean."""
    if overlay is None:
        j = j_seq.long()
        o_seq, h_seq, w_seq = (tab[j] if tab.ndim == 1
                               else torch.gather(tab, 1, j.T).T
                               for tab in tables)
    else:
        o_seq, h_seq, w_seq = overlay.o, overlay.h, overlay.w
    off_f = off.float()
    if not enforce_slot_capacity:
        admitted = off
    elif topology is None:
        admitted = bl.admit_by_capacity(off, h_seq, params.H,
                                        smallest_first=smallest_first)
    else:  # with one cloudlet the association is irrelevant
        a_seq = (None if topology.K == 1
                 else topology.assoc_at(t0, off.shape[0]))
        admitted = bl.admit_by_capacity_topo(off, h_seq, a_seq,
                                             topology.H_k,
                                             smallest_first=smallest_first)
    adm_f = admitted.float()
    task_f = (j_seq > 0).float()
    series = {
        "reward": torch.sum(w_seq * adm_f, dim=1),
        "power": torch.sum(o_seq * off_f, dim=1),
        "power_per_dev": torch.mean(o_seq * off_f, dim=1),
        "load": torch.sum(h_seq * adm_f, dim=1),
        "offloads": torch.sum(off_f, dim=1),
        "admits": torch.sum(adm_f, dim=1),
        "tasks": torch.sum(task_f, dim=1),
        "lam_norm": lnorm,
    }
    if mu_seq.ndim == 2:  # (T, K) per-cloudlet duals
        series["mu_k"] = mu_seq
        series["mu"] = torch.mean(mu_seq, dim=-1)
    else:
        series["mu"] = mu_seq
        if topology is not None:
            series["mu_k"] = mu_seq[:, None].expand(mu_seq.shape[0],
                                                    topology.K)
    if overlay is not None:
        series["correct"] = torch.sum(
            torch.where(admitted, overlay.correct_cloud,
                        overlay.correct_local) * task_f, dim=1)
    return series


def _trivial_policy_rollout(j_seq, algo: str):
    """Offload matrix + (zero) dual series for the stateless policies."""
    task = j_seq > 0
    off = task if algo == "cloud" else torch.zeros_like(task)
    zeros = torch.zeros((j_seq.shape[0],), dtype=torch.float32,
                        device=j_seq.device)
    return off, zeros, zeros, bl.OCOSState()


def _overlay_slot_values(overlay: RawOverlay, params: OnAlgoParams):
    """The overlay's raw decision streams mapped to the dual space the
    kernels operate in (same diagonal preconditioner as onalgo.step)."""
    if not params.precondition:
        return (overlay.o, overlay.h, overlay.w)
    return (overlay.o / params.B[None, :], overlay.h / params.H, overlay.w)


def _onalgo_tail(state, j_tail, overlay_tail: Optional[RawOverlay],
                 tables, params: OnAlgoParams, rule: StepRule,
                 topo_k: Optional[Topology] = None, assoc_tail=None):
    """Finish a sub-chunk tail with the plain slot step.  ``topo_k`` (a
    K > 1 topology) switches to the K-vector duals; ``assoc_tail`` is its
    (Lt, N) association (None for a static map).  Returns (state, off
    (Lt, N) bool, mu_seq (Lt,) or (Lt, K), lam_norm (Lt,))."""
    offs, mus, norms = [], [], []
    for t in range(j_tail.shape[0]):
        j = j_tail[t]
        if overlay_tail is None:
            o_now, h_now, w_now = (_lookup(x, j) for x in tables)
        else:  # raw (unpreconditioned) values; step rescales them
            o_now = overlay_tail.o[t]
            h_now = overlay_tail.h[t]
            w_now = overlay_tail.w[t]
        topo_kw = {}
        if topo_k is not None:
            topo_kw = dict(assoc=(assoc_tail[t] if topo_k.time_varying
                                  else topo_k.assoc), H_k=topo_k.H_k)
        state, offload = onalgo.step(state, j, o_now, h_now, w_now, j > 0,
                                     tables, params, rule, **topo_kw)
        offs.append(offload)
        mus.append(state.mu)
        norms.append(torch.sqrt(torch.sum(state.lam**2)
                                + torch.sum(state.mu**2)))
    return state, torch.stack(offs), torch.stack(mus), torch.stack(norms)


def simulate_chunked(trace: Trace, tables, params: OnAlgoParams,
                     rule: StepRule, chunk: int = 8,
                     block_n: Optional[int] = None, algo: str = "onalgo",
                     overlay: Optional[RawOverlay] = None,
                     enforce_slot_capacity: bool = False,
                     topology: Optional[Topology] = None,
                     topo_binned: Optional[bool] = None, *, device=None):
    """OnAlgo rollout through the fused rollout kernels.

    Equivalent to ``simulate(..., algo="onalgo")`` (same series keys, same
    final state).  The first ``(T // chunk) * chunk`` slots run as one
    call of ``kernels.ops.onalgo_chunked`` (K1, ``block_n=None``) or
    ``onalgo_tiled`` (K2, ``block_n`` devices per tile); a tail of ``T mod
    chunk`` slots is finished by the plain slot step.  ``algo`` may also
    be the stateless ``local`` / ``cloud``.  ``enforce_slot_capacity``
    applies per-slot admission to the offload matrix afterwards.
    ``topology`` (K > 1) runs the kernels' K-vector forms (K1-topo /
    K2-topo): each device priced by its current cloudlet's dual, loads
    reduced per cloudlet; admission runs per cloudlet.  ``topo_binned``
    (None / True / False) names the reference's TPU reduction layout; on
    the card one kernel serves both, so every value gives the same run.
    ``device`` (None -> cuda): where the run happens; inputs are moved.
    """
    from repro_torch.kernels import ops as kops

    kops.check_topo_binned(topo_binned)
    dev = resolve_device(device)
    trace, tables, params = _on(dev, trace, tables, params)
    if overlay is not None:
        overlay = overlay.to(dev)
    o_tab, h_tab, w_tab = tables
    T, N = trace.j_idx.shape
    M = o_tab.shape[-1]
    j_seq = trace.j_idx
    topology, topo_k = _on_topology(topology, T, N, dev)

    if algo in ("local", "cloud"):
        off, mu_seq, lnorm, final = _trivial_policy_rollout(j_seq, algo)
        series = _series_from_offloads(j_seq, off, tables, params, mu_seq,
                                       lnorm, overlay,
                                       enforce_slot_capacity,
                                       topology=topology)
        return series, final
    if algo != "onalgo":
        raise ValueError("the chunked engine rolls OnAlgo (plus the "
                         f"stateless local/cloud policies); got {algo!r}")

    o_s, h_s, B_eff, H_eff = onalgo.precondition_tables(o_tab, h_tab,
                                                        params)
    slot_values = (None if overlay is None
                   else _overlay_slot_values(overlay, params))
    topo_kw = {}
    if topo_k is not None:
        topo_kw = dict(H_k=onalgo.precondition_capacities(topo_k.H_k, params),
                       topo_binned=topo_binned)

    T_main = (T // chunk) * chunk
    # fresh state buffers: the CUDA kernels update lam / counts in place
    lam = torch.zeros((N,), dtype=torch.float32, device=dev)
    mu = torch.zeros(() if topo_k is None else (topo_k.K,),
                     dtype=torch.float32, device=dev)
    counts = torch.zeros((N, M), dtype=torch.float32, device=dev)
    if T_main:
        kern = (kops.onalgo_chunked if block_n is None
                else partial(kops.onalgo_tiled, block_n=block_n))
        sv_main = (None if slot_values is None
                   else tuple(sv[:T_main] for sv in slot_values))
        if topo_k is not None:  # a static map stays (N,): read once
            topo_kw["assoc"] = (topo_k.assoc_at(0, T_main)
                                if topo_k.time_varying else topo_k.assoc)
        off, mu_seq, lnorm, lam, mu, counts = kern(
            j_seq[:T_main], lam, mu, counts, o_s, h_s, w_tab,
            B_eff, H_eff, rule.a, rule.beta, chunk=chunk,
            slot_values=sv_main, **topo_kw)
    else:  # whole horizon shorter than one chunk: the tail does it all
        off = torch.zeros((0, N), dtype=torch.bool, device=dev)
        mu_seq = torch.zeros((0,) if topo_k is None else (0, topo_k.K),
                             dtype=torch.float32, device=dev)
        lnorm = torch.zeros((0,), dtype=torch.float32, device=dev)

    if T_main < T:
        state = OnAlgoState(lam=lam, mu=mu,
                            rho=RhoEstimator(counts=counts, t=T_main))
        overlay_tail = (None if overlay is None
                        else overlay.slice(T_main, T))
        assoc_tail = (topo_k.assoc_at(T_main, T - T_main)
                      if topo_k is not None and topo_k.time_varying
                      else None)
        state, off_t, mu_t, ln_t = _onalgo_tail(
            state, j_seq[T_main:], overlay_tail, tables, params, rule,
            topo_k=topo_k, assoc_tail=assoc_tail)
        off = torch.cat([off, off_t], dim=0)
        mu_seq = torch.cat([mu_seq, mu_t])
        lnorm = torch.cat([lnorm, ln_t])
        lam, mu, counts = state.lam, state.mu, state.rho.counts

    series = _series_from_offloads(j_seq, off, tables, params, mu_seq,
                                   lnorm, overlay, enforce_slot_capacity,
                                   topology=topology)
    final = OnAlgoState(lam=lam, mu=mu,
                        rho=RhoEstimator(counts=counts, t=T))
    return series, final
