"""Fleet simulation: roll OnAlgo / baselines over a trace.

Port of the single-device engines of ``repro/core/fleet.py``:

  simulate          the slot loop (the reference's ``lax.scan``), any algo;
                    ``use_kernel`` routes each slot's policy + reductions
                    through the single-slot kernel (K3);
  simulate_chunked  the whole horizon through the fused rollout kernels:
                    K1 (``block_n=None``) or the device-tiled K2;
  simulate_chunked_stream
                    the same kernels over a STREAMED workload: slab by
                    slab from a ``source(t0, L)``, nothing of size (T, N)
                    held, no host sync inside the slab loop;
  simulate_sharded  the slot loop over a fleet sharded on a mesh axis
                    (torch.distributed, one process per shard): each rank
                    rolls its N/S devices and the ranks all-reduce one
                    (load, sum lam^2) vector a slot;
  simulate_sharded_stream
                    the same over a streamed workload, full-width slabs
                    from ``source`` or each rank's own columns from
                    ``source_cols``;
  autotune          picks (chunk, block_n[, slab]) by timing probes.

Each returns (series dict of (T,) tensors, final state) with the
reference's keys and accounting.  Each takes a multi-cloudlet
``topology`` (a streaming walk too): the capacity dual becomes a (K,)
vector (the series gain ``mu_k`` (T, K); ``mu`` becomes the cloudlet
mean) and admission runs per cloudlet; K = 1 runs the scalar path bit
for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
from functools import partial
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import baselines as bl
from repro_torch.core import onalgo
from repro_torch.core.collectives import (Shards, all_reduce, gather_cols,
                                          shards_of)
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
    # a streaming walk is materialized once: the slot loop reads each row
    assoc_all = (topo_k.assoc_at(0, T) if topo_k is not None
                 and topo_k.time_varying else None)
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
            assoc_now = (assoc_all[t] if topo_k.time_varying
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
                          t0: int = 0, a_seq=None):
    """Whole-horizon series from the realized (T, N) offload matrix plus
    the dual series: per-slot admission over the whole matrix at once and
    the o/h/w accounting (table lookups, or the overlay streams plus the
    ``correct`` series).  ``topology`` switches admission per cloudlet
    (``t0`` locates this span in a time-varying map; ``a_seq`` is that
    span when the caller already holds it) and adds ``mu_k``; ``mu_seq``
    may then be (T, K), and ``mu`` becomes its cloudlet mean."""
    if overlay is None:
        # held to the tables: a streamed walk's rollout flags a j out of
        # range and its run raises after the slab loop, so this gather
        # must not fault before (in range, j is unchanged)
        j = j_seq.clamp(0, tables[0].shape[-1] - 1).long()
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
        if topology.K == 1:
            a_seq = None
        elif a_seq is None:
            a_seq = topology.assoc_at(t0, off.shape[0])
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


@obs.spanned("engine")
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
        with obs.span("rollout"):
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
        with obs.span("rollout"):
            state, off_t, mu_t, ln_t = _onalgo_tail(
                state, j_seq[T_main:], overlay_tail, tables, params, rule,
                topo_k=topo_k, assoc_tail=assoc_tail)
        off = torch.cat([off, off_t], dim=0)
        mu_seq = torch.cat([mu_seq, mu_t])
        lnorm = torch.cat([lnorm, ln_t])
        lam, mu, counts = state.lam, state.mu, state.rho.counts

    with obs.span("series"):
        series = _series_from_offloads(j_seq, off, tables, params, mu_seq,
                                       lnorm, overlay, enforce_slot_capacity,
                                       topology=topology)
    final = OnAlgoState(lam=lam, mu=mu,
                        rho=RhoEstimator(counts=counts, t=T))
    return series, final


def _write_series(bufs: Optional[dict], part: dict, at: int,
                  length: int) -> dict:
    """Write one slab's series ``part`` into a streamed run's series
    buffers at slot offset ``at`` and return them; the first call
    allocates them, ``length`` slots keyed and shaped after ``part``
    (float32; ``mu_k`` (length, K)), so nothing is concatenated at the
    end."""
    if bufs is None:
        bufs = {k: torch.empty((length, *v.shape[1:]), dtype=torch.float32,
                               device=v.device) for k, v in part.items()}
    for k, buf in bufs.items():
        buf[at:at + part[k].shape[0]].copy_(part[k])
    return bufs


def _stream_trivial(source, T: int, N: int, slab: int, tables,
                    params: OnAlgoParams, algo: str,
                    enforce_slot_capacity: bool,
                    topology: Optional[Topology] = None, start: int = 0):
    """local / cloud policies over a streamed workload: stateless, so the
    rollout is just per-slab accounting."""
    bufs = None
    for t0 in range(start, T, slab):
        L = min(slab, T - t0)
        j_slab, overlay = source(t0, L)
        off, mu_seq, lnorm, final = _trivial_policy_rollout(j_slab, algo)
        bufs = _write_series(bufs, _series_from_offloads(
            j_slab, off, tables, params, mu_seq, lnorm, overlay,
            enforce_slot_capacity, topology=topology, t0=t0),
            t0 - start, T - start)
    return bufs, final


# Set to "error" (or "warn") to run the streaming engines' slab loops and
# the sharded engine's slot loop under torch.cuda.set_sync_debug_mode: a
# host synchronization inside the loop then raises (warns).  None leaves
# the mode alone.
SLAB_LOOP_SYNC_DEBUG = None


@contextlib.contextmanager
def _slab_loop_guard(dev):
    if SLAB_LOOP_SYNC_DEBUG is None or dev.type != "cuda":
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(SLAB_LOOP_SYNC_DEBUG)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


@obs.spanned("engine")
def simulate_chunked_stream(source, T: int, N: int, tables,
                            params: OnAlgoParams, rule: StepRule, *,
                            chunk: int = 16, slab: Optional[int] = None,
                            block_n: Optional[int] = None,
                            algo: str = "onalgo",
                            enforce_slot_capacity: bool = False,
                            topology: Optional[Topology] = None,
                            topo_binned: Optional[bool] = None,
                            pipelined: Optional[bool] = None,
                            t0: int = 0,
                            state0: Optional[OnAlgoState] = None,
                            device=None):
    """The chunked engine over a *streamed* workload: no (T, N) horizon.

    ``source(t0, length)`` yields slots [t0, t0 + length) of the workload
    as ``(j_slab (L, N) int32, overlay: RawOverlay | None)`` on the run's
    device, e.g. ``StreamingService.slab``.  The rollout walks the horizon
    ``slab`` slots at a time (default 16 * chunk; a multiple of
    ``chunk``): generate the slab, run the rollout kernel on it (K1, or K2
    with ``block_n``; K1-topo / K2-topo under a K > 1 ``topology``,
    static or a streaming walk), resuming at the slab's t0, fold its
    accounting, drop it.  Peak device memory is O(slab * N) + the (N, M)
    state, independent of T; only the O(T) series survive.  The tail,
    ``(T - t0) mod chunk`` slots, runs through the plain slot step, as in
    ``simulate_chunked``, so with the same ``chunk`` the two engines give
    the same decisions and duals.

    The per-call checks of the rollout wrappers (counts bound, step
    tables, the ranges of j and assoc) are made once per run
    (``onalgo_step.RolloutRun``): on a card the kernels flag a value out
    of range and hold it in range, and the run raises after the slab
    loop.

    The walk enqueues and never waits: the series buffers are allocated
    once and each slab's part is written in place at its offset; lam, mu
    and counts carry from slab to slab in the same buffers (the CUDA
    kernels update lam and counts in place); nothing inside the slab loop
    waits for the card, so slab t + 1 is enqueued while slab t runs
    (``SLAB_LOOP_SYNC_DEBUG`` proves it).  The reference has two walks
    with the same bits, a sequential one and a pipelined fused-jit slab
    step with its jit-cache device (``_StaticSource``); eager calls need
    neither, so ``pipelined`` is accepted for the reference's signature
    and changes nothing.

    ``t0`` / ``state0`` resume mid-horizon: slots [t0, T) are rolled from
    ``state0`` (an ``OnAlgoState`` with ``rho.t == t0``; it is copied, not
    updated) and the series cover those T - t0 slots.  ``algo`` may also
    be the stateless ``local`` / ``cloud``.  ``topo_binned`` as in
    ``simulate_chunked``.  ``device`` (None -> cuda): where the run
    happens.  Returns ``(series, final_state)``."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.onalgo_step import RolloutRun

    kops.check_topo_binned(topo_binned)
    dev = resolve_device(device)
    tables = tuple(t.to(dev) for t in tables)
    params = OnAlgoParams(B=params.B.to(dev), H=params.H.to(dev),
                          precondition=params.precondition)
    o_tab, h_tab, w_tab = tables
    M = o_tab.shape[-1]
    if slab is None:
        slab = chunk * 16
    if slab % chunk:
        raise ValueError(f"slab={slab} must be a multiple of chunk={chunk}")
    topology, topo_k = _on_topology(topology, T, N, dev)
    start = int(t0)
    if not 0 <= start < max(T, 1):
        raise ValueError(f"resume t0={start} outside horizon [0, {T})")

    if algo in ("local", "cloud"):
        return _stream_trivial(source, T, N, slab, tables, params, algo,
                               enforce_slot_capacity, topology=topology,
                               start=start)
    if algo != "onalgo":
        raise ValueError("the chunked streaming engine rolls OnAlgo (plus "
                         "the stateless local/cloud policies); got "
                         f"{algo!r}")

    if state0 is not None:
        if state0.rho.t != start:
            raise ValueError(f"state0.rho.t={state0.rho.t} != t0={start}")
        # copies: the CUDA kernels update lam and counts in place, and the
        # caller keeps its resume state
        lam = state0.lam.to(dev, torch.float32).clone()
        mu = state0.mu.to(dev, torch.float32).clone()
        counts = state0.rho.counts.to(dev, torch.float32).clone()
    else:
        lam = torch.zeros((N,), dtype=torch.float32, device=dev)
        mu = torch.zeros(() if topo_k is None else (topo_k.K,),
                         dtype=torch.float32, device=dev)
        counts = torch.zeros((N, M), dtype=torch.float32, device=dev)
    T_main = start + ((T - start) // chunk) * chunk
    o_s, h_s, B_eff, H_eff = onalgo.precondition_tables(o_tab, h_tab,
                                                        params)
    kern = (kops.onalgo_chunked if block_n is None
            else partial(kops.onalgo_tiled, block_n=block_n))
    topo_kw = {}
    if topo_k is not None:
        topo_kw = dict(H_k=onalgo.precondition_capacities(topo_k.H_k,
                                                          params),
                       topo_binned=topo_binned)
    run = (RolloutRun(counts, rule.a, rule.beta, start, T_main)
           if T_main > start else None)

    def slab_series(s0, L, bufs):
        """Roll slots [s0, s0 + L) from (lam, mu, counts) and write the
        slab's series into ``bufs``: (bufs, the state after it)."""
        j_slab, overlay = source(s0, L)
        sv = (None if overlay is None
              else _overlay_slot_values(overlay, params))
        a_seq, kw = None, topo_kw
        if topo_k is not None:  # a static map stays (N,)
            a_seq = topo_k.assoc_at(s0, L) if topo_k.time_varying else None
            kw = dict(topo_kw, assoc=topo_k.assoc if a_seq is None else a_seq)
        with obs.span("rollout"):
            off, mu_seq, lnorm, *state = kern(
                j_slab, lam, mu, counts, o_s, h_s, w_tab, B_eff, H_eff,
                rule.a, rule.beta, chunk=chunk, t0=s0, slot_values=sv,
                run=run, **kw)
        with obs.span("series"):
            part = _series_from_offloads(
                j_slab, off, tables, params, mu_seq, lnorm, overlay,
                enforce_slot_capacity, topology=topology, t0=s0,
                a_seq=a_seq)
            return _write_series(bufs, part, s0 - start, T - start), state

    bufs = None
    with _slab_loop_guard(dev):
        for s0 in range(start, T_main, slab):
            with obs.span("slab"):
                bufs, state = slab_series(s0, min(slab, T_main - s0), bufs)
            # carry the state in the same buffers (a no-op where a CUDA
            # kernel already updated them in place)
            for buf, new in zip((lam, mu, counts), state):
                if new.data_ptr() != buf.data_ptr():
                    buf.copy_(new)
    if run is not None:
        run.finish()

    if T_main < T:  # finish the tail with the plain slot step
        j_tail, overlay_t = source(T_main, T - T_main)
        state = OnAlgoState(lam=lam, mu=mu,
                            rho=RhoEstimator(counts=counts, t=T_main))
        assoc_tail = (topo_k.assoc_at(T_main, T - T_main)
                      if topo_k is not None and topo_k.time_varying
                      else None)
        with obs.span("rollout"):
            state, off_t, mu_t, ln_t = _onalgo_tail(
                state, j_tail, overlay_t, tables, params, rule,
                topo_k=topo_k, assoc_tail=assoc_tail)
        with obs.span("series"):
            bufs = _write_series(bufs, _series_from_offloads(
                j_tail, off_t, tables, params, mu_t, ln_t, overlay_t,
                enforce_slot_capacity, topology=topology, t0=T_main),
                T_main - start, T - start)
        lam, mu, counts = state.lam, state.mu, state.rho.counts
    final = OnAlgoState(lam=lam, mu=mu, rho=RhoEstimator(counts=counts, t=T))
    return bufs, final


def _validate_shards(N: int, shards: Shards, device_axis: str):
    if N % shards.count:
        raise ValueError(
            f"fleet size N={N} must be a multiple of the {device_axis!r} "
            f"axis shard count ({shards.count})")


def _shard_inputs(shards: Shards, N: int, tables, params: OnAlgoParams):
    """This shard's tables (per-device (N, M) rows cut, shared (M,) kept)
    and params (its budgets B; the capacity H stays global)."""
    cols = shards.cols(N)
    tables = tuple(t[cols] if t.ndim == 2 else t for t in tables)
    return tables, OnAlgoParams(B=params.B[cols], H=params.H,
                                precondition=params.precondition)


def _sharded_slot(state: OnAlgoState, j, values, tables,
                  params: OnAlgoParams, rule: StepRule, shards: Shards,
                  assoc=None, H_k=None):
    """One slot of one shard, shared by the sharded engines so that their
    slot dynamics cannot part: the shard's policy and lam ascent
    (``onalgo.local_step``), then ONE all-reduce of the vector (load,
    sum lam^2) — the load () or (K,) for mu's ascent, sum lam^2 for the
    dual norm; the reference psums the two apart.  ``values`` is the
    overlay's raw (o, h, w) of the slot or None (table lookups).  Returns
    (state, offload, lam_norm)."""
    if values is None:
        values = tuple(_lookup(x, j) for x in tables)
    lam, rho, offload, load, cap, a_t = onalgo.local_step(
        state, j, *values, j > 0, tables, params, rule, assoc=assoc,
        H_k=H_k)
    both = all_reduce(torch.cat([load.reshape(-1),
                                 torch.sum(lam**2).reshape(1)]),
                      shards.group)
    mu = onalgo.ascend_capacity(state.mu, both[:-1].reshape(state.mu.shape),
                                cap, a_t)
    lam_norm = torch.sqrt(both[-1] + torch.sum(mu**2))
    return OnAlgoState(lam=lam, mu=mu, rho=rho), offload, lam_norm


def _sharded_run(state: OnAlgoState, j_seq, values, tables,
                 params: OnAlgoParams, rule: StepRule, shards: Shards,
                 assoc=None, H_k=None):
    """Roll a shard's (L, N/S) slots from ``state`` (the reference's
    resumable shard_map scan): ``values`` the overlay's (o, h, w) columns
    or None; ``assoc`` the shard's (N/S,) map or its (L, N/S) span.
    Returns (state, off (L, N/S) bool, mu_seq (L,) or (L, K), lam_norm
    (L,))."""
    offs, mus, norms = [], [], []
    for t in range(j_seq.shape[0]):
        v_t = None if values is None else tuple(x[t] for x in values)
        assoc_t = assoc if assoc is None or assoc.ndim == 1 else assoc[t]
        state, off, lam_norm = _sharded_slot(state, j_seq[t], v_t, tables,
                                             params, rule, shards,
                                             assoc=assoc_t, H_k=H_k)
        offs.append(off)
        mus.append(state.mu)
        norms.append(lam_norm)
    if not offs:
        dev = j_seq.device
        return (state, torch.zeros(j_seq.shape, dtype=torch.bool, device=dev),
                torch.zeros((0, *state.mu.shape), device=dev),
                torch.zeros((0,), device=dev))
    return state, torch.stack(offs), torch.stack(mus), torch.stack(norms)


def _gathered_state(state: OnAlgoState, shards: Shards, t: int):
    """The final state with lam (N,) and counts (N, M) gathered."""
    return OnAlgoState(lam=gather_cols(state.lam, shards), mu=state.mu,
                       rho=RhoEstimator(counts=gather_cols(
                           state.rho.counts, shards, dim=0), t=t))


def simulate_sharded(trace: Trace, tables, params: OnAlgoParams,
                     rule: StepRule, mesh, device_axis: str = "data",
                     algo: str = "onalgo",
                     overlay: Optional[RawOverlay] = None,
                     enforce_slot_capacity: bool = False,
                     topology: Optional[Topology] = None, *, device=None):
    """OnAlgo over a fleet sharded on a mesh axis, SPMD.

    Every rank of ``mesh`` (a ``DeviceMesh`` on the run's device type;
    ``launch.mesh`` builds one) calls this with the same global inputs.
    The devices (the N axis) are split over the ``device_axis`` shards;
    each rank runs the device-local threshold rule and lam updates for its
    N/S devices, and the capacity load is all-reduced over the axis: one
    collective a slot, the paper's protocol cost, carrying (load, sum
    lam^2), so the dual norm costs nothing more.  Under a multi-cloudlet
    ``topology`` the load is each shard's (K,) segment partials (the
    association may cross shard boundaries).  Ranks along other mesh
    axes compute the same shard again.

    Same ``(series, final_state)`` contract as ``simulate`` /
    ``simulate_chunked``: the realized (T, N/S) offloads, lam and the
    counts are gathered, and the accounting (the admission post-pass, the
    overlay's ``correct`` series) runs on every rank on the global arrays,
    so every rank returns the same result and the engines' metrics agree.
    ``algo``: ``onalgo``, or the stateless ``local`` / ``cloud`` (no
    collective).  ``device`` (None -> cuda): where the run happens.
    """
    dev = resolve_device(device)
    trace, tables, params = _on(dev, trace, tables, params)
    if overlay is not None:
        overlay = overlay.to(dev)
    T, N = trace.j_idx.shape
    M = tables[0].shape[-1]
    topology, topo_k = _on_topology(topology, T, N, dev)
    if topo_k is not None:
        topo_k = topo_k.prefix(T)  # the sharded loop consumes T rows

    if algo in ("local", "cloud"):  # stateless: nothing to distribute
        off, mu_seq, lnorm, final = _trivial_policy_rollout(trace.j_idx,
                                                            algo)
        series = _series_from_offloads(trace.j_idx, off, tables, params,
                                       mu_seq, lnorm, overlay,
                                       enforce_slot_capacity,
                                       topology=topology)
        return series, final
    if algo != "onalgo":
        raise ValueError("the sharded engine rolls OnAlgo (plus the "
                         f"stateless local/cloud policies); got {algo!r}")

    shards = shards_of(mesh, device_axis, dev)
    _validate_shards(N, shards, device_axis)
    cols = shards.cols(N)
    tables_l, params_l = _shard_inputs(shards, N, tables, params)
    values = (None if overlay is None
              else tuple(x[:, cols] for x in (overlay.o, overlay.h,
                                              overlay.w)))
    topo_kw = {}
    if topo_k is not None:
        assoc = (topo_k.assoc_at(0, T)[:, cols] if topo_k.time_varying
                 else topo_k.assoc[cols])
        topo_kw = dict(assoc=assoc, H_k=topo_k.H_k)
    state = onalgo.init_state(cols.stop - cols.start, M,
                              None if topo_k is None else topo_k.K,
                              device=dev)
    with _slab_loop_guard(dev):
        state, off, mu_seq, lnorm = _sharded_run(
            state, trace.j_idx[:, cols], values, tables_l, params_l, rule,
            shards, **topo_kw)
    off = gather_cols(off, shards)
    series = _series_from_offloads(trace.j_idx, off, tables, params, mu_seq,
                                   lnorm, overlay, enforce_slot_capacity,
                                   topology=topology)
    return series, _gathered_state(state, shards, T)


def _gather_slab(off, j, overlay: Optional[RawOverlay], shards: Shards):
    """A shard-local slab's offloads, state indices and overlay streams
    gathered to full width in ONE all-gather (their 32-bit patterns
    stacked as int32).  Returns (off (L, N), j (L, N), overlay)."""
    rows = [off.to(torch.int32), j.to(torch.int32)]
    if overlay is not None:
        rows += [getattr(overlay, f.name).float().view(torch.int32)
                 for f in dataclasses.fields(overlay)]
    full = gather_cols(torch.stack(rows), shards)
    ov = (None if overlay is None
          else RawOverlay(*full[2:].view(torch.float32).unbind(0)))
    return full[0].bool(), full[1], ov


def simulate_sharded_stream(source, T: int, N: int, tables,
                            params: OnAlgoParams, rule: StepRule, mesh,
                            device_axis: str = "data", *,
                            slab: Optional[int] = None,
                            algo: str = "onalgo",
                            enforce_slot_capacity: bool = False,
                            topology: Optional[Topology] = None,
                            source_cols=None,
                            pipelined: Optional[bool] = None,
                            device=None):
    """The sharded engine over a *streamed* workload: no (T, N) horizon.

    The horizon is walked ``slab`` slots at a time (default 256), each
    slab rolled from the carried shard state by ``simulate_sharded``'s
    slot loop and folded into the series buffers before the next one is
    generated; peak memory is O(slab * N) whatever T.  ``source(t0, L)``
    yields the full-width slab ``(j (L, N), RawOverlay | None)`` and each
    rank takes its columns.  ``source_cols(t0, L, n0, n_cols)`` — the
    column form, e.g. ``StreamingService.slab_cols`` — has each rank draw
    only its own columns (``n0 = shard index * N / S``), bit for bit the
    same columns, so generation is O(slab * N / S) a rank; the slab's
    offloads, state indices and overlay are then gathered in one
    all-gather for the accounting.  ``source`` still serves the stateless
    ``local`` / ``cloud`` policies.

    Nothing in the slab loop waits for the card (``SLAB_LOOP_SYNC_DEBUG``
    checks it); so ``pipelined``, the reference's choice between two walks
    with the same bits, is accepted and changes nothing, as in
    ``simulate_chunked_stream``.  ``device`` (None -> cuda)."""
    dev = resolve_device(device)
    tables = tuple(t.to(dev) for t in tables)
    params = OnAlgoParams(B=params.B.to(dev), H=params.H.to(dev),
                          precondition=params.precondition)
    M = tables[0].shape[-1]
    shards = shards_of(mesh, device_axis, dev)
    _validate_shards(N, shards, device_axis)
    if slab is None:
        slab = 256
    topology, topo_k = _on_topology(topology, T, N, dev)

    if algo in ("local", "cloud"):
        return _stream_trivial(source, T, N, slab, tables, params, algo,
                               enforce_slot_capacity, topology=topology)
    if algo != "onalgo":
        raise ValueError("the sharded streaming engine rolls OnAlgo (plus "
                         "the stateless local/cloud policies); got "
                         f"{algo!r}")

    cols = shards.cols(N)
    tables_l, params_l = _shard_inputs(shards, N, tables, params)
    state = onalgo.init_state(cols.stop - cols.start, M,
                              None if topo_k is None else topo_k.K,
                              device=dev)
    bufs = None
    with _slab_loop_guard(dev):
        for t0 in range(0, T, slab):
            L = min(slab, T - t0)
            if source_cols is None:
                j_slab, overlay = source(t0, L)
                j_l = j_slab[:, cols]
                ov_l = (None if overlay is None
                        else RawOverlay(*(getattr(overlay, f.name)[:, cols]
                                          for f in dataclasses.fields(
                                              overlay))))
            else:
                j_l, ov_l = source_cols(t0, L, cols.start,
                                        cols.stop - cols.start)
            a_seq, topo_kw = None, {}
            if topo_k is not None:
                a_seq = topo_k.assoc_at(t0, L) if topo_k.time_varying else None
                topo_kw = dict(assoc=(topo_k.assoc[cols] if a_seq is None
                                      else a_seq[:, cols]), H_k=topo_k.H_k)
            values = (None if ov_l is None
                      else (ov_l.o, ov_l.h, ov_l.w))
            state, off, mu_seq, lnorm = _sharded_run(
                state, j_l, values, tables_l, params_l, rule, shards,
                **topo_kw)
            if source_cols is None:
                off = gather_cols(off, shards)
            else:
                off, j_slab, overlay = _gather_slab(off, j_l, ov_l, shards)
            bufs = _write_series(bufs, _series_from_offloads(
                j_slab, off, tables, params, mu_seq, lnorm, overlay,
                enforce_slot_capacity, topology=topology, t0=t0,
                a_seq=a_seq), t0, T)
    return bufs, _gathered_state(state, shards, T)


@dataclasses.dataclass
class AutotuneResult:
    """The winning chunked-engine configuration and the probe timings."""

    chunk: int
    block_n: Optional[int]
    seconds: float  # best probe wall-time
    timings: dict  # (chunk, block_n[, topo_binned][, slab]) -> seconds
    topology: Optional[Topology] = None  # the topology the probes ran with
    topo_binned: Optional[bool] = None  # winning reduction layout (topo)
    slab: Optional[int] = None  # winning slab length (slabs= probed)

    @property
    def kwargs(self) -> dict:
        """Ready to splat into simulate_chunked / simulate_service: the
        probes' topology and winning ``topo_binned`` ride along when a
        topology was probed, the winning ``slab`` when ``slabs=`` joined
        the search."""
        kw = {"chunk": self.chunk, "block_n": self.block_n}
        if self.topology is not None:
            kw["topology"] = self.topology
            kw["topo_binned"] = self.topo_binned
        if self.slab is not None:
            kw["slab"] = self.slab
        return kw


def autotune(tables, params: OnAlgoParams, rule: StepRule, *,
             trace: Optional[Trace] = None,
             overlay: Optional[RawOverlay] = None,
             source=None, T: Optional[int] = None, N: Optional[int] = None,
             chunks=(8, 16, 32), block_ns=(None,),
             probe_slots: int = 128, slab: Optional[int] = None,
             slabs=(None,), pipelined: Optional[bool] = None,
             algo: str = "onalgo", enforce_slot_capacity: bool = False,
             repeats: int = 2, warmup: int = 1,
             topology: Optional[Topology] = None,
             topo_binned_opts=None, device=None) -> AutotuneResult:
    """Pick (chunk, block_n) for the chunked engines by timing probes.

    Runs a short rollout (the first ``probe_slots`` slots) for every
    candidate in ``chunks`` x ``block_ns`` and returns the fastest by
    wall time: each candidate runs ``warmup`` untimed calls (first-call
    builds do not vote) before its ``repeats`` timed ones, each timing
    ending in ``torch.cuda.synchronize()`` on a card.  Probe either a
    materialized ``trace`` (+ optional ``overlay``) or a streaming
    ``source`` with its ``(T, N)``; candidates with ``chunk >
    probe_slots`` are skipped.

    ``topology`` runs the probes with the K-vector duals and rides along
    in the result.  ``topo_binned_opts`` adds the reference's reduction
    layout to the grid (None: both layouts when K > 128, as the reference
    probes them); the keys keep the reference's form, but on the card one
    kernel serves both layouts, so they time the same program.  ``slabs``
    adds the streaming slab length to the grid (source probes only; keys
    grow a trailing slab element); ``pipelined`` is accepted for the
    reference's signature and changes nothing (``simulate_chunked_stream``
    has one walk).  ``device`` (None -> cuda): where the probes run.
    """
    import time

    dev = resolve_device(device)
    if (trace is None) == (source is None):
        raise ValueError("autotune needs exactly one of trace= or source=")
    probe_slab_grid = tuple(slabs) != (None,)
    if trace is not None:
        probe_T = min(trace.T, probe_slots)
        p_trace = Trace(j_idx=trace.j_idx[:probe_T],
                        d_local=trace.d_local[:probe_T])
        p_overlay = None if overlay is None else overlay.slice(0, probe_T)
        p_topo = None if topology is None else topology.prefix(probe_T)
        if probe_slab_grid:
            raise ValueError("slabs= probes the streaming engine; pass "
                             "source= (trace probes have no slab)")

        def probe(chunk, block_n, tb, slab_c):
            return simulate_chunked(p_trace, tables, params, rule,
                                    chunk=chunk, block_n=block_n, algo=algo,
                                    overlay=p_overlay,
                                    enforce_slot_capacity=(
                                        enforce_slot_capacity),
                                    topology=p_topo, topo_binned=tb,
                                    device=dev)
    else:
        if T is None or N is None:
            raise ValueError("autotune(source=...) needs T= and N=")
        probe_T = min(T, probe_slots)
        p_topo = None if topology is None else topology.prefix(probe_T)

        def probe(chunk, block_n, tb, slab_c):
            return simulate_chunked_stream(
                source, probe_T, N, tables, params, rule, chunk=chunk,
                slab=slab if slab_c is None else slab_c,
                block_n=block_n, algo=algo,
                enforce_slot_capacity=enforce_slot_capacity,
                topology=p_topo, topo_binned=tb,
                device=dev)

    if repeats < 1 or warmup < 0:
        raise ValueError(f"need repeats >= 1 (got {repeats}) and "
                         f"warmup >= 0 (got {warmup})")
    if topo_binned_opts is None:
        topo_binned_opts = ((False, True)
                            if topology is not None and topology.K > 128
                            else (None,))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    timings = {}
    for chunk in chunks:
        if chunk > probe_T:
            continue
        for block_n in block_ns:
            for tb in topo_binned_opts:
                for slab_c in slabs:
                    if slab_c is not None and slab_c % chunk:
                        continue  # engine requires slab % chunk == 0
                    key = ((chunk, block_n) if tb is None
                           else (chunk, block_n, tb))
                    if probe_slab_grid:
                        key = key + (slab_c,)
                    for _ in range(warmup):  # builds don't vote
                        probe(chunk, block_n, tb, slab_c)
                    sync()
                    best = float("inf")
                    for _ in range(repeats):
                        t_start = time.perf_counter()
                        probe(chunk, block_n, tb, slab_c)
                        sync()
                        best = min(best, time.perf_counter() - t_start)
                    timings[key] = best
    if not timings:
        raise ValueError(
            f"no viable candidates: chunks={chunks} all exceed the probe "
            f"horizon ({probe_T} slots)")
    best_key, seconds = min(timings.items(), key=lambda kv: kv[1])
    chunk, block_n = best_key[0], best_key[1]
    slab_win = best_key[-1] if probe_slab_grid else None
    mid = best_key[2:-1] if probe_slab_grid else best_key[2:]
    tb_win = mid[0] if mid else None
    return AutotuneResult(chunk=chunk, block_n=block_n, seconds=seconds,
                          timings=timings, topology=topology,
                          topo_binned=tb_win, slab=slab_win)
