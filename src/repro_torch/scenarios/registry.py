"""Scenario generator registry (port of ``repro/scenarios/registry.py``).

Each generator is a function ``(Scenario, *, device) -> CompiledScenario``
registered under its ``kind``.  The generators draw on the host (numpy
RNG, as ``data.traces`` does, so a seed gives the reference's scenario
exactly) and move the result to ``device``; ``bursty_counter`` takes its
arrivals from the workload layer's counter streams and the topology kinds
build the port's ``Topology``, both on ``device``.

Kinds that act as transforms of a compiled scenario (churn masks activity
windows, outage mirrors the state space, ...) are also registered as
modifiers, ``(Scenario, CompiledScenario) -> CompiledScenario`` on the
base's device, which ``spec.compose`` layers onto any base kind.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch.core.fleet import Trace
from repro_torch.data.traces import TraceSpec, bursty_trace, iid_trace, \
    w_table
from repro_torch.device import resolve_device
from repro_torch.scenarios.spec import CompiledScenario, Scenario, \
    scenario_space

SCENARIO_KINDS: Dict[str, Callable[..., CompiledScenario]] = {}
MODIFIERS: Dict[
    str, Callable[[Scenario, CompiledScenario], CompiledScenario]] = {}


def register(kind: str):
    """Register ``fn(sc, *, device) -> CompiledScenario`` as ``kind``."""
    def deco(fn):
        SCENARIO_KINDS[kind] = fn
        return fn
    return deco


def register_modifier(kind: str):
    """Register ``fn(sc, base) -> CompiledScenario`` as modifier ``kind``."""
    def deco(fn):
        MODIFIERS[kind] = fn
        return fn
    return deco


def names() -> List[str]:
    return sorted(SCENARIO_KINDS)


def compile_scenario(sc: Scenario, *, device=None) -> CompiledScenario:
    """Compile ``sc`` on ``device`` (None -> cuda)."""
    if sc.kind not in SCENARIO_KINDS:
        raise KeyError(f"unknown scenario kind {sc.kind!r}; "
                       f"registered: {names()}")
    return SCENARIO_KINDS[sc.kind](sc, device=resolve_device(device))


def default_scenarios() -> List[Scenario]:
    """One representative spec per registered kind (tests / benches)."""
    base = dict(T=2000, N=8, seed=0)
    return [
        Scenario("stationary", **base),
        Scenario("bursty", **base),
        Scenario("bursty_counter", **base),
        Scenario("diurnal", **base).with_extra(period=500, amp=0.8),
        Scenario("churn", **base).with_extra(churn_frac=0.4),
        Scenario("flash_crowd", **base).with_extra(n_events=3,
                                                   event_len=60),
        Scenario("heterogeneous", **base).with_extra(o_spread=0.5),
        Scenario("outage", **base).with_extra(n_outages=2, outage_len=200),
        Scenario("churn_outage", **base).with_extra(
            churn_frac=0.3, n_outages=2, outage_len=150),
        Scenario("mobility", **base).with_extra(K=4, p_handover=0.05),
        Scenario("hotspot", **base).with_extra(K=4, hot_frac=0.6),
        Scenario("cloudlet_outage", **base).with_extra(
            K=4, n_outages=2, outage_len=150),
    ]


def _dloc(rng, w_vals, noise=0.08):
    d = 1.0 - w_vals + rng.normal(0, noise, size=w_vals.shape)
    return np.clip(d, 0.0, 1.0)


def _trace_spec(sc: Scenario) -> TraceSpec:
    return TraceSpec(T=sc.T, N=sc.N, task_prob=sc.task_prob, seed=sc.seed)


def _trace(j, d, device) -> Trace:
    """A Trace on ``device`` from host (T, N) arrays."""
    return Trace(j_idx=torch.tensor(j, dtype=torch.int32, device=device),
                 d_local=torch.tensor(d, dtype=torch.float32, device=device))


def _host(trace: Trace):
    """(j, d_local) of a trace as numpy arrays."""
    return trace.j_idx.cpu().numpy(), trace.d_local.cpu().numpy()


def _compiled(sc, space, trace, device, **kw) -> CompiledScenario:
    return CompiledScenario(sc, trace, space.tables(device),
                            sc.params(device=device), **kw)


def _windows(rng, T: int, length: int, count: int):
    """(sorted window starts, (T,) bool mask) of ``count`` windows of
    ``length`` slots."""
    starts = np.sort(rng.integers(0, max(T - length, 1), count))
    mask = np.zeros(T, bool)
    for s in starts:
        mask[s:s + length] = True
    return starts, mask


@register("stationary")
def _stationary(sc: Scenario, *, device) -> CompiledScenario:
    """IID traffic: the paper's baseline regime, exact true rho."""
    space = scenario_space(sc)
    trace, rho = iid_trace(space, _trace_spec(sc), device=device)
    return _compiled(sc, space, trace, device, true_rho=rho)


@register("bursty")
def _bursty(sc: Scenario, *, device) -> CompiledScenario:
    """Markov-modulated ON/OFF bursts (paper Sec. VI evaluation traffic)."""
    space = scenario_space(sc)
    trace, rho = bursty_trace(space, _trace_spec(sc), device=device)
    return _compiled(sc, space, trace, device, true_rho=rho,
                     meta={"rho_is_approx": True})


@register("bursty_counter")
def _bursty_counter(sc: Scenario, *, device) -> CompiledScenario:
    """Bursty arrivals from the workload layer's counter-based Markov
    ON/OFF chain (the service tier's: stationary start, burst / gap means
    matched to the renewal process), states iid categorical as in
    ``stationary``; the chain starts at its stationary law, so the per-slot
    marginal rho is exact (the process is non-iid: ``rho_is_approx``)."""
    from repro_torch.workload import streams

    space = scenario_space(sc)
    burst_len = tuple(sc.opt("burst_len", (5, 10)))
    mean_gap = float(sc.opt("mean_gap", 8.0))
    T, N = sc.T, sc.N
    # workload.arrival_chain_probs' means, in float64 here: the reference
    # takes them from a Python float mean_gap (the service tier traces it
    # as float32), and the chain compares in float32 either way
    mean_on = max((burst_len[0] + burst_len[1]) / 2.0, 1.0)
    mean_off = 1.0 + mean_gap
    p_on, p_stay = 1.0 / mean_off, 1.0 - 1.0 / mean_on
    p_init = mean_on / (mean_on + mean_off)
    u = streams.uniform_block(sc.seed, streams.STREAM_SCENARIO, T, N, 1,
                              device=device)
    u0 = streams.uniform(
        streams.stream_key(sc.seed, streams.STREAM_ARRIVAL_INIT), (N,),
        device=device)
    on = streams.markov_chain(u[0], u0 < p_init, p_on, p_stay).cpu().numpy()

    rng = np.random.default_rng(sc.seed)
    Lo, Lh, Lw = space.num_levels
    # the Dirichlet level priors of data.traces' generators
    probs = [rng.dirichlet(np.full(L, 3.0)) for L in (Lo, Lh, Lw)]
    io = rng.choice(Lo, size=(T, N), p=probs[0])
    ih = rng.choice(Lh, size=(T, N), p=probs[1])
    iw = rng.choice(Lw, size=(T, N), p=probs[2])
    j = np.where(on, np.asarray(space.encode(io, ih, iw)), 0)
    trace = _trace(j, _dloc(rng, w_table(space)[j]), device)
    joint = (probs[0][:, None, None] * probs[1][None, :, None]
             * probs[2][None, None, :])
    rho_row = np.concatenate([[1.0 - p_init], p_init * joint.reshape(-1)])
    rho = torch.tensor(np.broadcast_to(rho_row, (N, space.M)).astype(
        np.float32), device=device)
    return _compiled(sc, space, trace, device, true_rho=rho,
                     meta={"rho_is_approx": True,
                           "arrival_rng": "counter_v1"})


@register("diurnal")
def _diurnal(sc: Scenario, *, device) -> CompiledScenario:
    """Sinusoidal day cycle: task rate and gain distribution co-vary
    (sparse, low-gain nights; dense, high-gain days): the time-varying-rho
    regime of OnAlgo's Azuma-style analysis."""
    period = int(sc.opt("period", max(sc.T // 4, 2)))
    amp = float(sc.opt("amp", 0.8))
    space = scenario_space(sc)
    rng = np.random.default_rng(sc.seed)
    Lo, Lh, Lw = space.num_levels
    T, N = sc.T, sc.N

    phase = 2 * np.pi * np.arange(T) / period
    day = 0.5 * (1.0 + np.sin(phase))  # (T,) in [0, 1]
    p_task_t = np.clip(sc.task_prob * (1.0 - amp + 2 * amp * day), 0.0, 0.98)

    bias = np.linspace(2.0, 0.5, Lw)
    p_night = bias / bias.sum()
    p_day = bias[::-1] / bias.sum()
    p_w_t = (1 - day)[:, None] * p_night + day[:, None] * p_day  # (T, Lw)

    io = rng.integers(0, Lo, size=(T, N))
    ih = rng.integers(0, Lh, size=(T, N))
    cdf = np.cumsum(p_w_t, axis=1)  # (T, Lw)
    u = rng.random((T, N))
    iw = np.clip((u[:, :, None] > cdf[:, None, :]).sum(-1), 0, Lw - 1)
    j = np.asarray(space.encode(io, ih, iw))
    task = rng.random((T, N)) < p_task_t[:, None]
    j = np.where(task, j, 0)
    trace = _trace(j, _dloc(rng, w_table(space)[j]), device)
    return _compiled(sc, space, trace, device,
                     meta={"period": period, "amp": amp})


@register_modifier("churn")
def _mod_churn(sc: Scenario, base: CompiledScenario) -> CompiledScenario:
    """Mask device activity windows onto a compiled scenario: device n is
    present in [arrive[n], depart[n]) and sits in the null state outside
    it (no tasks, nothing in the constraints).  Drops any true_rho."""
    churn_frac = float(sc.opt("churn_frac", 0.4))
    rng = np.random.default_rng(sc.seed + 1)
    j, d = _host(base.trace)
    T, N = j.shape
    span = max(int(T * churn_frac), 1)
    arrive = rng.integers(0, span, N)
    depart = T - rng.integers(0, span, N)
    slots = np.arange(T)[:, None]
    active = (slots >= arrive[None, :]) & (slots < depart[None, :])
    trace = _trace(np.where(active, j, 0), np.where(active, d, 0.0),
                   base.device)
    meta = dict(base.meta, arrive=arrive, depart=depart)
    return CompiledScenario(base.scenario, trace, base.tables, base.params,
                            meta=meta, topology=base.topology)


@register("churn")
def _churn(sc: Scenario, *, device) -> CompiledScenario:
    """Device arrivals/departures over IID traffic (see ``_mod_churn``)."""
    space = scenario_space(sc)
    trace, _ = iid_trace(space, _trace_spec(sc), device=device)
    return _mod_churn(sc, _compiled(sc, space, trace, device))


@register("flash_crowd")
def _flash_crowd(sc: Scenario, *, device) -> CompiledScenario:
    """Flash-crowd bursts: short windows where nearly every device has a
    task and gains skew high (everyone films the same event)."""
    n_events = int(sc.opt("n_events", 3))
    event_len = int(sc.opt("event_len", 60))
    peak_prob = float(sc.opt("peak_prob", 0.97))
    space = scenario_space(sc)
    trace, _ = iid_trace(space, _trace_spec(sc), device=device)
    rng = np.random.default_rng(sc.seed + 2)
    Lo, Lh, Lw = space.num_levels
    T, N = sc.T, sc.N
    starts, in_event = _windows(rng, T, event_len, n_events)

    # event slots resampled: dense traffic, high-gain-biased levels
    bias = np.linspace(0.5, 2.0, Lw)
    p_hi = bias / bias.sum()
    io = rng.integers(0, Lo, size=(T, N))
    ih = rng.integers(0, Lh, size=(T, N))
    iw = rng.choice(Lw, size=(T, N), p=p_hi)
    j_event = np.asarray(space.encode(io, ih, iw))
    task_event = rng.random((T, N)) < peak_prob
    j_event = np.where(task_event, j_event, 0)

    j = np.where(in_event[:, None], j_event, _host(trace)[0])
    trace = _trace(j, _dloc(rng, w_table(space)[j]), device)
    return _compiled(sc, space, trace, device,
                     meta={"event_starts": starts, "event_len": event_len})


@register("heterogeneous")
def _heterogeneous(sc: Scenario, *, device) -> CompiledScenario:
    """Heterogeneous fleet with per-device (N, M) tables: a lognormal
    distance-dependent power multiplier per device (paper Fig. 2b) and a
    device-specific gain scale; true_rho stays exact (the state index
    process is unchanged)."""
    o_spread = float(sc.opt("o_spread", 0.5))
    w_spread = float(sc.opt("w_spread", 0.25))
    space = scenario_space(sc)
    trace, rho = iid_trace(space, _trace_spec(sc), device=device)
    rng = np.random.default_rng(sc.seed + 3)
    N = sc.N
    o_tab, h_tab, w_tab = space.tables(device)
    o_scale = rng.lognormal(0.0, o_spread, N).astype(np.float32)
    w_scale = np.clip(rng.normal(1.0, w_spread, N), 0.3, 1.7)
    o_nm = torch.tensor(o_scale, device=device)[:, None] * o_tab[None, :]
    w_nm = (torch.tensor(w_scale, dtype=torch.float32, device=device)[:, None]
            * w_tab[None, :])
    h_nm = h_tab.expand(N, space.M).contiguous()
    return CompiledScenario(sc, trace, (o_nm, h_nm, w_nm),
                            sc.params(device=device), true_rho=rho,
                            meta={"o_scale": o_scale, "w_scale": w_scale})


@register_modifier("diurnal")
def _mod_diurnal(sc: Scenario, base: CompiledScenario) -> CompiledScenario:
    """Thin a compiled scenario's traffic on a sinusoidal day cycle: slot t
    keeps each task w.p. (1 - amp) + amp * day(t).  It acts on the task
    mask only, so any table layout is kept.  Drops any true_rho."""
    period = int(sc.opt("period", max(sc.T // 4, 2)))
    amp = float(sc.opt("amp", 0.8))
    rng = np.random.default_rng(sc.seed + 5)
    j, d = _host(base.trace)
    T, N = j.shape
    day = 0.5 * (1.0 + np.sin(2 * np.pi * np.arange(T) / period))
    keep_p = (1.0 - amp) + amp * day  # (T,) in [1 - amp, 1]
    keep = rng.random((T, N)) < keep_p[:, None]
    trace = _trace(np.where(keep, j, 0), np.where(keep, d, 0.0),
                   base.device)
    meta = dict(base.meta, period=period, amp=amp)
    return CompiledScenario(base.scenario, trace, base.tables, base.params,
                            meta=meta, topology=base.topology)


@register_modifier("flash_crowd")
def _mod_flash_crowd(sc: Scenario, base: CompiledScenario
                     ) -> CompiledScenario:
    """Densify a compiled scenario during flash-crowd windows: each idle
    device draws a task w.p. ``peak_prob`` by resampling one of its OWN
    realized non-null states (any table layout is kept); a device with no
    task in the base trace stays silent.  Drops any true_rho."""
    n_events = int(sc.opt("n_events", 3))
    event_len = int(sc.opt("event_len", 60))
    peak_prob = float(sc.opt("peak_prob", 0.97))
    rng = np.random.default_rng(sc.seed + 6)
    j, d = (x.copy() for x in _host(base.trace))
    T, N = j.shape
    starts, in_event = _windows(rng, T, event_len, n_events)

    fill = in_event[:, None] & (j == 0) & (rng.random((T, N)) < peak_prob)
    for n in range(N):
        busy = np.flatnonzero(j[:, n] > 0)
        slots = np.flatnonzero(fill[:, n])
        if busy.size == 0 or slots.size == 0:
            continue
        donors = busy[rng.integers(0, busy.size, slots.size)]
        j[slots, n] = j[donors, n]
        d[slots, n] = d[donors, n]
    meta = dict(base.meta, event_starts=starts, event_len=event_len)
    return CompiledScenario(base.scenario, _trace(j, d, base.device),
                            base.tables, base.params, meta=meta,
                            topology=base.topology)


@register_modifier("outage")
def _mod_outage(sc: Scenario, base: CompiledScenario) -> CompiledScenario:
    """Mirror w = 0 down-states onto a compiled scenario: states [M, 2M)
    copy (o, h) with zero gain, and during an outage window every task
    state j becomes j + M, so the threshold rule (w > 0) never offloads
    while rho tracks the full process.  Both table layouts are kept."""
    n_outages = int(sc.opt("n_outages", 2))
    outage_len = int(sc.opt("outage_len", 200))
    rng = np.random.default_rng(sc.seed + 4)
    j, _ = _host(base.trace)
    T, M = j.shape[0], base.M
    starts, down = _windows(rng, T, outage_len, n_outages)

    o_tab, h_tab, w_tab = base.tables
    tables = (torch.cat([o_tab, o_tab], dim=-1),
              torch.cat([h_tab, h_tab], dim=-1),
              torch.cat([w_tab, torch.zeros_like(w_tab)], dim=-1))
    j = np.where(down[:, None] & (j > 0), j + M, j)
    trace = Trace(j_idx=torch.tensor(j, dtype=torch.int32,
                                     device=base.device),
                  d_local=base.trace.d_local)
    meta = dict(base.meta, outage_starts=starts, outage_len=outage_len,
                down=down)
    return CompiledScenario(base.scenario, trace, tables, base.params,
                            meta=meta, topology=base.topology)


@register("outage")
def _outage(sc: Scenario, *, device) -> CompiledScenario:
    """Cloudlet capacity outages over IID traffic (see ``_mod_outage``)."""
    space = scenario_space(sc)
    trace, _ = iid_trace(space, _trace_spec(sc), device=device)
    return _mod_outage(sc, _compiled(sc, space, trace, device))


def _default_topology(base: CompiledScenario, K: int):
    """The base scenario's topology, or a nearest-zone K-cloudlet default
    splitting the scenario's total capacity H evenly."""
    from repro_torch.topology import Topology
    if base.topology is not None:
        return base.topology
    return Topology.nearest_zone(K, base.trace.N, base.params.H,
                                 device=base.device)


def _require_no_topology(kind: str, base: CompiledScenario):
    """Topology-building modifiers must not replace an inherited
    association map (cloudlet_outage, which transforms it, composes)."""
    if base.topology is not None:
        raise ValueError(
            f"the {kind!r} modifier builds a topology, but the base "
            "scenario already carries one — apply the topology-defining "
            "modifier first and layer only topology-transforming "
            "modifiers (e.g. cloudlet_outage) on top")


@register_modifier("mobility")
def _mod_mobility(sc: Scenario, base: CompiledScenario) -> CompiledScenario:
    """Attach a mobility-walk topology: K cloudlets split the capacity
    evenly; each slot a device hands over to a random cloudlet w.p.
    ``p_handover`` (the workload layer's counter streams)."""
    from repro_torch.topology import Topology
    _require_no_topology("mobility", base)
    K = int(sc.opt("K", 4))
    p_handover = float(sc.opt("p_handover", 0.05))
    T, N = base.trace.j_idx.shape
    topo = Topology.mobility_walk(K, N, T, H=base.params.H,
                                  p_handover=p_handover, seed=sc.seed,
                                  device=base.device)
    meta = dict(base.meta, K=K, p_handover=p_handover)
    return dataclasses.replace(base, topology=topo, meta=meta)


@register("mobility")
def _mobility(sc: Scenario, *, device) -> CompiledScenario:
    """Mobile fleet over IID traffic: devices random-walk between K
    cloudlets (see ``_mod_mobility``)."""
    space = scenario_space(sc)
    trace, rho = iid_trace(space, _trace_spec(sc), device=device)
    return _mod_mobility(sc, _compiled(sc, space, trace, device,
                                       true_rho=rho))


@register_modifier("hotspot")
def _mod_hotspot(sc: Scenario, base: CompiledScenario) -> CompiledScenario:
    """Attach a hotspot topology: ``hot_frac`` of the fleet crowds one
    cloudlet while capacity stays split evenly, so the congested
    cloudlet's dual must rise above the others'."""
    from repro_torch.topology import Topology
    _require_no_topology("hotspot", base)
    K = int(sc.opt("K", 4))
    hot_frac = float(sc.opt("hot_frac", 0.6))
    topo = Topology.hotspot(K, base.trace.N, base.params.H,
                            hot_frac=hot_frac, device=base.device)
    meta = dict(base.meta, K=K, hot_frac=hot_frac)
    return dataclasses.replace(base, topology=topo, meta=meta)


@register("hotspot")
def _hotspot(sc: Scenario, *, device) -> CompiledScenario:
    """Hotspot association skew over IID traffic (see ``_mod_hotspot``)."""
    space = scenario_space(sc)
    trace, rho = iid_trace(space, _trace_spec(sc), device=device)
    return _mod_hotspot(sc, _compiled(sc, space, trace, device,
                                      true_rho=rho))


@register_modifier("cloudlet_outage")
def _mod_cloudlet_outage(sc: Scenario,
                         base: CompiledScenario) -> CompiledScenario:
    """One cloudlet goes down for outage windows and its devices fail over
    to the survivors (a topology event, unlike the fleet-wide ``outage``).
    Uses the base's topology (K >= 2) or builds a nearest-zone one."""
    n_outages = int(sc.opt("n_outages", 2))
    outage_len = int(sc.opt("outage_len", 200))
    down_k = int(sc.opt("down_k", 0))
    K = int(sc.opt("K", 4))
    topo = _default_topology(base, K)
    if not 0 <= down_k < topo.K:
        raise ValueError(
            f"down_k={down_k} is not a cloudlet of the K={topo.K} "
            "topology this scenario runs on — the outage would silently "
            "be a no-op")
    rng = np.random.default_rng(sc.seed + 7)
    starts, down = _windows(rng, base.trace.T, outage_len, n_outages)
    topo = topo.failover(down, down_k)
    meta = dict(base.meta, cloudlet_outage_starts=starts,
                outage_len=outage_len, down_k=down_k, down=down)
    return dataclasses.replace(base, topology=topo, meta=meta)


@register("cloudlet_outage")
def _cloudlet_outage(sc: Scenario, *, device) -> CompiledScenario:
    """Cloudlet failover windows over IID traffic on a nearest-zone
    topology (see ``_mod_cloudlet_outage``)."""
    space = scenario_space(sc)
    trace, rho = iid_trace(space, _trace_spec(sc), device=device)
    return _mod_cloudlet_outage(sc, _compiled(sc, space, trace, device,
                                              true_rho=rho))


@register("churn_outage")
def _churn_outage(sc: Scenario, *, device) -> CompiledScenario:
    """Device churn composed with cloudlet outages (``spec.compose``)."""
    from repro_torch.scenarios.spec import compose
    c = compose(dataclasses.replace(sc, kind="churn"),
                dataclasses.replace(sc, kind="outage"), device=device)
    return dataclasses.replace(c, scenario=sc)
