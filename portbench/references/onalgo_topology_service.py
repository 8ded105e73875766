"""Plain reference of one OnAlgo service run over K cloudlets: the metrics
of ``simulate_service(..., topology=...)`` worked out again from the
deployment, its topology, the pool and the run's workload seed, in plain
PyTorch, slot by slot.

It imports nothing of the program.  It follows ``onalgo_service``'s slot
loop, and reuses its draws, lowering, per-device row sums and fold; what
K cloudlets add (README, "K-vector mu semantics" and "Segmented
admission") is worked out here:

  association  ``uniform``: device n on cloudlet n % K; ``hotspot``: the
               first half of the fleet on cloudlet 0, device n of the
               rest on 1 + n % (K - 1); ``mobility_walk``: device n
               starts on n % K and each slot hands over w.p.
               ``p_handover`` (a float32 value) to a cloudlet drawn
               uniformly (its own among them), from its own counter
               stream (stream 4 keyed ``fold_in(fold_in(PRNGKey(seed),
               4), t // 64)``, counter ``(t % 64 * 2 + c) * N + n``:
               channel 0 the handover test, channel 1 the cloudlet);
  duals        mu is a (K,) vector: device n is priced by mu[k], k its
               cloudlet this slot, in its decision and in its policy over
               all states; cloudlet k's load is the sum of its devices'
               row loads and its dual ascends on it against H_k / H;
  admission    each cloudlet admits a greedy prefix of its own offloaders
               in device order under H_k = float32(H) / K (float32): the
               devices sorted by (cloudlet, device), one running sum, less
               each cloudlet's offset;
  fold         the series' mu is the cloudlet mean of mu (float32).

Where the float64 sums may part from the program's, each is noted:

  * a cloudlet's load adds its devices' float32 row loads in float64, in
    device order on the CPU (``index_add_``) and in whatever order the
    card's float64 atomics take; the program adds them in float64 in its
    kernel's tile order.  Both round once to float32, so they agree but
    where a float64 sum lies within its own rounding of a float32 tie.
  * admission's running loads are float64 sums of float32 cycle counts:
    every count (at least 150e6) is a multiple of 16, so any sum below
    2^53 * 16 is exact and no order of summation changes it.
  * power, load and the cloudlet mean are folded in float64 here and in
    float32 by the program: ``value_gap``, not ``count_gap``, holds them.

``topology`` (the configuration's ``topology`` entry, carried in
``cfg``) is ``{"kind": "uniform" | "hotspot" | "mobility_walk", "K": ...,
"p_handover": ...}``; with K = 1 every cloudlet quantity is the scalar
reference's.  ``dtype`` (float32, as the deployment states) is the
precision of every real quantity; the control runs the same code in
bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.pool import Pool, state_levels
from portbench.references.onalgo_service import (
    DRAW_ELEMENTS, NUM_RATES, ROW_BLOCK, STREAM_ARRIVAL_INIT, block_uniforms,
    chain_probs, fold, fold_in, levels, nearest, row_sum, step_sizes,
    stream_key, uniform)

STREAM_TOPOLOGY = 4
WALK_CHANNELS = 2


def walk_uniforms(seed: int, b: int, N: int, device) -> torch.Tensor:
    """(WALK_CHANNELS, ROW_BLOCK, N) uniforms of block b of the walk's
    stream, drawn a few rows at a time so the int64 temporaries stay
    small."""
    key = fold_in(stream_key(seed, STREAM_TOPOLOGY), b)
    out = torch.empty((WALK_CHANNELS, ROW_BLOCK, N), dtype=torch.float32,
                      device=device)
    rows = max(1, min(ROW_BLOCK, DRAW_ELEMENTS // (WALK_CHANNELS * N)))
    n = torch.arange(N, dtype=torch.int64, device=device)
    c = torch.arange(WALK_CHANNELS, dtype=torch.int64, device=device)
    for r0 in range(0, ROW_BLOCK, rows):
        r = torch.arange(r0, min(r0 + rows, ROW_BLOCK), dtype=torch.int64,
                         device=device)
        i = (r[:, None, None] * WALK_CHANNELS + c[None, :, None]) * N + n
        out[:, r0:r0 + len(r)] = uniform(key, i).permute(1, 0, 2)
    return out


def placement(topology: dict, N: int, device) -> torch.Tensor:
    """(N,) int64 cloudlet of each device at the start (a static map's
    for good)."""
    K, n = int(topology["K"]), torch.arange(N, device=device)
    if topology["kind"] == "hotspot":
        return torch.where(n < N // 2, 0, 1 + n % (K - 1))
    return n % K


def admit_per_cloudlet(off, h, a, H_k: float, K: int):
    """Each cloudlet's greedy prefix of its offloaders, in device order,
    whose running load (float64) stays within H_k."""
    N = off.shape[0]
    h_off = torch.where(off, h.double(), 0.0)
    order = torch.argsort(a * N + torch.arange(N, device=off.device))
    total = torch.zeros(K, dtype=torch.float64,
                        device=off.device).index_add_(0, a, h_off)
    offset = torch.cumsum(total, 0) - total  # loads of the cloudlets before
    running = torch.cumsum(h_off[order], 0) - offset[a[order]]
    fits = torch.empty_like(off)
    fits[order] = running <= H_k
    return off & fits


def service_reference(cfg: dict, pool: Pool, seed: int, *, device,
                      dtype=torch.float32) -> dict:
    """The service metrics of one run of deployment ``cfg`` (the keys of
    a configuration's ``sim`` and its ``topology``) over ``pool`` with
    workload seed ``seed`` (the walk's seed too): accuracy, offload_frac,
    admit_frac, avg_power_per_dev, avg_load, avg_delay_ms, tasks,
    mu_final."""
    f32 = np.float32
    N, T = int(cfg["num_devices"]), int(cfg["T"])
    topology = cfg["topology"]
    K = int(topology["K"])
    walk = topology["kind"] == "mobility_walk"
    p_hand = float(f32(topology.get("p_handover", 0.0)))
    num_w, v_risk = int(cfg["num_w_levels"]), float(f32(cfg["v_risk"]))
    o_lv, h_lv, w_lv = state_levels(pool, num_w, float(cfg["v_risk"]))
    lw = len(w_lv)
    M = len(o_lv) * len(h_lv) * lw + 1
    dev = torch.device(device)

    # per-state tables (M,), state 0 the null state
    og, hg, wg = np.meshgrid(o_lv, h_lv, w_lv, indexing="ij")
    tab = lambda g: torch.tensor(np.concatenate([[0.0], g.reshape(-1)]),
                                 dtype=torch.float32, device=dev)
    o_tab, h_tab, w_tab = tab(og), tab(hg), tab(wg)
    B = torch.tensor(float(f32(cfg["B_n"])), dtype=torch.float32,
                     device=dev)
    H32 = f32(cfg["H"])
    H = torch.tensor(float(H32), dtype=torch.float32, device=dev)
    H_k = f32(H32 / f32(K))  # each cloudlet's share, split in float32
    cap = float(f32(H_k / H32))  # H_k in the dual space
    o_s = (o_tab / B).to(dtype).expand(N, M)
    h_s = (h_tab / H).to(dtype).expand(N, M)
    w_s = w_tab.to(dtype).expand(N, M)
    pol_ok = w_s > 0

    per_img = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32,
                                     device=dev)
    cycles, phi, sigma = (per_img(pool.cycles), per_img(pool.phi_hat),
                          per_img(pool.sigma))
    cl, cc = per_img(pool.local_correct), per_img(pool.cloud_correct)
    o_rate = per_img(np.asarray(o_lv))
    p_on, p_stay, p_init, p_change = chain_probs(
        cfg["burst_len"], cfg["mean_gap"], cfg.get("channel_stay", 0.9))
    a_seq, inv_t = step_sizes(f32(cfg["step_a"]), f32(0.5), T)

    cols = torch.arange(N, device=dev)
    on = uniform(stream_key(seed, STREAM_ARRIVAL_INIT),
                 torch.arange(N, dtype=torch.int64, device=dev)) < p_init
    rate = torch.zeros(N, dtype=torch.int64, device=dev)
    cloudlet = placement(topology, N, dev)
    lam = torch.zeros(N, dtype=dtype, device=dev)
    mu = torch.zeros(K, dtype=dtype, device=dev)
    counts = torch.zeros((N, M), dtype=torch.float32, device=dev)
    # the per-slot series, on the device until the horizon's end (a read
    # back a slot would make every slot wait for the card)
    names = ("correct", "power", "load", "offloads", "admits", "tasks", "mu")
    acc = torch.zeros((len(names), T), dtype=torch.float64, device=dev)

    for b in range(-(-T // ROW_BLOCK)):
        u = block_uniforms(seed, b, N, dev)
        if walk:
            v = walk_uniforms(seed, b, N, dev)
        for r in range(min(ROW_BLOCK, T - b * ROW_BLOCK)):
            t = b * ROW_BLOCK + r
            # draws: arrival chain, image, held channel rate, the walk
            on = torch.where(on, u[0, r] < p_stay, u[0, r] < p_on)
            img = levels(u[1, r], pool.S)
            change = (u[2, r] < p_change) | (t == 0)
            rate = torch.where(change, levels(u[3, r], NUM_RATES), rate)
            if walk:
                cloudlet = torch.where(v[0, r] < p_hand,
                                       levels(v[1, r], K), cloudlet)
            # lowering: raw values and their state
            o_raw, h_raw = o_rate[rate], cycles[img]
            w_raw = torch.clamp((phi[img].double() - v_risk
                                 * sigma[img].double()).float(), 0.0, 1.0)
            j = ((nearest(o_raw, o_lv) * len(h_lv) + nearest(h_raw, h_lv))
                 * lw + nearest(w_raw, w_lv) + 1)
            j = torch.where(on, j, 0)
            # rollout: the decision on the raw values, each device priced
            # by its cloudlet's dual, then the duals
            counts[cols, j] += 1.0
            rho = (counts * float(inv_t[t])).to(dtype)
            o_now, h_now = (o_raw / B).to(dtype), (h_raw / H).to(dtype)
            w_now = w_raw.to(dtype)
            mu_n = mu[cloudlet]
            off = (lam * o_now + mu_n * h_now < w_now) & (w_now > 0) & on
            price = lam[:, None] * o_s + mu_n[:, None] * h_s
            ry = torch.where((price < w_s) & pol_ok, rho, 0.0)
            a_t = float(a_seq[t])
            lam = torch.clamp_min(lam + a_t * (row_sum(o_s * ry) - 1.0), 0.0)
            load = torch.zeros(K, dtype=torch.float64, device=dev).index_add_(
                0, cloudlet, row_sum(h_s * ry).double()).to(dtype)
            mu = torch.clamp_min(mu + a_t * (load - cap), 0.0)
            # admission per cloudlet in device order, then the series
            adm = admit_per_cloudlet(off, h_raw, cloudlet, float(H_k), K)
            task = on.double()
            acc[:, t] = torch.stack([
                torch.where(adm, cc[img], cl[img]).double().mul(task).sum(),
                (o_raw.double() * off).sum(), (h_raw.double() * adm).sum(),
                off.sum().double(), adm.sum().double(), on.sum().double(),
                mu.float().mean().double()])
    series = acc.cpu().numpy().astype(np.float32)
    return fold(cfg, dict(zip(names, series)))
