"""Plain reference of one OnAlgo service run: the metrics of
``simulate_service`` worked out again from the deployment, the pool and
the run's workload seed, in plain PyTorch, slot block by slot block.

It imports nothing of the program.  Each layer a call passes through is
computed anew:

  draws     the counter-based workload (threefry-2x32 in jax's
            partitionable layout, stream 1 keyed ``fold_in(fold_in(
            PRNGKey(seed), 1), t // 64)``, counter ``(t % 64 * 4 + c) *
            N + n``): the ON/OFF arrival chain (channel 0, started from
            stream 2's ``u < p_init``), the image id (1), the channel
            flip (2) and the candidate rate (3);
  lowering  the raw values (transmit power of the held rate, the image's
            cycles, the risk-adjusted gain ``phi - v sigma`` rounded once
            to float32 and clipped) and their nearest levels (ties to
            the first) as the flat state index;
  rollout   Algorithm 1 with the diagonal preconditioner (o / B_n, h /
            H): offload iff ``lam o + mu h < w`` (w > 0, a task), the
            duals' ascent on the rho-weighted policy over all states,
            rho = counts * (1 / t), a_t = a / t^beta;
  admission the cloudlet admits a greedy prefix in device order under H;
  fold      the service metrics from the per-slot series.

The per-device sum over states adds columns in the order a warp of 32
lanes does (lane l over columns l, l + 32, ..., then halving): it is the
algorithm's stated order, which the port's kernels and this reference
share, so that the offload decisions can be held exactly.  ``dtype``
(float32, as the deployment states) is the precision of every real
quantity; the control runs the same code in bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.pool import Pool, state_levels

ROW_BLOCK = 64  # slots a block key covers
CHANNELS = 4
STREAM_SERVICE, STREAM_ARRIVAL_INIT = 1, 2
NUM_RATES = 3
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_WARP = 32
DRAW_ELEMENTS = 1 << 25  # counters a draw holds at once (int64 temporaries)


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on Python ints or int64 tensors holding
    32-bit words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def fold_in(key, data: int):
    return threefry2x32(key[0], key[1], (data >> 32) & _M32, data & _M32)


def stream_key(seed: int, sid: int):
    seed = int(seed)
    return fold_in(((seed >> 32) & _M32, seed & _M32), sid)


def uniform(key, counts: torch.Tensor) -> torch.Tensor:
    """float32 U[0, 1) at int64 counters: the top 23 bits of x0 ^ x1 as
    a mantissa in [1, 2), less 1."""
    x0, x1 = threefry2x32(key[0], key[1], counts >> 32, counts & _M32)
    bits = ((x0 ^ x1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def block_uniforms(seed: int, b: int, N: int, device) -> torch.Tensor:
    """(CHANNELS, ROW_BLOCK, N) uniforms of block b of the service stream,
    drawn a few rows at a time so the int64 temporaries stay small."""
    key = fold_in(stream_key(seed, STREAM_SERVICE), b)
    out = torch.empty((CHANNELS, ROW_BLOCK, N), dtype=torch.float32,
                      device=device)
    rows = max(1, min(ROW_BLOCK, DRAW_ELEMENTS // (CHANNELS * N)))
    n = torch.arange(N, dtype=torch.int64, device=device)
    c = torch.arange(CHANNELS, dtype=torch.int64, device=device)
    for r0 in range(0, ROW_BLOCK, rows):
        r = torch.arange(r0, min(r0 + rows, ROW_BLOCK), dtype=torch.int64,
                         device=device)
        i = (r[:, None, None] * CHANNELS + c[None, :, None]) * N + n
        out[:, r0:r0 + len(r)] = uniform(key, i).permute(1, 0, 2)
    return out


def levels(u: torch.Tensor, L: int) -> torch.Tensor:
    return torch.clamp(torch.floor(u * L).to(torch.int64), max=L - 1)


def chain_probs(burst_len, mean_gap, channel_stay):
    """(p_on, p_stay, p_init, p_change) as float32 values: bursts of
    (lo + hi) / 2 slots on average, gaps of 1 + mean_gap."""
    f = np.float32
    mean_on = max((burst_len[0] + burst_len[1]) / 2.0, 1.0)
    mean_off = f(1.0) + f(mean_gap)
    return (float(f(1.0) / mean_off), float(f(1.0 - 1.0 / mean_on)),
            float(f(mean_on) / (f(mean_on) + mean_off)),
            float(f(1.0) - f(channel_stay)))


def step_sizes(a: float, beta: float, T: int):
    """float32 a / t^beta and 1 / t for t = 1 .. T, numpy float32."""
    t = np.arange(1, T + 1, dtype=np.float32)
    return (np.float32(a) / t ** np.float32(beta)).astype(np.float32), \
        (np.float32(1.0) / t).astype(np.float32)


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum (N, M) over M: lane l of a warp adds columns l, l + 32, ...,
    then the 32 lane sums are halved (16, 8, 4, 2, 1)."""
    N, M = x.shape
    x = torch.nn.functional.pad(x, (0, -M % _WARP)).view(N, -1, _WARP)
    acc = x[:, 0]
    for k in range(1, x.shape[1]):
        acc = acc + x[:, k]
    width = _WARP
    while width > 1:
        width //= 2
        acc = acc[:, :width] + acc[:, width:2 * width]
    return acc[:, 0]


def nearest(x: torch.Tensor, lv) -> torch.Tensor:
    """Index of the level nearest to x (float32 distances), the first on a
    tie."""
    lv = torch.tensor(lv, dtype=torch.float32, device=x.device)
    best = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    dist = torch.abs(x.float() - lv[0])
    for k in range(1, lv.shape[0]):
        d = torch.abs(x.float() - lv[k])
        best = torch.where(d < dist, k, best)
        dist = torch.minimum(d, dist)
    return best


def service_reference(cfg: dict, pool: Pool, seed: int, *, device,
                      dtype=torch.float32) -> dict:
    """The service metrics of one run of deployment ``cfg`` (the keys of
    a configuration's ``sim``) over ``pool`` with workload seed ``seed``:
    accuracy, offload_frac, admit_frac, avg_power_per_dev, avg_load,
    avg_delay_ms, tasks, mu_final."""
    f32 = np.float32
    N, T = int(cfg["num_devices"]), int(cfg["T"])
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
    H = torch.tensor(float(f32(cfg["H"])), dtype=torch.float32, device=dev)
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
    lam = torch.zeros(N, dtype=dtype, device=dev)
    mu = torch.zeros((), dtype=dtype, device=dev)
    counts = torch.zeros((N, M), dtype=torch.float32, device=dev)
    series = {k: np.zeros(T, np.float64) for k in
              ("correct", "power", "load", "offloads", "admits", "tasks",
               "mu")}

    for b in range(-(-T // ROW_BLOCK)):
        u = block_uniforms(seed, b, N, dev)
        for r in range(min(ROW_BLOCK, T - b * ROW_BLOCK)):
            t = b * ROW_BLOCK + r
            # draws: arrival chain, image, held channel rate
            on = torch.where(on, u[0, r] < p_stay, u[0, r] < p_on)
            img = levels(u[1, r], pool.S)
            change = (u[2, r] < p_change) | (t == 0)
            rate = torch.where(change, levels(u[3, r], NUM_RATES), rate)
            # lowering: raw values and their state
            o_raw, h_raw = o_rate[rate], cycles[img]
            w_raw = torch.clamp((phi[img].double() - v_risk
                                 * sigma[img].double()).float(), 0.0, 1.0)
            j = ((nearest(o_raw, o_lv) * len(h_lv) + nearest(h_raw, h_lv))
                 * lw + nearest(w_raw, w_lv) + 1)
            j = torch.where(on, j, 0)
            # rollout: the decision on the raw values, then the duals
            counts[cols, j] += 1.0
            rho = (counts * float(inv_t[t])).to(dtype)
            o_now, h_now = (o_raw / B).to(dtype), (h_raw / H).to(dtype)
            w_now = w_raw.to(dtype)
            off = (lam * o_now + mu * h_now < w_now) & (w_now > 0) & on
            price = lam[:, None] * o_s + mu * h_s
            ry = torch.where((price < w_s) & pol_ok, rho, 0.0)
            a_t = float(a_seq[t])
            lam = torch.clamp_min(lam + a_t * (row_sum(o_s * ry) - 1.0), 0.0)
            load = row_sum(h_s * ry).double().sum().to(dtype)
            mu = torch.clamp_min(mu + a_t * (load - 1.0), 0.0)
            # admission in device order under H, then the slot's series
            h_off = torch.where(off, h_raw.double(), 0.0)
            adm = off & (torch.cumsum(h_off, 0) <= float(H))
            task = on.double()
            series["correct"][t] = float(torch.where(adm, cc[img], cl[img])
                                         .double().mul(task).sum())
            series["power"][t] = float((o_raw.double() * off).sum())
            series["load"][t] = float((h_raw.double() * adm).sum())
            series["offloads"][t] = float(off.sum())
            series["admits"][t] = float(adm.sum())
            series["tasks"][t] = float(on.sum())
            series["mu"][t] = float(mu)
    return fold(cfg, {k: v.astype(np.float32) for k, v in series.items()})


def fold(cfg: dict, s: dict) -> dict:
    """The service metrics from (T,) float32 per-slot series: sums in
    numpy, ratios in float64."""
    tasks_raw = float(np.sum(s["tasks"]))
    tasks = max(tasks_raw, 1.0)
    admits = float(np.sum(s["admits"]))
    delay = (cfg.get("d_pr_dev", 2.537e-3) * tasks_raw
             + (cfg.get("d_tr", 0.157e-3) + cfg.get("d_pr_cloud", 0.191e-3))
             * admits)
    return {
        "accuracy": float(np.sum(s["correct"])) / tasks,
        "offload_frac": float(np.sum(s["offloads"])) / tasks,
        "admit_frac": admits / tasks,
        "avg_power_per_dev": (float(np.sum(s["power"]))
                              / (int(cfg["num_devices"]) * int(cfg["T"]))),
        "avg_load": float(np.sum(s["load"])) / int(cfg["T"]),
        "avg_delay_ms": 1e3 * delay / tasks,
        "tasks": tasks,
        "mu_final": float(s["mu"][-1]) if len(s["mu"]) else 0.0,
    }
