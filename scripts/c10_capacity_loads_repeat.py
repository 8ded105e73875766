"""Is the slot loop's per-cloudlet load on the card repeatable, and what
does a repeatable sum cost?

``core.onalgo.capacity_loads`` sums each device's row load onto its
cloudlet; ``index_add_`` on a CUDA tensor adds with float atomics in
whatever order the threads reach them, so the card takes
``onalgo.segment_sums`` (fixed point, integer atomics).  For four ways
of that segment sum:

  index_add_   the float atomics (what the card took before the fix);
  fixed64      the fixed point formed in float64, its scale from frexp
               (the first form of the fix, 18 eager kernels);
  segment_sums the fixed point formed in float32, its scale from the
               exponent bits of max|row| (the repo's, 9 kernels);
  index_put_   ``index_put_(accumulate=True)``, which sorts the ids;

this script prints how many distinct results 20 calls give on one input
and the ms of a call (CUDA events, 200 calls, 3 rounds, the ways
alternating), at N=100000 under K=1024 (random ids) and K=4; then, with
each way put in ``onalgo.segment_sums`` in turn (order A B C D D C B A),
the wall of ``simulate_service``'s scan engine at N=100000, T=512 under
phase 6's ``hotspot(4)`` and ``mobility_walk(1024)`` and the p50 / p99 of
the live gateway's tick under chip_smoke 10c's streamed walk (N=100000,
T=256, 0.2 of the capacity).  Last, six scan runs under ``hotspot(4)``
(N=256, T=64) with the repo's ``segment_sums``: their final capacity
duals.

Run on a machine with a CUDA device, from the repo root:

    python3 scripts/c10_capacity_loads_repeat.py
"""

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import onalgo  # noqa: E402
from repro_torch.serve.simulator import (SimConfig, simulate_service,  # noqa: E402
                                         synthetic_pool)
from repro_torch.topology import Topology  # noqa: E402


def fixed64(rows, ids, K):
    rows64 = rows.double()
    bound = rows64.abs().amax() * rows.shape[0]
    _, exp = torch.frexp(bound.clamp_min(2.0 ** -900))
    scale = ((62 - exp.long() + 1023) << 52).view(torch.float64)
    q = torch.round(rows64 * scale).long()
    acc = torch.zeros((K,), dtype=torch.int64, device=rows.device
                      ).index_add_(0, ids, q)
    return (acc.double() / scale).to(rows.dtype)


WAYS = {
    "index_add_": lambda rows, ids, K: torch.zeros(
        K, device=rows.device).index_add_(0, ids, rows),
    "fixed64": fixed64,
    "segment_sums": onalgo.segment_sums,
    "index_put_": lambda rows, ids, K: torch.zeros(
        K, device=rows.device).index_put_((ids,), rows, accumulate=True),
}


def per_call(N, K, g):
    rows = torch.rand(N, generator=g, device="cuda") * 1e-5
    ids = torch.randint(0, K, (N,), generator=g, device="cuda")
    want = torch.zeros(K).index_add_(0, ids.cpu(), rows.cpu())
    times = {name: [] for name in WAYS}
    for name, fn in WAYS.items():
        outs = [fn(rows, ids, K) for _ in range(20)]
        distinct = len({o.cpu().numpy().tobytes() for o in outs})
        err = float((outs[0].cpu() - want).abs().max())
        print(f"  {name} N={N} K={K}: {distinct} distinct results in 20 "
              f"calls; max |diff| to the CPU's index_add_ {err:.3g}")
    for _ in range(3):
        for name, fn in WAYS.items():
            fn(rows, ids, K)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(200):
                fn(rows, ids, K)
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / 200)
    for name, ms in times.items():
        print(f"  {name} N={N} K={K}: " + ", ".join(f"{t:.4f}" for t in ms)
              + " ms a call (3 rounds)")


def scan_wall(sim, pool, topo):
    torch.cuda.synchronize()
    t = time.perf_counter()
    simulate_service(sim, pool, topology=topo, engine="scan", device="cuda")
    torch.cuda.synchronize()
    return time.perf_counter() - t


def walk_ticks(sim, pool, st, topo, waves):
    from repro_torch.serve.gateway import GatewayCore
    core = GatewayCore.for_sim(sim, pool, topology=topo, device="cuda")
    core.warmup()
    tot = []
    for wv in waves:
        t0 = time.perf_counter()
        core.resolve_timed(core.tick_async(wv.idx, wv.o, wv.h, wv.w))
        tot.append(1e3 * (time.perf_counter() - t0))
    return float(np.percentile(tot, 50)), float(np.percentile(tot, 99))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}")
    g = torch.Generator(device="cuda").manual_seed(0)
    print("one call:")
    for K in (1024, 4):
        per_call(100000, K, g)

    from repro_torch.serve.compile import compile_service_streaming
    from repro_torch.workload import ServiceLoadGen
    pool = synthetic_pool()
    N, T = 100000, 512
    sim = SimConfig(num_devices=N, T=T, B_n=0.06, H=N / 4 * 441e6, seed=1)
    topos = {"hotspot(4)": Topology.hotspot(4, N, sim.H, hot_frac=0.5,
                                            device="cuda"),
             "mobility_walk(1024)": Topology.mobility_walk(
                 1024, N, T, sim.H, p_handover=0.02, seed=3,
                 device="cuda")}
    gsim = SimConfig(num_devices=N, T=256, B_n=0.06, H=0.5 * N * 441e6,
                     seed=0)
    walk = Topology.mobility_walk(1024, N, 256, 0.2 * gsim.H,
                                  p_handover=0.02, seed=3, streaming=True,
                                  device="cuda")
    st = compile_service_streaming(gsim, pool, device="cuda")
    waves = list(ServiceLoadGen(st, slab=64).waves())
    repo_way = onalgo.segment_sums
    order = list(WAYS) + list(WAYS)[::-1]
    walls = {name: {label: [] for label in topos} for name in WAYS}
    ticks = {name: [] for name in WAYS}
    scan_wall(sim, pool, topos["hotspot(4)"])  # first-use costs
    for name in order:
        onalgo.segment_sums = WAYS[name]
        for label, topo in topos.items():
            walls[name][label].append(scan_wall(sim, pool, topo))
        ticks[name].append(walk_ticks(gsim, pool, st, walk, waves))
    onalgo.segment_sums = repo_way
    print(f"scan engine, N={N} T={T} (two runs each, order "
          f"{' '.join(order)}), and the gateway's walk tick (N={N}, "
          f"T=256, p50 / p99 ms):")
    for name in WAYS:
        print(f"  {name}: " + "; ".join(
            f"{label} " + ", ".join(f"{w:.3f}" for w in ws) + " s"
            for label, ws in walls[name].items())
            + "; walk tick " + ", ".join(f"{a:.3f} / {b:.3f}"
                                         for a, b in ticks[name]))

    n = 256
    small = SimConfig(num_devices=n, T=64, B_n=0.06, H=0.25 * n * 441e6,
                      seed=2)
    topo = Topology.hotspot(4, n, small.H, device="cuda")
    mu = [simulate_service(small, pool, topology=topo,
                           device="cuda")["mu_final"] for _ in range(6)]
    print(f"scan under hotspot(4), N={n} T=64, 6 runs, mu_final: {mu}")


if __name__ == "__main__":
    main()
