#!/usr/bin/env python3
"""K1 (resident route), K2, K1-topo and K2-topo device times, and the
walls of the scan engines' slot loops, in one or more checkouts of this
repository, on one CUDA card.

    git archive 9f5ff09 src/repro_torch | tar -x -C build/parent
    python3 scripts/rollout_ab.py build/parent . . build/parent
    python3 scripts/rollout_ab.py --loops build/parent . . build/parent

Each argument is the root of a checkout (for example the parent commit
unpacked with ``git archive``); each runs in a fresh process, in the order
given, so two commits alternate on the same card.  Per tree it builds
chip_smoke.py phase 2's rollout operands (SimConfig N=100000, T=512, the
service overlay in dual space) and prints, from torch.profiler over three
calls each, the device time of one K1 call and of one K2 call
(block_n=256): over slots 65..128 resumed at t0=64 with the capacity at
CHECK_H, and over all 512 slots from t0=0; the same for K1-topo and
K2-topo (block_n=256) under chip_smoke.py phase 6's mobility walk
(K=1024, p_handover=0.02, seed 3; SimConfig seed 1, capacity N/4 tasks a
slot); and the host wall of five runs (after one warm-up, each ending in
a synchronize) of ``fleet.simulate`` on phase 2's service, without and
with ``use_kernel`` (chip_smoke.py phase 3b's "scan" and
"scan+use_kernel"), with the CUDA kernels a slot from torch.profiler,
and the host time of the empirical distribution a slot loop forms each
slot (``RhoEstimator.rho`` at t = 1 .. 512 on the service's (N, M)
counts, ending in a synchronize).  With ``--loops`` only the loops and
that time are measured.

It imports nothing of JAX; it takes ``profiled``, ``rollout_inputs`` and
``CHECK_H`` from the repo's ``chip_smoke.py``.
"""

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (CHECK_H, profiled, rollout_inputs,  # noqa: E402
                        use_tree)


def walls(fn, reps=5):
    import torch
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t))
    return out


def device_ms(call, family):
    """Device ms of one call()'s kernels whose name holds ``family``, from
    torch.profiler, three times after a warm-up call."""
    call()
    return [sum(d for key, (_, d) in profiled(call).items()
                if family in key) for _ in range(3)]


def measure(root: Path, loops_only=False):
    use_tree(root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("rollout_ab: needs a CUDA device")
    from repro_torch.core import onalgo
    from repro_torch.core.fleet import simulate
    from repro_torch.core.state_space import RhoEstimator
    from repro_torch.kernels import onalgo_step as k
    from repro_torch.serve.compile import compile_service
    from repro_torch.serve.simulator import SimConfig, synthetic_pool
    from repro_torch.topology import Topology
    dev = torch.device("cuda")
    N, T = 100_000, 512
    sim = SimConfig(num_devices=N, T=T, B_n=0.06, H=0.5 * N * 441e6, seed=0)
    cs = compile_service(sim, synthetic_pool(), device=dev)
    j, M = cs.trace.j_idx, cs.space.M
    for n_slots, t0, cap in () if loops_only else ((64, 64, CHECK_H),
                                                   (T, 0, 1.0)):
        fixed, sv = rollout_inputs(cs, dev, cap)
        _, _, _, lam0, mu0, counts0 = k.onalgo_chunked_plain(
            j[:t0], torch.zeros(N, device=dev), 0.0,
            torch.zeros((N, M), device=dev), *fixed, t0=0,
            slot_values=tuple(x[:t0] for x in sv))
        win = slice(t0, t0 + n_slots)
        j_w = j[win].contiguous()
        sv_w = tuple(x[win].contiguous() for x in sv)
        mu0 = torch.as_tensor(mu0, dtype=torch.float32, device=dev)
        for name, kern, family in (
                ("K1", k.onalgo_chunked_cuda, "onalgo_resident"),
                ("K2", lambda *a, **kw: k.onalgo_tiled_cuda(
                    *a, block_n=256, **kw), "onalgo_tiled")):
            ms = device_ms(lambda: kern(j_w, lam0.clone(), mu0.clone(),
                                        counts0.clone(), *fixed, t0=t0,
                                        slot_values=sv_w), family)
            print(f"{root}: {name} T={n_slots} t0={t0} H x{cap}: "
                  f"{', '.join(f'{m:.4f}' for m in ms)} ms on the device",
                  flush=True)

    args = (*cs.simulate_args(), cs.rule)
    kw = dict(overlay=cs.overlay, enforce_slot_capacity=True, device=dev)
    for label, use_kernel in (("scan", False), ("scan+use_kernel", True)):
        loop = lambda: simulate(*args, use_kernel=use_kernel, **kw)
        ms = walls(loop)
        kernels = sum(c for c, _ in profiled(loop).values())
        print(f"{root}: {label} slot loop "
              f"{', '.join(f'{m:.1f}' for m in ms)} ms; "
              f"{kernels / T:.2f} kernels a slot", flush=True)
    counts = torch.zeros((N, M), device=dev)
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for s in range(1, T + 1):
            RhoEstimator(counts=counts, t=s).rho
        torch.cuda.synchronize()
        us = 1e6 * (time.perf_counter() - t) / T
        print(f"{root}: RhoEstimator.rho {us:.2f} us a slot over {T} slots",
              flush=True)
    del cs, args, kw
    if loops_only:
        return

    sim = SimConfig(num_devices=N, T=T, B_n=0.06, H=N / 4 * 441e6, seed=1)
    cs = compile_service(sim, synthetic_pool(), device=dev)
    topo = Topology.mobility_walk(1024, N, T, sim.H, p_handover=0.02,
                                  seed=3, device=dev)
    j = cs.trace.j_idx
    for n_slots, t0, cap in ((64, 64, CHECK_H), (T, 0, 1.0)):
        fixed, sv = rollout_inputs(cs, dev, cap)
        H_k = onalgo.precondition_capacities(topo.H_k, cs.params) * cap
        lam0, mu0 = torch.zeros(N, device=dev), torch.zeros(1024, device=dev)
        counts0 = torch.zeros((N, M), device=dev)
        if t0:
            _, _, _, lam0, mu0, counts0 = k.onalgo_chunked_plain(
                j[:t0], lam0, mu0, counts0, *fixed, t0=0,
                slot_values=tuple(x[:t0] for x in sv),
                assoc=topo.assoc[:t0].contiguous(), H_k=H_k)
        win = slice(t0, t0 + n_slots)
        j_w = j[win].contiguous()
        sv_w = tuple(x[win].contiguous() for x in sv)
        topo_kw = dict(t0=t0, slot_values=sv_w,
                       assoc=topo.assoc[win].contiguous(), H_k=H_k)
        for name, kern, family in (
                ("K1-topo", k.onalgo_chunked_topo_cuda, "onalgo_resident"),
                ("K2-topo", lambda *a, **kw: k.onalgo_tiled_topo_cuda(
                    *a, block_n=256, **kw), "onalgo_tiled")):
            ms = device_ms(lambda: kern(j_w, lam0.clone(), mu0.clone(),
                                        counts0.clone(), *fixed, **topo_kw),
                           family)
            print(f"{root}: {name} K=1024 T={n_slots} t0={t0} H x{cap}: "
                  f"{', '.join(f'{m:.4f}' for m in ms)} ms on the device",
                  flush=True)


def main():
    if len(sys.argv) == 4 and sys.argv[1] == "--one":
        measure(Path(sys.argv[3]).resolve(), sys.argv[2] == "loops")
        return
    loops = sys.argv[1:2] == ["--loops"]
    trees = sys.argv[2:] if loops else sys.argv[1:]
    if not trees:
        raise SystemExit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    for tree in trees:
        subprocess.run([sys.executable, __file__, "--one",
                        "loops" if loops else "all", tree], check=True,
                       timeout=900)


if __name__ == "__main__":
    main()
