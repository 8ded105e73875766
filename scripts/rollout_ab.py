#!/usr/bin/env python3
"""K1 (resident route) and K2 device times in one or more checkouts of
this repository, on one CUDA card.

    git archive 9f5ff09 src/repro_torch | tar -x -C build/parent
    python3 scripts/rollout_ab.py build/parent . . build/parent

Each argument is the root of a checkout (for example the parent commit
unpacked with ``git archive``); each runs in a fresh process, in the order
given, so two commits alternate on the same card.  Per tree it builds
chip_smoke.py phase 2's rollout operands (SimConfig N=100000, T=512, the
service overlay in dual space) and prints, from torch.profiler over three
calls each, the device time of one K1 call and of one K2 call
(block_n=256): over slots 65..128 resumed at t0=64 with the capacity at
CHECK_H, and over all 512 slots from t0=0.

It imports nothing of JAX; it takes ``profiled``, ``rollout_inputs`` and
``CHECK_H`` from the repo's ``chip_smoke.py``.
"""

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import CHECK_H, profiled, rollout_inputs  # noqa: E402


def measure(root: Path):
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("rollout_ab: needs a CUDA device")
    from repro_torch.kernels import onalgo_step as k
    from repro_torch.serve.compile import compile_service
    from repro_torch.serve.simulator import SimConfig, synthetic_pool
    dev = torch.device("cuda")
    N, T = 100_000, 512
    sim = SimConfig(num_devices=N, T=T, B_n=0.06, H=0.5 * N * 441e6, seed=0)
    cs = compile_service(sim, synthetic_pool(), device=dev)
    j, M = cs.trace.j_idx, cs.space.M
    for n_slots, t0, cap in ((64, 64, CHECK_H), (T, 0, 1.0)):
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
            call = lambda: kern(j_w, lam0.clone(), mu0.clone(),
                                counts0.clone(), *fixed, t0=t0,
                                slot_values=sv_w)
            call()
            ms = [sum(d for key, (_, d) in profiled(call).items()
                      if family in key) for _ in range(3)]
            print(f"{root}: {name} T={n_slots} t0={t0} H x{cap}: "
                  f"{', '.join(f'{m:.4f}' for m in ms)} ms on the device",
                  flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        measure(Path(sys.argv[2]).resolve())
        return
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    for tree in sys.argv[1:]:
        subprocess.run([sys.executable, __file__, "--one", tree], check=True,
                       timeout=600)


if __name__ == "__main__":
    main()
