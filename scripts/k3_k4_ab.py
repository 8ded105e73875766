#!/usr/bin/env python3
"""The slot loop with K3 and the mamba2-370m forward with K4, in one or
more checkouts of this repository, on one CUDA card.

    git archive a65fed6 src/repro_torch | tar -x -C build/parent
    python3 scripts/k3_k4_ab.py build/parent . . build/parent

Each argument is the root of a checkout (for example the parent commit
unpacked with ``git archive``); each runs in a fresh process, in the order
given, so two commits alternate on the same card.  Per tree it prints:

* the service's slot loop with ``use_kernel=True`` (chip_smoke.py phase
  3's "scan+use_kernel" engine: SimConfig N=100000, T=512, the service
  overlay): the wall of three runs ending in a synchronize, after one
  warm-up; from torch.profiler over one more run, the kernels a slot, the
  reductions (``reduce_kernel``) a slot by type, and K3's device time;
* ``lm.forward(use_kernel=True)`` of mamba2-370m at full width in bf16
  (random weights from seed 0) over (4, 2048) tokens: the wall of three
  runs after one warm-up, and K4's device time in one forward from
  torch.profiler.

It imports nothing of JAX; it takes ``profiled`` from the repo's
``chip_smoke.py``.
"""

import re
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import profiled, use_tree  # noqa: E402


def walls(fn, reps=3):
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


def measure(root: Path):
    use_tree(root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k3_k4_ab: needs a CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.core.fleet import simulate
    from repro_torch.models import lm
    from repro_torch.models.api import ModelAPI
    from repro_torch.serve.compile import compile_service
    from repro_torch.serve.simulator import SimConfig, synthetic_pool

    dev = torch.device("cuda")
    N, T = 100_000, 512
    sim = SimConfig(num_devices=N, T=T, B_n=0.06, H=0.5 * N * 441e6, seed=0)
    cs = compile_service(sim, synthetic_pool(), device=dev)
    args = (*cs.simulate_args(), cs.rule)
    kw = dict(overlay=cs.overlay, enforce_slot_capacity=True, device=dev)
    loop = lambda: simulate(*args, use_kernel=True, **kw)
    ms = walls(loop)
    prof = profiled(loop)
    kernels = sum(c for c, _ in prof.values())
    red = {}
    for key, (c, _) in prof.items():
        if key.startswith("void at::native::reduce_kernel"):
            op = re.search(r"ReduceOp<(\w+)", key)
            name = op.group(1) if op else key[:40]
            red[name] = red.get(name, 0) + c
    k3 = sum(d for key, (c, d) in prof.items() if "onalgo_duals" in key)
    print(f"{root}: slot loop {', '.join(f'{m:.1f}' for m in ms)} ms; "
          f"{kernels / T:.2f} kernels a slot, reductions a slot "
          f"{ {k: v / T for k, v in sorted(red.items())} }; K3 "
          f"{k3:.3f} ms on the device over {T} launches", flush=True)
    del cs, args, kw

    cfg = get_config("mamba2-370m")
    params, _ = ModelAPI(cfg).init(torch.Generator(device=dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (4, 2048), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(5))
    with torch.inference_mode():
        fwd = lambda: lm.forward(cfg, params, tokens, use_kernel=True)
        ms = walls(fwd)
        prof = profiled(fwd)
    k4 = [(c, d) for key, (c, d) in prof.items() if "ssd_chunk" in key]
    print(f"{root}: (4, 2048) forward with K4 "
          f"{', '.join(f'{m:.1f}' for m in ms)} ms; K4 "
          f"{sum(c for c, _ in k4)} launches, "
          f"{sum(d for _, d in k4):.3f} ms on the device", flush=True)


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
