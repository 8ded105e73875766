#!/usr/bin/env python3
"""The cell-axis K1 of two trees on one CUDA card, in turns.

    mkdir -p build/parent && git archive <parent> src/repro_torch | tar -x -C build/parent
    python3 scripts/cells_k1_ab.py build/parent . . build/parent

Each argument is the root of a checkout; each runs in a fresh process, in
the order given, so the trees alternate on the same card.  Both run
chip_smoke.py phase 9c's K1 grids: (i) 64 cells (a x beta x B x H) of the
stationary scenario at N=8, T=4000, and (ii) 16 cells (a x B) of the
metro_daily chain at N=8192, T=512.  Per tree and grid it prints the mean
CUDA-event time of a call (``call_ms``: the wrapper's host work, its
plan and uploads, included), the kernel's mean device time over the same
calls from torch.profiler (``device_ms``), the plan's reason, and a digest
of the outputs' bytes, which must agree between the trees; where the
tree's wrapper takes ``stamps=``, block 0's slot split; then ptxas's
registers, stack and spills of each onalgo_cells_kernel instance of the
tree's build.  Prints the card's name and power limit first.

It imports nothing of JAX; it takes the grids and timers from the repo's
``chip_smoke.py``.
"""

import hashlib
import inspect
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from chip_smoke import (SWEEP_A, SWEEP_B, SWEEP_BETA, SWEEP_CAP,  # noqa: E402
                        a_by_b_grid, metro_daily_chain, profiled, time_ms,
                        use_tree)


def grids(dev):
    """(label, compiled scenario, grid, timed calls) of grids (i), (ii)."""
    from repro_torch.scenarios import Scenario, compile_scenario, product_grid
    c = compile_scenario(Scenario("stationary", T=4000, N=8, seed=0),
                         device=dev)
    yield "(i) 64 x N=8, T=4000", c, product_grid(
        8, a_values=SWEEP_A, beta_values=SWEEP_BETA, B_values=SWEEP_B,
        H_values=tuple(f * 8 * 441e6 for f in SWEEP_CAP), device=dev), 5
    c = metro_daily_chain(8192, dev)
    yield "(ii) 16 x N=8192, T=512", c, a_by_b_grid(8192, c.scenario.H,
                                                    dev), 10


def measure(root: Path):
    use_tree(root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("cells_k1_ab: needs a CUDA device")
    from repro_torch.kernels import build, onalgo_step as k
    from repro_torch.scenarios.sweeps import cell_tables
    dev = torch.device("cuda")
    kern = k.onalgo_chunked_cells_cuda
    stamped = "stamps" in inspect.signature(kern).parameters
    for label, c, grid, reps in grids(dev):
        o_s, h_s, B, H = cell_tables(c.tables[0], c.tables[1], grid.params)
        G, M, j = grid.G, c.M, c.trace.j_idx
        T, N = j.shape

        def fresh():
            return (j, torch.zeros((G, N), device=dev),
                    torch.zeros((G,), device=dev),
                    torch.zeros((G, N, M), device=dev), o_s, h_s,
                    c.tables[2], B, H, grid.rules.a, grid.rules.beta)

        out = kern(*fresh())
        torch.cuda.synchronize()
        digest = hashlib.sha256(b"".join(
            x.contiguous().view(torch.uint8).cpu().numpy().tobytes()
            for x in out)).hexdigest()[:16]
        call_ms = time_ms(kern, fresh, reps)
        calls = [fresh() for _ in range(reps)]
        rec = profiled(lambda: [kern(*a) for a in calls])
        n, dev_ms = next((v for key, v in rec.items()
                          if "onalgo_cells_kernel" in key), (0, 0.0))
        split = ""
        if stamped:
            st = torch.zeros((T, k.STAMPS), dtype=torch.int64, device=dev)
            kern(*fresh(), stamps=st)
            torch.cuda.synchronize()
            split = "; " + chip_smoke.split_text(
                *chip_smoke.slot_split(st, "cells", False))
        print(f"{root}: {label}: call_ms {call_ms:.3f}, device_ms "
              f"{dev_ms / max(n, 1):.3f} ({n} kernels); outputs {digest}; "
              f"plan: {kern.plan.why}{split}", flush=True)
        del c, grid, o_s, out, calls
        torch.cuda.empty_cache()
    name = None
    for ln in build.PTXAS_LOG.get("onalgo_step", "").splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif name and "onalgo_cells_kernel" in name and (
                "registers" in ln or "stack" in ln):
            print(f"{root}: ptxas {name}: {ln.strip()}", flush=True)


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
                       timeout=900)


if __name__ == "__main__":
    main()
