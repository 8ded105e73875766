#!/usr/bin/env python3
"""The cell-axis K1 at chip_smoke.py phase 9c (ii) under other (lane
groups, stages) than its plan's, on one CUDA card.

    python3 scripts/cells_lanes_ab.py

9c (ii) is 16 cells (a x B) of the metro_daily chain at N=8192, T=512.
``cells_plan`` picks 8 lane groups of 64 threads with one o' stage each;
this runs that plan and, in two rounds, each choice of ``CHOICES`` (the
plan with its lane groups and stages replaced), and prints per choice the
mean CUDA-event time of a call (the wrapper's host work included), the
kernel's mean device time from torch.profiler, and whether the outputs
equal the plan's bit for bit (every choice keeps the single call's
summation order, so they must).  Prints the card's name and power limit
first.  It imports nothing of JAX.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (a_by_b_grid, metro_daily_chain, profiled,  # noqa: E402
                        time_ms)

# (lane groups, stages a group); None: the plan's own
CHOICES = (None, (8, 1), (7, 2), (6, 2), (4, 3), (4, 2), (4, 1), (2, 2),
           (1, 2))


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("cells_lanes_ab: needs a CUDA device")
    from repro_torch.kernels import onalgo_step as k
    from repro_torch.scenarios.sweeps import cell_tables
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    c = metro_daily_chain(8192, dev)
    grid = a_by_b_grid(8192, c.scenario.H, dev)
    o_s, h_s, B, H = cell_tables(c.tables[0], c.tables[1], grid.params)
    G, M, j = grid.G, c.M, c.trace.j_idx
    N = j.shape[1]
    kern = k.onalgo_chunked_cells_cuda

    def fresh():
        return (j, torch.zeros((G, N), device=dev),
                torch.zeros((G,), device=dev),
                torch.zeros((G, N, M), device=dev), o_s, h_s, c.tables[2], B,
                H, grid.rules.a, grid.rules.beta)

    base = kern(*fresh())
    torch.cuda.synchronize()
    print(f"plan: {kern.plan.why}", flush=True)
    plan_of = k.cells_plan
    for rnd in range(2):
        for choice in CHOICES:
            if choice is not None:
                def replaced(*a, _P=choice[0], _S=choice[1], **kw):
                    p = plan_of(*a, **kw)
                    return dataclasses.replace(
                        p, lane_groups=_P, stages=_S, smem=k.cells_smem(
                            p.single.per, M, p.group_width, _P, _S, p.V,
                            True))
                k.cells_plan = replaced
            try:
                out = kern(*fresh())
                torch.cuda.synchronize()
                same = all(torch.equal(x, y) for x, y in zip(out, base))
                ms = time_ms(kern, fresh, 5)
                calls = [fresh() for _ in range(5)]
                rec = profiled(lambda: [kern(*a) for a in calls])
                n, dev_ms = next((v for key, v in rec.items()
                                  if "onalgo_cells_kernel" in key), (0, 0.0))
                print(f"round {rnd} (groups, stages) "
                      f"{choice or 'plan'}: call {ms:.3f} ms, device "
                      f"{dev_ms / max(n, 1):.3f} ms; outputs "
                      f"{'==' if same else '!='} the plan's", flush=True)
            except RuntimeError as e:  # a choice the card refuses
                print(f"round {rnd} {choice}: {e}", flush=True)
            finally:
                k.cells_plan = plan_of


if __name__ == "__main__":
    main()
