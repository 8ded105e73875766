#!/usr/bin/env python3
"""The cell-axis rollouts with o' = o / B_g staged per cell (the port's
form) against o' formed in the kernel, on one CUDA card.

    mkdir -p build/div && git archive HEAD src/repro_torch | tar -x -C build/div
    patch -p1 -d build/div < scripts/cells_o_div.patch
    python3 scripts/cells_o_ab.py . build/div . build/div

Each argument is the root of a checkout; each runs in a fresh process, in
the order given, so the two forms alternate on the same card.  A tree
whose cell-axis wrappers take ``o_div`` (the patch adds it: the shared
(M,) o and the (G, N) divisors go in, and the kernels form o[m] / B_g[n]
per state and slot, correctly rounded as the plain division) runs the
"divided" form; any other runs the "staged" form, each cell's o' a (G,
N, M) table brought in by bulk copies as a single call's (N, M) o' is.
Both run chip_smoke.py phase 9c's grids: (ii) 16 cells of the metro_daily
chain at N=8192, T=512 on the cell-axis K1, and (iii) the same 16 cells
at N=100000 on the cell-axis K2 (block_n 256).  Per tree and grid it
prints the mean CUDA-event time of a call (``time_ms``) and a digest of
the outputs' bytes, which must agree between the forms; then ptxas's
registers, stack and spills of the cell-axis kernels of the tree's build.
Prints the card's name and power limit first.

It imports nothing of JAX; it takes the grids and ``time_ms`` from the
repo's ``chip_smoke.py``.
"""

import hashlib
import inspect
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (a_by_b_grid, metro_daily_chain, time_ms,  # noqa: E402
                        use_tree)


def measure(root: Path):
    use_tree(root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("cells_o_ab: needs a CUDA device")
    from repro_torch.kernels import build, onalgo_step as k
    from repro_torch.scenarios.sweeps import cell_tables
    divided = "o_div" in inspect.signature(
        k.onalgo_chunked_cells_cuda).parameters
    form = "divided" if divided else "staged"
    dev = torch.device("cuda")
    for label, N, block_n, reps in (("(ii) K1", 8192, None, 5),
                                    ("(iii) K2", 100_000, 256, 3)):
        c = metro_daily_chain(N, dev)
        grid = a_by_b_grid(N, c.scenario.H, dev)
        o_s, h, B, H = cell_tables(c.tables[0], c.tables[1], grid.params)
        kw = {} if block_n is None else dict(block_n=block_n)
        if divided:  # the shared o and each cell's divisors B_g
            o_tab, kw["o_div"] = c.tables[0], grid.params.B
        else:
            o_tab = o_s
        G, M = grid.G, c.M
        j = c.trace.j_idx
        kern = (k.onalgo_chunked_cells_cuda if block_n is None
                else k.onalgo_tiled_cells_cuda)

        def fresh():
            return (j, torch.zeros((G, N), device=dev),
                    torch.zeros((G,), device=dev),
                    torch.zeros((G, N, M), device=dev), o_tab, h,
                    c.tables[2], B, H, grid.rules.a, grid.rules.beta)

        out = kern(*fresh(), **kw)
        torch.cuda.synchronize()
        digest = hashlib.sha256(b"".join(
            x.contiguous().view(torch.uint8).cpu().numpy().tobytes()
            for x in out)).hexdigest()[:16]
        ms = time_ms(lambda *a: kern(*a, **kw), fresh, reps)
        print(f"{root}: {label} G={G} N={N} M={M} T={j.shape[0]} {form}: "
              f"{ms:.3f} ms a call; outputs {digest}", flush=True)
        del c, grid, o_s, o_tab, out
        kw.clear()
        torch.cuda.empty_cache()
    name = None
    for ln in build.PTXAS_LOG.get("onalgo_step", "").splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif name and ("onalgo_cells_kernel" in name
                       or "onalgo_tiled_kernelItLb0ELb0ELb1E" in name) and (
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
