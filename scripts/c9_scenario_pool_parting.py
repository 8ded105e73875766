"""ROADMAP C9 on the paper's trained-classifier pool, on the CPU.

``make_scenario("hard", seed=0)``'s pool (built by the port on the CPU),
served at N=4096, T=240 with enforce_slot_capacity, at the service's
capacity ratio (H = 0.5 N 441e6, mu stays 0) and at 0.2 of it: counts
the slots whose offload totals differ between the scan engine and the
chunked engine (K1's plain version) in each package, and between the two
packages' scan engines.  The pool goes to the reference as numpy arrays.

    PYTHONPATH=src python scripts/c9_scenario_pool_parting.py   (~1 min)
"""

import numpy as np
import torch


def parted(a, b):
    d = np.nonzero(np.asarray(a) != np.asarray(b))[0]
    return f"{len(d)} slots {d[:5].tolist()}"


def main():
    from repro.core.fleet import simulate as ref_scan
    from repro.core.fleet import simulate_chunked as ref_chunked
    from repro.serve import compile as ref_compile
    from repro.serve import simulator as ref_sim
    from repro_torch.core.fleet import simulate, simulate_chunked
    from repro_torch.serve.compile import compile_service
    from repro_torch.serve.simulator import SimConfig, make_scenario

    torch.set_num_threads(4)
    _, _, _, pool = make_scenario("hard", seed=0, device="cpu")
    rpool = ref_sim.PrecomputedPool(*(np.asarray(getattr(pool, k)) for k in (
        "local_correct", "cloud_correct", "d_local", "phi_hat", "sigma",
        "cycles")))
    N, T = 4096, 240
    for cap in (1.0, 0.2):
        kw = dict(num_devices=N, T=T, B_n=0.06, H=cap * 0.5 * N * 441e6,
                  seed=0)
        cs = compile_service(SimConfig(**kw), pool, device="cpu")
        run = dict(overlay=cs.overlay, enforce_slot_capacity=True,
                   device="cpu")
        scan = simulate(*cs.simulate_args(), cs.rule, **run)[0]["offloads"]
        k1 = simulate_chunked(*cs.simulate_args(), cs.rule, chunk=16,
                              **run)[0]["offloads"]
        rcs = ref_compile.compile_service(ref_sim.SimConfig(**kw), rpool)
        rrun = dict(overlay=rcs.overlay, enforce_slot_capacity=True)
        rscan = ref_scan(*rcs.simulate_args(), rcs.rule, **rrun)[0]
        rk1 = ref_chunked(*rcs.simulate_args(), rcs.rule, chunk=16,
                          **rrun)[0]
        print(f"capacity {cap}: scan vs chunked part in: port "
              f"{parted(scan, k1)}, reference "
              f"{parted(rscan['offloads'], rk1['offloads'])}; port scan vs "
              f"reference scan {parted(scan, rscan['offloads'])}; port "
              f"chunked vs reference chunked "
              f"{parted(k1, rk1['offloads'])}", flush=True)


if __name__ == "__main__":
    main()
