#!/usr/bin/env python3
"""Per-slot split of the two-phase K2 / K2-topo kernels that K2 replaced,
on one CUDA card, from a checkout of the commit before the redesign.

    git archive dce472c src/repro_torch chip_smoke.py | tar -x -C build/parent
    python3 scripts/k2_parent_split.py build/parent

The kernels there launch a tile pass and a one-warp mu pass a slot (K2-
topo: a tile pass, a cloudlet pass and a one-warp lnorm pass) and take no
timestamps.  This script adds %globaltimer stamps of block 0 to that
checkout's csrc/onalgo_step.cu (start and end of the device loop, the
block partial, each later pass; a global pointer the launchers read, set
through a new C entry point), then runs the main path's call (N=100000,
M=73, T=512, the service overlay, block_n=256) and K2-topo under the
committed mobility_walk(1024) at the topology tier's capacity, and prints
each call's time (CUDA events, mean of 3) and per-slot split.  Imports
nothing of JAX.
"""

import ctypes
import sys
from pathlib import Path

# (old, new) edits of the checkout's csrc/onalgo_step.cu
STAMPS = [
    ("""  const float mu = p.mu[0];
  double acc_load = 0.0, acc_lam2 = 0.0;
  for (int n = n0 + warp; n < n1; n += kWarps) {
    const float sh = device_slot(p, s, n, mu, p.a_seq[s], p.inv_t[s],
                                 acc_lam2);
    if ((threadIdx.x & (kWarp - 1)) == 0) acc_load += (double)sh;
  }
  block_partial(acc_load, acc_lam2, p.partials + 2 * blockIdx.x);
}""", """  stamp(p, s, 0);
  const float mu = p.mu[0];
  double acc_load = 0.0, acc_lam2 = 0.0;
  for (int n = n0 + warp; n < n1; n += kWarps) {
    const float sh = device_slot(p, s, n, mu, p.a_seq[s], p.inv_t[s],
                                 acc_lam2);
    if ((threadIdx.x & (kWarp - 1)) == 0) acc_load += (double)sh;
  }
  __syncthreads();
  stamp(p, s, 1);
  block_partial(acc_load, acc_lam2, p.partials + 2 * blockIdx.x);
  stamp(p, s, 2);
}"""),
    ("""  if (threadIdx.x == 0) p.mu[0] = mu_new;
}""", """  if (threadIdx.x == 0) p.mu[0] = mu_new;
  stamp(p, s, 3);
}"""),
    ("""  const int n0 = blockIdx.x * block_n;
  topo_devices(p, q, s, n0, min(p.N, n0 + block_n),
               q.kpart + (long long)blockIdx.x * q.K, q.lam2p + blockIdx.x);
}""", """  const int n0 = blockIdx.x * block_n;
  stamp(p, s, 0);
  topo_devices(p, q, s, n0, min(p.N, n0 + block_n),
               q.kpart + (long long)blockIdx.x * q.K, q.lam2p + blockIdx.x);
  stamp(p, s, 3);
}"""),
    ("""  const int k0 = blockIdx.x * kWarp;
  topo_cloudlets(p, q, s, n_tiles, k0, min(q.K, k0 + kWarp),
                 q.mu2p + blockIdx.x);
}""", """  const int k0 = blockIdx.x * kWarp;
  stamp(p, s, 4);
  topo_cloudlets(p, q, s, n_tiles, k0, min(q.K, k0 + kWarp),
                 q.mu2p + blockIdx.x);
  stamp(p, s, 5);
}"""),
    ("""  topo_lnorm(q.lam2p, n_tiles, q.mu2p, n_red, p.lnorm + s);
}""", """  topo_lnorm(q.lam2p, n_tiles, q.mu2p, n_red, p.lnorm + s);
  stamp(p, s, 6);
}"""),
    ("""                        int N, int M, int block_n, void* stream) {
  Rollout p = make_rollout(j, svo, svh, svw, o, os, h, hs, w, ws, B, H, a_seq,
                           inv_t, lam, mu, counts, off, mu_seq, lnorm,
                           partials, T, N, M);""",
     """                        int N, int M, int block_n, void* stream) {
  Rollout p = make_rollout(j, svo, svh, svw, o, os, h, hs, w, ws, B, H, a_seq,
                           inv_t, lam, mu, counts, off, mu_seq, lnorm,
                           partials, T, N, M);
  p.stamps = g_stamps;"""),
    ("""    double* mu2p, int K, int block_n, void* stream) {
  Rollout p = make_rollout(j, svo, svh, svw, o, os, h, hs, w, ws, B, H, a_seq,
                           inv_t, lam, mu, counts, off, mu_seq, lnorm,
                           partials, T, N, M);""",
     """    double* mu2p, int K, int block_n, void* stream) {
  Rollout p = make_rollout(j, svo, svh, svw, o, os, h, hs, w, ws, B, H, a_seq,
                           inv_t, lam, mu, counts, off, mu_seq, lnorm,
                           partials, T, N, M);
  p.stamps = g_stamps;"""),
    ("""extern "C" {
""", """extern "C" {

static unsigned long long* g_stamps = nullptr;
void onalgo_set_stamps(unsigned long long* s) { g_stamps = s; }
"""),
]
SPLIT = {  # the intervals of each slot; the last ends at the next slot's 0
    False: ["device phase", "block partial", "rest of the tile pass + mu "
            "pass", "launch boundary"],
    True: ["device phase", "serial K-row", "block sums + K-row write",
           "rest of the tile pass + launch", "cloudlets", "to the lnorm pass "
           "+ lnorm", "launch boundary"],
}


def split(st, labels):
    st = st.double().cpu()
    n = len(labels) - 1
    parts = ((st[:, 1:n + 1] - st[:, :n]) / 1e3).mean(0).tolist()
    parts.append(float(((st[1:, 0] - st[:-1, n]) / 1e3).mean()))
    per = float(st[-1, 0] - st[0, 0]) / 1e3 / (st.shape[0] - 1)
    return per, dict(zip(labels, parts))


def main(tree: Path):
    src = tree / "src" / "repro_torch" / "kernels" / "csrc" / "onalgo_step.cu"
    text = src.read_text()
    if "onalgo_set_stamps" not in text:
        for old, new in STAMPS:
            if old not in text:
                raise SystemExit(f"{src}: not the two-phase K2 source")
            text = text.replace(old, new)
        src.write_text(text)
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(tree))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k2_parent_split: needs a CUDA device")
    import chip_smoke as cs
    from repro_torch.core import onalgo
    from repro_torch.kernels import onalgo_step as k
    from repro_torch.serve.compile import compile_service
    from repro_torch.serve.simulator import SimConfig, synthetic_pool
    from repro_torch.topology import Topology

    lib = k._lib()
    lib.onalgo_set_stamps.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda")
    N, T, pool = 100_000, 512, synthetic_pool()

    def run(name, fn, topo):
        st = torch.zeros((T, 8), dtype=torch.int64, device=dev)
        lib.onalgo_set_stamps(ctypes.c_void_p(st.data_ptr()))
        fn()
        torch.cuda.synchronize()
        lib.onalgo_set_stamps(None)
        ms = cs.time_ms(fn, lambda: (), 3)
        per, parts = split(st, SPLIT[topo])
        print(f"{name}: {ms:.3f} ms; {per:.2f} us a slot: " + ", ".join(
            f"{a} {b:.2f}" for a, b in parts.items()), flush=True)

    for topo, sim in ((False, SimConfig(num_devices=N, T=T, B_n=0.06,
                                        H=0.5 * N * 441e6, seed=0)),
                      (True, SimConfig(num_devices=N, T=T, B_n=0.06,
                                       H=N / 4 * 441e6, seed=1))):
        c = compile_service(sim, pool, device=dev)
        fixed, sv = cs.rollout_inputs(c, dev)
        M = c.space.M
        zeros = lambda: (c.trace.j_idx, torch.zeros(N, device=dev))
        if not topo:
            run("K2 (tile pass + mu pass), main path", lambda: k.onalgo_tiled_cuda(
                *zeros(), 0.0, torch.zeros((N, M), device=dev), *fixed,
                block_n=256, slot_values=sv), topo)
            continue
        walk = Topology.mobility_walk(1024, N, T, sim.H, p_handover=0.02,
                                      seed=3, device=dev)
        H_k = onalgo.precondition_capacities(walk.H_k, c.params)
        assoc = walk.assoc.contiguous()
        run("K2-topo (three passes), K=1024", lambda: k.onalgo_tiled_topo_cuda(
            *zeros(), torch.zeros(1024, device=dev),
            torch.zeros((N, M), device=dev), *fixed, block_n=256,
            slot_values=sv, assoc=assoc, H_k=H_k), topo)
    print(cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    main(Path(sys.argv[1]).resolve())
