#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each raises on failure, so the exit code is non-zero):
  0  identify the card (nvidia-smi name and power limit);
  1  build the CUDA kernels from src/repro_torch/kernels/csrc with nvcc
     and print the ptxas report (registers, shared memory, spills);
  2  hold each kernel against its plain PyTorch version on the card at
     the main path's widths (N=100000 devices, M=73 states, the service
     overlay): the rollouts over T=64 slots resuming at t0=64 with the
     capacity tightened to CHECK_H so the mu reduction is active, and over
     the main path's own call (T=512 from t0=0); equal decisions and visit
     counts, duals within rtol=1e-5, atol=1e-6; time each (CUDA events)
     beside its bound;
  3  run the service end to end (SimConfig N=100000, T=512) on four
     engines — scan (plain torch), chunked (K1), chunked+block_n=256 (K2)
     and the slot loop with use_kernel=True (K3) — with every launch
     count set to 0 just before and read just after each run; metrics
     must agree to rel=2e-5, abs=1e-5, and a small run on the card must
     agree with the same run on the CPU; then the stage times and, from
     torch.profiler, each engine's device time by kernel;
  4  print the kernels line (JSON), then the ok line (JSON) last.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak
F32_OPS_PER_S = 67e12  # H100 SXM published f32 peak outside tensor cores
RTOL, ATOL = 1e-5, 1e-6  # duals: the reference's kernel-vs-oracle bar
REL, ABS = 2e-5, 1e-5  # service metrics: the reference's cross-engine bar
# Dual-space capacity of the kernel checks: at the Fig. 5 ratio of H to
# demand the capacity never binds (mu stays 0); at 0.2 of it, it does.
CHECK_H = 0.2
METRICS = ("accuracy", "offload_frac", "admit_frac", "avg_power_per_dev",
           "avg_load", "avg_delay_ms", "tasks", "mu_final")
REPLACES = {
    "onalgo_chunked": "src/repro/kernels/onalgo_step.py:371",
    "onalgo_tiled": "src/repro/kernels/onalgo_step.py:667",
    "onalgo_duals": "src/repro/kernels/onalgo_step.py:42",
}
SOURCE = "src/repro_torch/kernels/csrc/onalgo_step.cu"


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, make_args, reps):
    """Mean CUDA-event time of fn(*make_args()) over reps calls, after one
    warm-up; argument set-up (clones) stays outside the timed region."""
    import torch
    fn(*make_args())
    total = 0.0
    for _ in range(reps):
        args = make_args()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def bound_ms(nbytes, nops):
    """The least time the card could take: bytes over HBM rate or f32
    operations over the f32 peak, whichever is larger."""
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = nops / F32_OPS_PER_S
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                         else "operations")


def rollout_cost(T, N, M, o_rows):
    """Bytes and f32 operations of a T-slot rollout with the overlay:
    inputs read once (j and three overlay streams (T, N); o (o_rows, M),
    h and w (M,); B, lam (N,); counts (N, M); per-slot scalars), outputs
    written once (off (T, N) bool, mu_seq and lnorm (T,), lam, counts).
    Operations: 10 per (slot, device, state) — rho, the price (3), two
    compares, two products and two row-sum adds — and 12 per (slot,
    device) for the decision and the lam step."""
    nbytes = (16 * T * N + 4 * o_rows * M + 8 * M + 8 * N + 4 * N * M
              + 8 * T + 8) + (T * N + 8 * T + 4 * N + 4 * N * M + 4)
    return nbytes, 10 * T * N * M + 12 * T * N


def duals_cost(N, M, o_rows):
    """K3: lam, rho (N, M), o (o_rows, M), h and w (M,), B in; g_pow and
    the load out; 9 operations per (device, state)."""
    nbytes = 4 * N + 4 + 4 * N * M + 4 * o_rows * M + 8 * M + 4 * N
    return nbytes + 4 * N + 4, 9 * N * M


def check_close(name, got, want, rtol=RTOL, atol=ATOL):
    import torch
    err = float((got.double() - want.double()).abs().max()) if got.numel() \
        else 0.0
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        fail(f"{name}: kernel and plain version differ (max abs {err:g})")
    return err


def rollout_inputs(cs, device, cap=1.0):
    """The rollout kernels' operands on the main path (dual space), with
    the capacity scaled by ``cap``."""
    from repro_torch.core import onalgo
    from repro_torch.core.fleet import _overlay_slot_values

    o_tab, h_tab, w_tab = cs.tables
    o_s, h_s, B1, H1 = onalgo.precondition_tables(o_tab, h_tab, cs.params)
    sv = _overlay_slot_values(cs.overlay, cs.params)
    return (o_s, h_s, w_tab, B1, H1 * cap, cs.rule.a, cs.rule.beta), sv


def check_rollouts(cs, n_slots, t0, cap, device, reps):
    """K1 and K2 against their plain version on slots (t0, t0 + n_slots]
    of the compiled service, resuming from the plain version's state after
    t0 slots.  Returns {name: result dict} and that state."""
    import torch
    from repro_torch.kernels import onalgo_step as k

    j = cs.trace.j_idx
    N, M = j.shape[1], cs.space.M
    fixed, sv = rollout_inputs(cs, device, cap)
    _, _, _, lam0, mu0, counts0 = k.onalgo_chunked_plain(
        j[:t0], torch.zeros(N, device=device), 0.0,
        torch.zeros((N, M), device=device), *fixed, t0=0,
        slot_values=tuple(x[:t0] for x in sv))
    win = slice(t0, t0 + n_slots)
    j_w = j[win].contiguous()
    sv_w = tuple(x[win].contiguous() for x in sv)

    def rollout_args():
        return (j_w, lam0.clone(), mu0.clone(), counts0.clone(), *fixed)

    plain = lambda *a: k.onalgo_chunked_plain(*a, t0=t0, slot_values=sv_w)
    want = plain(*rollout_args())
    plain_ms = time_ms(plain, rollout_args, reps=2)
    b_ms, b_by = bound_ms(*rollout_cost(n_slots, N, M, fixed[0].shape[0]))
    results = {}
    for name, kern in (
            ("onalgo_chunked", lambda *a: k.onalgo_chunked_cuda(
                *a, t0=t0, slot_values=sv_w)),
            ("onalgo_tiled", lambda *a: k.onalgo_tiled_cuda(
                *a, block_n=256, t0=t0, slot_values=sv_w))):
        got = kern(*rollout_args())
        torch.cuda.synchronize()
        n_off = int((got[0] != want[0]).sum())
        n_cnt = int((got[5] != want[5]).sum())
        if n_off or n_cnt:
            fail(f"{name}: {n_off} decision and {n_cnt} count mismatches")
        err = max(check_close(f"{name} {what}", got[i], want[i])
                  for i, what in ((1, "mu_seq"), (2, "lnorm"), (3, "lam"),
                                  (4, "mu")))
        ms = time_ms(kern, rollout_args, reps=reps)
        results[name] = dict(name=name, max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             T=n_slots, t0=t0, mu_final=float(got[4]))
        print(f"  {name}: T={n_slots} N={N} M={M} t0={t0} H x{cap}: 0 "
              f"decision / 0 count mismatches, max |diff| {err:.3g}, "
              f"mu {float(got[4]):.6g}; kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    return results, (lam0, mu0, counts0, t0, fixed)


def check_duals(state):
    """K3 against its plain version at a rollout state."""
    from repro_torch.kernels import onalgo_step as k

    lam0, mu0, counts0, t0, fixed = state
    o_s, h_s, w_tab, B1 = fixed[:4]
    N, M = counts0.shape
    duals = (lam0, mu0, counts0 * float(1.0 / t0), o_s, h_s, w_tab, B1)
    g_want, l_want = k.onalgo_duals_plain(*duals)
    g_got, l_got = k.onalgo_duals_cuda(*duals)
    err = max(check_close("onalgo_duals g_pow", g_got, g_want),
              check_close("onalgo_duals load", l_got, l_want, atol=0.0))
    ms = time_ms(k.onalgo_duals_cuda, lambda: duals, reps=50)
    plain_ms = time_ms(k.onalgo_duals_plain, lambda: duals, reps=10)
    b_ms, b_by = bound_ms(*duals_cost(N, M, o_s.shape[0]))
    print(f"  onalgo_duals: N={N} M={M}: max |diff| {err:.3g}; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by})")
    return dict(name="onalgo_duals", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def check_kernels(cs, device):
    """Phase 2: each kernel against its plain version on the card.

    The rollouts run twice: over slots 65..128 resuming at t0=64 with the
    capacity tightened (CHECK_H), and over the main path's own call (all
    T slots from t0=0, the path's capacity), whose times the kernels line
    reports.  K3 runs at the state after 64 slots."""
    resumed, state = check_rollouts(cs, 64, 64, CHECK_H, device, reps=10)
    path, _ = check_rollouts(cs, cs.sim.T, 0, 1.0, device, reps=3)
    for name, r in path.items():
        r["max_abs_err"] = max(r["max_abs_err"],
                               resumed[name]["max_abs_err"])
    return [path["onalgo_chunked"], path["onalgo_tiled"],
            check_duals(state)]


def where_time_goes(sim, pool, cs, device):
    """Phase 3b: stage times of the main path (host clock around work that
    ends in synchronize) and, per engine, the device time by kernel from
    torch.profiler and the device-busy share of the rollout."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.fleet import simulate, simulate_chunked
    from repro_torch.serve.compile import compile_service, service_metrics

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t)

    _, ms = timed(lambda: compile_service(sim, pool, device=device))
    print(f"  compile_service (workload + quantization): {ms:.2f} ms")
    args = (*cs.simulate_args(), cs.rule)
    kw = dict(overlay=cs.overlay, enforce_slot_capacity=True, device=device)
    for label, fn in (
            ("scan", lambda: simulate(*args, **kw)),
            ("chunked", lambda: simulate_chunked(*args, chunk=16, **kw)),
            ("tiled", lambda: simulate_chunked(*args, chunk=16, block_n=256,
                                               **kw)),
            ("scan+use_kernel", lambda: simulate(*args, use_kernel=True,
                                                 **kw))):
        (series, _), roll_ms = timed(fn)
        _, fold_ms = timed(lambda: service_metrics(sim, series))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        dev_us = lambda e: e.self_device_time_total
        total = sum(dev_us(e) for e in kernels) / 1e3
        busy = (f"{total:.2f} ms device time, busy share "
                f"{total / roll_ms:.3f} of the unprofiled rollout"
                if total > 0 else "device time not measured (the profiler "
                "saw no kernels)")
        print(f"  {label}: rollout {roll_ms:.2f} ms, metrics fold "
              f"{fold_ms:.2f} ms; {busy}")
        for e in sorted(kernels, key=dev_us, reverse=True)[:4]:
            print(f"    {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} "
                  f"{e.key[:70]}")


def run_engines(sim, pool, cs, device):
    """Phase 3: the service on four engines, with launch counts."""
    import torch
    from repro_torch.core.fleet import simulate
    from repro_torch.kernels import onalgo_step as k
    from repro_torch.serve.compile import service_metrics
    from repro_torch.serve.simulator import simulate_service

    def use_kernel_scan():
        series, _ = simulate(*cs.simulate_args(), cs.rule, algo=sim.algo,
                             ato_theta=sim.ato_theta, use_kernel=True,
                             enforce_slot_capacity=True, overlay=cs.overlay,
                             device=device)
        return service_metrics(sim, series)

    engines = (
        ("scan", None, lambda: simulate_service(sim, pool, engine="scan",
                                                device=device)),
        ("chunked", "onalgo_chunked", lambda: simulate_service(
            sim, pool, engine="chunked", chunk=16, device=device)),
        ("tiled", "onalgo_tiled", lambda: simulate_service(
            sim, pool, engine="chunked", chunk=16, block_n=256,
            device=device)),
        ("scan+use_kernel", "onalgo_duals", use_kernel_scan),
    )
    out, launches = {}, {}
    for label, kernel, fn in engines:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k.reset_launch_counts()
        t = time.perf_counter()
        metrics = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = {name: w.launches for name, w in k.KERNELS.items()}
        if kernel is not None:
            if counts[kernel] <= 0:
                fail(f"engine {label} ran without launching {kernel}")
            launches[kernel] = counts[kernel]
        if not all(math.isfinite(v) for v in metrics.values()):
            fail(f"engine {label}: non-finite metrics {metrics}")
        out[label] = metrics
        print(f"  {label}: wall {wall:.3f} s (ends in synchronize), "
              f"{sim.num_devices * sim.T / wall:.4g} devslots/s, peak "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
              f"launches {counts}")
        print(f"    metrics {json.dumps(metrics)}")
    agree(out)
    return launches


def agree(runs):
    ref_name, ref = next(iter(runs.items()))
    for name, m in runs.items():
        for key in METRICS:
            if abs(m[key] - ref[key]) > REL * abs(ref[key]) + ABS:
                fail(f"{name} {key}={m[key]!r} disagrees with {ref_name} "
                     f"{ref[key]!r}")


def small_run_matches_cpu(pool):
    """A small service run on the card agrees with the same run on the
    CPU (plain versions) on every engine; the capacity binds (mu > 0)."""
    from repro_torch.serve.simulator import SimConfig, simulate_service
    sim = SimConfig(num_devices=300, T=100, B_n=0.06, H=0.1 * 300 * 441e6,
                    seed=3)
    runs = {"cpu scan": simulate_service(sim, pool, device="cpu")}
    for label, kw in (("scan", {}), ("chunked", dict(engine="chunked",
                                                       chunk=16)),
                      ("tiled", dict(engine="chunked", chunk=16,
                                     block_n=64))):
        runs[f"cuda {label}"] = simulate_service(sim, pool, device="cuda",
                                                 **kw)
    agree(runs)
    print(f"  N=300 T=100: cuda scan / chunked / tiled agree with the cpu "
          f"run: {json.dumps(runs['cpu scan'])}")


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.serve.compile import compile_service
    from repro_torch.serve.simulator import SimConfig, synthetic_pool

    print("phase 0: card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")

    print("phase 1: build")
    t = time.perf_counter()
    lib = build.build("onalgo_step")
    print(f"  built {lib.relative_to(ROOT)} in "
          f"{time.perf_counter() - t:.1f} s")
    print(build.PTXAS_LOG.get("onalgo_step", "  (library already built)"))

    device = torch.device("cuda")
    N, T = 100_000, 512
    sim = SimConfig(num_devices=N, T=T, B_n=0.06, H=0.5 * N * 441e6, seed=0)
    pool = synthetic_pool()
    t = time.perf_counter()
    cs = compile_service(sim, pool, device=device)
    torch.cuda.synchronize()
    print(f"compile_service N={N} T={T} M={cs.space.M}: "
          f"{time.perf_counter() - t:.3f} s")

    print("phase 2: kernels against their plain versions")
    kernels = check_kernels(cs, device)

    print("phase 3: the service end to end")
    small_run_matches_cpu(pool)
    launches = run_engines(sim, pool, cs, device)
    print("phase 3b: where the time goes")
    where_time_goes(sim, pool, cs, device)

    line = {"kernels": [dict(
        name=r["name"], route="cuda", source=SOURCE,
        replaces=REPLACES[r["name"]], launches=launches[r["name"]],
        max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None)
        for r in kernels]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
