#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each raises on failure, so the exit code is non-zero):
  0  identify the card (nvidia-smi name and power limit);
  1  build the CUDA kernels from src/repro_torch/kernels/csrc (one nvcc
     per source, all started together) and print the ptxas reports
     (registers, shared memory, spills);
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
  4  the attention kernels against their plain versions on the card:
     flash_attention (K5) at olmo-1b's shapes (B=4, S=2048, Hq=Hkv=16,
     D=128) causal and full, in bf16 and f32, plus GQA (Hkv=4);
     decode_attention (K6) at B=16, S=4096, D=128, Hq=Hkv=16 with
     cache_len 1 / 1000 / 4096 in bf16 and f32, plus GQA, plus the
     serving path's own shape; bars (kernels/flash_attention.py's
     TOLERANCE) rtol=atol=2e-5 in f32, the reference's
     (tests/test_kernels.py), and two bf16 ulps in bf16 (rtol=1.6e-2,
     atol=1e-4), shown to reject a kernel that drops one key in sixteen;
     each with its time, the plain version's, the bound and
     scaled_dot_product_attention's;
  5  the cloudlet LM serving path (repro_torch.launch.serve): (a) a
     reduced olmo-1b run on the card gives the CPU run's lines and greedy
     tokens; (b) olmo-1b at full width in bf16 at the entry point's
     defaults, with launch counts reset before and read after (K3 once
     per slot, K6 once per layer per decode step), then prefill and
     decode-step times, tokens/s, peak memory and the decode step's
     device-busy share; (c) a full-width lm.forward(use_kernel=True)
     over (4, 2048) tokens launches K5 once per layer and its
     last-position logits agree with ModelAPI.prefill_step's;
  6  print the kernels line (JSON), then the ok line (JSON) last.

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
    "flash_attention": "src/repro/kernels/flash_attention.py:67",
    "decode_attention": "src/repro/kernels/decode_attention.py:58",
}
SOURCES = {name: "src/repro_torch/kernels/csrc/" + (
    "attention.cu" if name.endswith("attention") else "onalgo_step.cu")
    for name in REPLACES}
# Peak operation rates by input type (H100 SXM, dense): the attention
# kernels' products of bf16 inputs could run on the tensor cores, float32
# ones only on the CUDA cores.
PEAK_OPS = {"bfloat16": 989e12, "float32": F32_OPS_PER_S}
# Phase 5c: the kernel route (K5) and the prefill route (plain flash over
# the cache) compute the same function; in bfloat16 each layer rounds its
# attention output to bf16 (2^-8 relative) in a different summation order,
# so 1-ulp flips enter at every one of 16 layers and grow through the
# random-weight residual stream.  On the CPU (d_model 256-1024, 16 layers,
# head_dim 128, random weights) the two routes differed by 2.4-3.0% of
# max |logit|, and bf16 from float32 by 4-6%; the bar is 10% of
# max(max |logit|, 1).  (The reference's float32 bar is 2e-4 of it,
# tests/test_models.py:116.)
BF16_PATH_BAR = 0.1


T_START = time.perf_counter()


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def phase(title):
    """Print a phase header with the seconds since the script started."""
    print(f"{title}  [t={time.perf_counter() - T_START:.1f} s]", flush=True)


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


def attention_bound(nbytes, nops, dtype_name):
    """Bytes over HBM rate or operations over the peak for the inputs'
    type, whichever is larger."""
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = nops / PEAK_OPS[dtype_name]
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                         else "operations")


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
    from repro_torch.kernels import ops
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
        ops.reset_launch_counts()
        t = time.perf_counter()
        metrics = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = ops.launch_counts()
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


def randn(shape, dtype, gen):
    import torch
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def sdpa_ms(q, k, v, causal, reps):
    """torch's scaled_dot_product_attention on the same function, as a
    yardstick (the port never calls it): (B, H, S, D) copies made outside
    the timed region."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    gqa = qt.shape[1] != kt.shape[1]
    return time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=gqa), lambda: (), reps=reps)


def attend_dropping(q, k, v, causal, n, group):
    """Attention in float32 in one dense softmax over the keys below n (at
    or before the query when causal), leaving out keys j with
    j % 16 == group; in q's dtype.  A fault of this kind (one of K6's 16
    groups of lanes, or one key in sixteen of a K5 tile, lost) must fail
    the bar the kernels are held to."""
    import torch
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    s = torch.einsum("bqhgd,bkhd->bhgqk",
                     q.float().reshape(B, Sq, Hkv, Hq // Hkv, D),
                     k.float()) * D ** -0.5
    kp = torch.arange(Skv, device=q.device)
    keep = ((kp < n) & (kp % 16 != group))[None, :]
    if causal:
        keep = keep & (kp[None, :] <= torch.arange(Sq, device=q.device)[:,
                                                                        None])
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
    del s
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def bar_rejects_fault(label, q, k, v, causal, n, want):
    """Fail unless the bf16 bar rejects attention with one key group
    dropped, at this check's shape and inputs."""
    import torch
    from repro_torch.kernels.flash_attention import TOLERANCE
    faulty = attend_dropping(q, k, v, causal, n, 5).float()
    err = float((faulty - want.float()).abs().max())
    if torch.allclose(faulty, want.float(), **TOLERANCE[q.dtype]):
        fail(f"{label}: the bar accepts one key in sixteen dropped "
             f"(max |diff| {err:g})")
    old = torch.allclose(faulty, want.float(), rtol=2e-2, atol=2e-2)
    print(f"    one key in sixteen dropped: max |diff| {err:.3g}, rejected "
          f"by the bar ({'passes' if old else 'fails'} the reference's "
          f"2e-2 bar)")


def check_flash(B, S, Hq, Hkv, D, causal, dtype, gen, reps, fault=False):
    """K5 against its plain version at one shape; returns the result row.
    With ``fault``, also show that the bar rejects a dropped key group."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    q = randn((B, S, Hq, D), dtype, gen)
    k, v = (randn((B, S, Hkv, D), dtype, gen) for _ in range(2))
    name = str(dtype).removeprefix("torch.")
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    got = fa.flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    err = check_close(f"flash_attention {name} causal={causal} Hkv={Hkv}",
                      got.float(), want.float(), **fa.TOLERANCE[dtype])
    ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=causal),
                 lambda: (), reps=reps)
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                        causal=causal),
                       lambda: (), reps=2)
    lib_ms = sdpa_ms(q, k, v, causal, reps)
    pairs = S * (S + 1) // 2 if causal else S * S
    nbytes = q.element_size() * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)
    b_ms, b_by = attention_bound(nbytes, 4 * B * Hq * pairs * D, name)
    print(f"  flash_attention B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} {name} "
          f"causal={causal}: max |diff| {err:.3g}; kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}), sdpa "
          f"{lib_ms:.3f} ms")
    if fault:
        bar_rejects_fault("flash_attention", q, k, v, causal, S, want)
    return dict(name="flash_attention", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


def check_decode(B, S, Hq, Hkv, D, n, dtype, gen, reps, fault=False):
    """K6 against its plain version at one shape and cache_len n.  With
    ``fault``, also show that the bar rejects a dropped key group."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.flash_attention import TOLERANCE
    q = randn((B, 1, Hq, D), dtype, gen)
    kc, vc = (randn((B, S, Hkv, D), dtype, gen) for _ in range(2))
    name = str(dtype).removeprefix("torch.")
    want = da.decode_attention_plain(q, kc, vc, n)
    got = da.decode_attention_cuda(q, kc, vc, n)
    torch.cuda.synchronize()
    err = check_close(f"decode_attention {name} cache_len={n} Hkv={Hkv}",
                      got.float(), want.float(), **TOLERANCE[dtype])
    ms = time_ms(lambda: da.decode_attention_cuda(q, kc, vc, n), lambda: (),
                 reps=reps)
    plain_ms = time_ms(lambda: da.decode_attention_plain(q, kc, vc, n),
                       lambda: (), reps=2)
    lib_ms = sdpa_ms(q, kc[:, :n], vc[:, :n], False, reps)
    nbytes = q.element_size() * (2 * B * Hq * D + 2 * B * n * Hkv * D)
    b_ms, b_by = attention_bound(nbytes, 4 * B * Hq * n * D, name)
    print(f"  decode_attention B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} {name} "
          f"cache_len={n}: max |diff| {err:.3g}; kernel {ms:.4g} ms, plain "
          f"{plain_ms:.4g} ms, bound {b_ms:.4g} ms ({b_by}), sdpa "
          f"{lib_ms:.4g} ms")
    if fault:
        bar_rejects_fault("decode_attention", q, kc, vc, False, n, want)
    return dict(name="decode_attention", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


def check_attention():
    """Phase 4: K5 and K6 against their plain versions on the card.  The
    kernels line reports K5 at the phase-5c shape (bf16, causal) and K6 at
    a long cache, where attention is the work (bf16, cache_len 4096; the
    bound in csrc/attention.cu's note); max_abs_err is the largest over
    all checks of the kernel."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device="cuda").manual_seed(0)
    flash = [check_flash(4, 2048, 16, 16, 128, causal, dt, gen, reps=5,
                         fault=dt == bf16 and causal)
             for dt in (bf16, f32) for causal in (True, False)]
    flash.append(check_flash(4, 2048, 16, 4, 128, True, bf16, gen, reps=5))
    decode = [check_decode(16, 4096, 16, 16, 128, n, dt, gen, reps=20,
                           fault=dt == bf16 and n == 4096)
              for dt in (bf16, f32) for n in (4096, 1000, 1)]
    decode.append(check_decode(16, 4096, 16, 4, 128, 4096, bf16, gen,
                               reps=20))
    # the serving path's own call: 16 prompts of 16 tokens, 8 generated,
    # a cache of 25 (launch/serve.py's defaults)
    decode.append(check_decode(16, 25, 16, 16, 128, 24, bf16, gen, reps=20))
    out = []
    for rows in (flash, decode):
        r = dict(rows[0])
        r["max_abs_err"] = max(x["max_abs_err"] for x in rows)
        out.append(r)
    return out


def reduced_serving_matches_cpu():
    """Phase 5a: a reduced olmo-1b serving run on the card (K3, K6) gives
    the CPU run's (plain versions') lines and greedy tokens, with the same
    weights (drawn on the CPU, copied to the card)."""
    import copy
    import torch
    from repro_torch.launch.serve import build_model, parse_args, serve
    argv = ["--arch", "olmo-1b", "--reduced", "--slots", "20"]
    cfg, params = build_model(parse_args([*argv, "--device", "cpu"]))
    runs = {}
    for dev, p in (("cpu", params),
                   ("cuda", copy.deepcopy(params).to("cuda"))):
        lines, toks = [], []
        serve(parse_args([*argv, "--device", dev]), cfg, p,
              on_wave=lambda t, o: toks.append(o.cpu()), log=lines.append)
        runs[dev] = (lines, torch.cat(toks))
    if runs["cpu"][0] != runs["cuda"][0]:
        fail(f"reduced serving lines differ: cpu {runs['cpu'][0]} cuda "
             f"{runs['cuda'][0]}")
    n_diff = int((runs["cpu"][1] != runs["cuda"][1]).sum())
    if n_diff:
        fail(f"reduced serving: {n_diff} greedy tokens differ card vs cpu")
    print(f"  reduced olmo-1b, 20 slots: card and cpu print the same lines "
          f"and {runs['cpu'][1].numel()} equal greedy tokens; last line: "
          f"{runs['cpu'][0][-1]}")


def full_width_serving():
    """Phase 5b: the entry point's loop at full olmo-1b width in bf16 on
    the card, with the launch counts of this run; then the times of its
    prefill and decode steps and the decode step's device-busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_model, parse_args, serve
    args = parse_args([])
    t = time.perf_counter()
    cfg, params = build_model(args)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"  {cfg.name}: d_model {cfg.d_model}, {cfg.num_layers} layers, "
          f"{cfg.num_heads} heads x {cfg.resolved_head_dim}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}; {n_params} parameters "
          f"(analytic {cfg.param_count()}), drawn in "
          f"{time.perf_counter() - t:.2f} s")
    waves = []
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    engine, ctrl, served, offered = serve(
        args, cfg, params, on_wave=lambda tk, o: waves.append((tk, o)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**20
    st = engine.stats
    if counts["decode_attention"] != st.decode_calls * cfg.num_layers:
        fail(f"decode_attention launched {counts['decode_attention']} times"
             f", expected once per layer per decode step "
             f"({st.decode_calls} x {cfg.num_layers})")
    if counts["onalgo_duals"] != args.slots:
        fail(f"onalgo_duals launched {counts['onalgo_duals']} times over "
             f"{args.slots} slots")
    toks = torch.cat([o for _, o in waves])
    if toks.shape != (served, args.gen_steps) or int(toks.min()) < 0 or \
            int(toks.max()) >= cfg.vocab_size:
        fail(f"generated ids: shape {tuple(toks.shape)}, range "
             f"[{int(toks.min())}, {int(toks.max())}]")
    print(f"  serve loop: {args.slots} slots, {served}/{offered} tasks "
          f"served in {len(waves)} waves, wall {wall:.2f} s (ends in "
          f"synchronize), peak {peak:.1f} MiB, launches {counts}")

    # the largest wave, timed on its own: prefill and decode steps
    prompts = torch.as_tensor(max(waves, key=lambda w: len(w[0]))[0],
                              device="cuda")
    B = prompts.shape[0]

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t) / reps

    api, p = engine.api, engine.params
    with torch.inference_mode():
        (logits, state), pf_ms = timed(lambda: api.prefill_step(
            p, {"tokens": prompts}, engine.max_len, use_kernel=True), 5)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        base = state["length"]

        def step():
            state["length"] = base  # rewrite the same cache position
            return api.decode_step(p, tok, state, use_kernel=True)
        _, dec_ms = timed(step, 20)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    busy = (f"{sum(e.count for e in kernels)} kernels, device busy "
            f"{dev_ms:.3f} ms = share {dev_ms / dec_ms:.3f} of the "
            f"unprofiled step" if dev_ms > 0 else
            "device time not measured (the profiler saw no kernels)")
    print(f"  wave of {B} x {prompts.shape[1]} tokens: prefill "
          f"{pf_ms:.3f} ms; decode step {dec_ms:.3f} ms = "
          f"{B / dec_ms * 1e3:.1f} tokens/s; {busy}")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:5]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} "
              f"{e.key[:70]}")
    return cfg, params, counts


def full_width_forward(cfg, params):
    """Phase 5c: lm.forward(use_kernel=True) over (4, 2048) tokens (K5 in
    every layer) against ModelAPI.prefill_step (plain flash over the
    cache) on the same tokens: last-position logits within the bf16 bar."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.models.api import ModelAPI
    from repro_torch.models.layers import lm_logits
    gen = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (4, 2048), generator=gen,
                           device="cuda")
    with torch.inference_mode():
        lm.forward(cfg, params, tokens, use_kernel=True)  # warm-up
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        hidden, _, _ = lm.forward(cfg, params, tokens, use_kernel=True)
        got = lm_logits(cfg, params["embed"], hidden[:, -1:]).float()
        torch.cuda.synchronize()
        fwd_ms = 1e3 * (time.perf_counter() - t)
        counts = ops.launch_counts()
        t = time.perf_counter()
        want, _ = ModelAPI(cfg).prefill_step(params, {"tokens": tokens},
                                             2048)
        want = want.float()
        torch.cuda.synchronize()
        pf_ms = 1e3 * (time.perf_counter() - t)
    if counts["flash_attention"] != cfg.num_layers:
        fail(f"flash_attention launched {counts['flash_attention']} times "
             f"in a {cfg.num_layers}-layer forward")
    if not bool(torch.isfinite(got).all()):
        fail("forward(use_kernel=True): non-finite logits")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if err > BF16_PATH_BAR * max(scale, 1.0):
        fail(f"forward(use_kernel=True) vs prefill_step: max |diff| {err:g} "
             f"above {BF16_PATH_BAR} x max(|logit| {scale:g}, 1)")
    print(f"  (4, 2048) tokens: forward with K5 {fwd_ms:.1f} ms, "
          f"prefill_step (plain flash) {pf_ms:.1f} ms; last-position logits "
          f"max |diff| {err:.4g} = {err / max(scale, 1.0):.4f} of max "
          f"|logit| {scale:.4g} (bar {BF16_PATH_BAR}); launches {counts}")
    return counts


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 is float32
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.serve.compile import compile_service
    from repro_torch.serve.simulator import SimConfig, synthetic_pool

    phase("phase 0: card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")

    phase("phase 1: build")
    t = time.perf_counter()
    libs = build.build_all(["onalgo_step", "attention"])
    print(f"  built {', '.join(str(p.relative_to(ROOT)) for p in libs.values())}"
          f" in {time.perf_counter() - t:.1f} s")
    for name in libs:
        print(build.PTXAS_LOG.get(name, f"  ({name}: library already built)"))

    device = torch.device("cuda")
    N, T = 100_000, 512
    sim = SimConfig(num_devices=N, T=T, B_n=0.06, H=0.5 * N * 441e6, seed=0)
    pool = synthetic_pool()
    t = time.perf_counter()
    cs = compile_service(sim, pool, device=device)
    torch.cuda.synchronize()
    print(f"compile_service N={N} T={T} M={cs.space.M}: "
          f"{time.perf_counter() - t:.3f} s")

    phase("phase 2: kernels against their plain versions")
    kernels = check_kernels(cs, device)

    phase("phase 3: the service end to end")
    small_run_matches_cpu(pool)
    launches = run_engines(sim, pool, cs, device)
    phase("phase 3b: where the time goes")
    where_time_goes(sim, pool, cs, device)
    del cs

    phase("phase 4: attention kernels against their plain versions")
    kernels += check_attention()

    phase("phase 5: the cloudlet LM serving path")
    reduced_serving_matches_cpu()
    cfg, params, counts = full_width_serving()
    launches["decode_attention"] = counts["decode_attention"]
    launches["flash_attention"] = full_width_forward(
        cfg, params)["flash_attention"]

    line = {"kernels": [dict(
        name=r["name"], route="cuda", source=SOURCES[r["name"]],
        replaces=REPLACES[r["name"]], launches=launches[r["name"]],
        max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
        library_ms=r.get("library_ms")) for r in kernels]}
    phase("phase 6: kernels line, then the ok line")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
