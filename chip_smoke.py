#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each raises on failure, so the exit code is non-zero):
  0  identify the card (nvidia-smi name and power limit);
  1  build the CUDA kernels from src/repro_torch/kernels/csrc (one nvcc
     per source, all started together) and print the ptxas reports
     (registers, shared memory, spills); the resident and tiled rollout
     kernels and K3 must keep their row partials in registers (no stack,
     no spills); K4 must build with no stack and no spills and run on the
     tensor cores (HMMA instructions in its SASS, from cuobjdump);
  2  hold each kernel against its plain PyTorch version on the card at
     the main path's widths (N=100000 devices, M=73 states, the service
     overlay): the rollouts over T=64 slots resuming at t0=64 with the
     capacity tightened to CHECK_H so the mu reduction is active, and over
     the main path's own call (T=512 from t0=0); equal decisions and visit
     counts, duals within rtol=1e-5, atol=1e-6; time each (CUDA events)
     beside its bound; K1 must take the resident route, and at the main
     path's call it is held against its plain version and timed on both
     routes (resident, streaming) with the per-slot split of each (device
     phase / slot boundary, from block 0's %globaltimer stamps), and on
     the resident route with one shared row of o in place of the (N, M)
     table (what the table's staging costs); K2 (block_n=256) at both
     calls held, repeated bit for bit, split per slot and its kernels a
     call counted (one a slot); then beyond the resident
     size (N=400000, random inputs from a seed): K1 must stream, K2 is
     held at T=64 from t0=64 and at T=512, timed beside K1's streaming
     route; K3 at the state after 64 slots (g_pow bit for bit, load within
     rtol 1e-5, two calls bit for bit, one kernel a call) and at the serve
     loop's N=32, each with its time per call (host work included; the
     kernels line's) and on the device alone (CUDA-graph replay);
  3  run the service end to end (SimConfig N=100000, T=512) on four
     engines — scan (plain torch), chunked (K1), chunked+block_n=256 (K2)
     and the slot loop with use_kernel=True (K3) — with every launch
     count set to 0 just before and read just after each run; metrics
     must agree to rel=2e-5, abs=1e-5, and a small run on the card must
     agree with the same run on the CPU; then the stage times
     (compile_service also by stage, from the program's own spans:
     the draws, the gathers and quantization, the arrival matrix's copy)
     and, from torch.profiler, each
     engine's device time by kernel and its kernels and reductions a slot;
  4  the attention kernels against their plain versions on the card:
     flash_attention (K5) at olmo-1b's shapes (B=4, S=2048, Hq=Hkv=16,
     D=128) causal and full, in bf16 and f32, plus GQA (Hkv=4);
     decode_attention (K6) at B=16, S=4096, D=128, Hq=Hkv=16 with
     cache_len 1 / 1000 / 4096 in bf16 and f32, plus GQA (Hkv=4, and
     G=7 and 8), plus the serving path's own shape; bars
     (kernels/flash_attention.py's TOLERANCE) rtol=atol=2e-5 in f32, the
     reference's
     (tests/test_kernels.py), and two bf16 ulps in bf16 (rtol=1.6e-2,
     atol=1e-4), shown to reject a kernel that drops one key in sixteen;
     each with its time per call (host work included; the kernels
     line's) and on the device alone (CUDA-graph replay), the plain
     version's, the bound and scaled_dot_product_attention's, the route
     (tensor or CUDA cores, K6's split count) and K6's host time per
     call; K6's device time by split count at GQA; ptxas must report no
     spills in the new kernels and no serialized wgmma;
  5  the cloudlet LM serving path (repro_torch.launch.serve): (a) a
     reduced olmo-1b run on the card gives the CPU run's lines and greedy
     tokens; (b) olmo-1b at full width in bf16 at the entry point's
     defaults, with launch counts reset before and read after (K3 once
     per slot, K6 once per layer per decode step), then prefill and
     decode-step times, tokens/s, peak memory and the decode step's
     device-busy share; (c) a full-width lm.forward(use_kernel=True)
     over (4, 2048) tokens launches K5 once per layer and its
     last-position logits agree with ModelAPI.prefill_step's;
  6  the multi-cloudlet topology tier at the service width (N=100000,
     T=512, capacity N/4 tasks per slot, seed 1) under Topology.uniform(1),
     hotspot(4) and the reference's committed mobility_walk(1024,
     p_handover=0.02, seed=3): (a) K1-topo / K2-topo against the plain
     K-vector rollout at K=4 (static), 1024 and 4096 (walks) over T=64
     resumed at t0=64 and over the engine's own T=512 call, timed beside
     their bound, the plain version and scalar K1 / K2 on the same inputs,
     with K1-topo's route (it must be resident) and, at each K's T=512
     call, both routes held against the plain version, timed and split
     per slot; K2-topo split per slot, repeated bit for bit, its kernels a
     call counted (two a slot);
     (b) simulate_service on scan, chunked (K1-topo) and chunked
     block_n=256 (K2-topo) per topology with launch counts: K=1 equals the
     scalar run exactly, K=4 / 1024 engines agree, topo_binned None / True
     / False are identical, some mu_k end above 0; devslots/s and the
     lowering / rollout / admission times;
  7  the Mamba2 path (mamba2-370m: 48 layers, d_model 1024, 32 SSM heads
     x 64, d_state 128, 1 group, bf16): (a) ssd_chunk (K4) against its
     plain version at the (4, 2048) forward's shape (b=4, nc=16, Q=128,
     B and C per group and head-expanded), the serving wave's (b=16,
     nc=1, Q=16) and a ragged chunk (Q=33), within rtol=atol=1e-4 (the
     reference's kernel bar), shown to reject a kernel that drops the
     diagonal of the causal sum, twice bit for bit, each with its plan
     (heads a block), its time per call (host work included; the kernels
     line's) and on the device alone (CUDA-graph replay), beside its
     bound (bytes, or the operations at the tensor cores' tf32 rate taken
     three times), the CUDA-core bound and the plain version; (b) a reduced mamba2-370m serving run on the card
     gives the CPU run's lines and greedy tokens; (c) the entry point's
     loop at full width with --arch mamba2-370m, launch counts reset
     before and read after (K3 once per slot, K4 once per layer per
     prefill, K6 never), with the times, memory and busy share of 5b;
     (d) a full-width lm.forward(use_kernel=True) over (4, 2048) tokens
     launches K4 once per layer and its last-position logits agree with
     the route without the kernel within SSM_BF16_PATH_BAR (and within
     SSM_F32_BAR on a float32 copy of the weights);
  8  the streaming engine (simulate_service(materialize=False)) and the
     draws kernel: (a) the draws kernel against its plain version bit
     for bit (twice equal, one launch a call) at the materialized horizon
     (T=512, N=100000), a 64-slot slab on a block's start and off it,
     the boundary pass at N=10^6, T=256, 8c's slab at N=10^6, the
     mobility walk (K=1024, N=100000, T=512) and the column form at
     N=2^25 (n0=N-1000, 1000 columns, past the 2^32 counter), each with
     its time a call and on the device against its bound (threefry calls
     the data needs x the pipe slots a threefry takes from the SASS, at
     the pipe rate; or the bytes) and the threefry its warps issue, then
     phase 3b's lowering split on the kernel; (b) phase 3's service
     streamed (slab 64, chunk 16) on K1 and K2: every series equal to
     the materialized chunked run's (offloads, admits, tasks exactly, the
     rest within the duals' bar), the slab loop under
     set_sync_debug_mode("error"), a j out of range raising after the
     slab loop with the card working on, metrics equal through
     simulate_service, devslots/s and peak memory; (c) the same at
     benchmarks/bench_fleet_scale.py's N=10^6, T=256 point, with the
     materialized run's peak beside the streamed one's, the streamed K2
     run's busy share (torch.profiler), K2's fixed cost a call, and
     autotune(source=..., slabs=(64, 128)) with its pick; (d) phase 6's
     walk at 0.2 of its capacity streamed (streaming=True, and the
     streaming engine) equal to the materialized walk's run on K1-topo
     and K2-topo;
  9  the scenario engine and the sweeps (repro_torch.scenarios): (a)
     every kind of default_scenarios() (T=2000, N=8) and every catalog
     entry, compiled on the card equal to the CPU, run with run_scenario
     on scan (K3 once a slot), chunked (K1 / K1-topo) and chunked
     block_n=4 (K2 / K2-topo), each run equal to the CPU port's scan at
     the cross-engine bar, one rollout call a kernel run, no offload while
     a fleet-wide outage lasts; (b) at N=100000, T=512 the metro_daily
     chain (scan, K1, K2), the metro_mobility chain (scan, K1-topo,
     K2-topo) and heterogeneous (K1 streams: its h and w are (N, M)), with
     compile seconds, wall, devslots/s, peak memory and route, engines
     agreeing; (c) sweeps with the cell axis, each grid one call of the
     cell-axis K1 / K2 bit for bit against G single-cell calls, its first
     and last cells against the plain version, timed against the loop of
     G calls beside its bound (K1: and its o' floor, its plan's lane
     groups and passes, block 0's slot split), and through
     sweep_simulate(engine="chunked") with launch counts and a sweep's
     wall: (i) 64 cells at N=8, T=4000 (K1), (ii) 16 cells over
     metro_daily at N=8192, T=512 (K1, one resident launch), (iii) the
     same 16 at N=100000 (K2, block_n 256);
 10  the gain tier and the live serving gateway: (a) gain sources at the
     service fleet (N=100000, T=512; pool oracle_pool(synthetic_gain_problem(
     S=16384, C=10)), M=73): TableGain / OverlayGain equal
     gain_source=None (metrics exactly) on K1, K2 (block_n=256), the slot
     loop with K3 and streamed; ModelGain(ridge) resolves on the card to
     the CPU port's tables exactly, ModelGain(seq) (a seeded SSD head,
     K4 once a resolution) within K4's bar; their K1 runs equal the CPU
     port's chunked run (T=32 prefix: decisions exactly, duals at
     rtol=1e-5, atol=1e-6); resolution ms, walls, devslots/s; K4 held at
     the head's shape (b=1, nc=128, Q=128, h=2, p=16, n=8, 1 group) with
     its times and bound; (b) evaluate_regret over GATE_SCENARIOS at the
     catalog's sizes, max_T=600, on the card's scan and chunked engines
     equal to the CPU port's, ridge's mean regret <= 0.15; metro_daily at
     N=100000, T=512 per source on K1 against TableGain; (c) the live
     gateway (GatewayCore.for_sim, gain_source ridge, default_buckets) at
     N=100000 over T=256 slots of ServiceLoadGen(slab=64): the closed loop
     and the pipelined loop at depths 1, 2, 4 give fleet.simulate's
     decisions (collect_decisions, enforce_slot_capacity, overlay,
     use_kernel), K3 once a tick; tick_async never waits for the card
     (sync debug mode "error"; behind a sleep kernel it returns before
     its decisions land); warmup s, the tick's p50 / p99 (dispatch
     and resolve), waves/s, busy share (from a profile that holds every
     tick's K3 record, else not measured); the same under
     mobility_walk(1024, p_handover=0.02, seed=3, streaming=True) at 0.2
     of the capacity on the plain topology route;
     a LiveGateway soak of 200 waves at a 50 ms SLO (no shed, no fallback,
     decisions equal); K3 at the gateway's state held and timed;
 11  the sharded engines on torch.distributed, on a world of one over
     NCCL (launch.mesh.world_of_one, its 1-D mesh over "data"), the
     collectives counted as the kernel launches are: (a)
     simulate_service(engine="sharded") on phase 3's fleet (N=100000,
     T=512) agrees with the scan engine and K1 at the cross-engine bar,
     one all-reduce a slot (T) and three all-gathers, its slot loop under
     sync debug mode "error", with its wall, devslots/s and the NCCL
     kernels' device time a slot (torch.profiler); (b) the same fleet
     under hotspot(4) and the streamed mobility_walk(1024,
     p_handover=0.02, seed=3) at 0.2 of the capacity agrees with the scan
     engine, some mu_k above 0; (c) phase 8c's point (N=10^6, T=256,
     slab 64) on the sharded stream: the shard-local source_cols run
     equals the full-width source run bit for bit, and its metrics the
     streamed K2 run's at the bar, with peak memory and devslots/s; (d)
     GatewayCore.for_sim(mesh=...) at 10c's fleet under the ridge source:
     decisions and final lam equal the unsharded core's bit for bit, K3
     once a tick, one all-reduce and one all-gather a tick, tick_async
     never waiting, the tick's p50 / p99 beside the unsharded core's, the
     pipelined loop at depth 2; the process group destroyed at the end;
 12  the rest of the model zoo (MoE, hybrid Jamba, encoder-decoder, VLM
     prefix; 12 at most about 150 s): (a) every architecture of the
     registry at reduced() in float32 (olmoe also dropless), weights drawn
     on the CPU and copied: ModelAPI.prefill_step + 4 greedy decode_steps
     on the card with use_kernel against the CPU's plain versions, the
     same greedy tokens and logits within ZOO_F32_BAR, then a reduced
     olmoe-1b-7b serving run giving the CPU's lines and tokens (as 5a);
     (b) 5b's loop for olmoe-1b-7b at its defaults and for
     jamba-v0.1-52b at its widths over 16 of its 32 layers (two pattern
     instances), launch counts exact (K3 once a slot, K6 once per
     attention layer per decode step, K4 once per Mamba layer per
     prefill), times, peak, busy share and host syncs a decode step; (c)
     ZOO_ON_CARD through ModelAPI in bf16 (yi-9b, command-r-35b,
     internvl2-1b with 256 prefix rows and max_len a multiple of 128,
     seamless-m4t-medium over 512 source frames, deepseek-67b over 40 of
     95 layers, arctic-480b over 2 of 35): one prefill of 4 prompts and
     8 decode steps on the same tokens with and without the kernels,
     logits within BF16_PATH_BAR (an MoE row held up to its first routing
     flip between the routes), launch counts, the cross-attention's
     route, times and peak; each model freed before the next;
 13  training and data (the loss takes the plain routes, as the
     reference's; no kernel has a backward): (a) the reduced olmo-1b,
     mamba2-370m, olmoe-1b-7b, jamba-v0.1-52b and seamless-m4t-medium
     take 3 AdamW steps (make_train_step) on the card and on the CPU from
     the same weights and tokens: step-1 gradients within TRAIN_BAR of
     max |leaf|, losses at rtol TRAIN_BAR, parameters after the steps
     within TRAIN_PARAM_BAR of the summed learning rates (held up to an
     MoE routing flip), no kernel
     launched; a kernel route (use_kernel=True) given trainable
     parameters raises; (b) olmo-1b at full width (bf16, remat "full",
     AdamW, launch.train's schedule) 6 steps on token_stream(batch=8,
     seq_len=128), then the same with accum_steps=2, and mamba2-370m at
     full width 4 steps: step ms (median of steps 2..), tokens/s, busy
     share (a profiled extra step), peak memory, the loss each step (the
     first near ln V + d_model*0.02^2/2, the first batch lower after the
     steps); (c) python -m repro_torch.launch.train --arch olmo-1b
     --reduced on the card in a temporary directory: a run, a resumed run
     whose history continues, a SIGTERM mid-run that saves at the step
     boundary, the card's checkpoint restored on the CPU and a CPU run's
     restored on the card, leaf for leaf; (d) make_scenario("easy") and
     ("hard") with the classifiers trained on the card: accuracies and
     cloudlet gap within the reference's bands; the hard pool served on
     the card by the scan engine with K3, K1 and K2 at T=240: each
     engine's series equal to the CPU's same engine on the same pool (the
     scan engine's masks device for device), K1 == K2, the slots where
     scan and K1 part (C9) the same on the card and the CPU; K3 / K1 / K2
     counts; (e) default_sources(with_seq=True) on the card: the SSD head
     trains (no K4 in its steps, one in its sigma pass), resolves through
     K4, and scenario_regret runs over it; K4's count;
 14  the dry run (launch/dryrun.py), the sharding rules and the
     roofline: (a) the cells of DRYRUN_CELLS traced at full width on a
     fake 16x16 cuda mesh, one process each (olmo-1b train_4k,
     prefill_32k, decode_32k; mamba2-370m long_500k; olmoe-1b-7b
     decode_32k with its all-to-alls; yi-9b long_500k skipped): status,
     trace seconds, per-chip argument and temporary bytes against HW's
     HBM, the three roofline terms, the collectives, the roofline table;
     (b) olmo-1b on a (1, 1) mesh over a world of one (NCCL) at
     launch/train.py's 8 x 128 training step, a 4 x 2048 prefill and a
     16-prompt decode step against a 2048-row cache: the record's flops
     == FlopCounterMode's count of the real step, argument bytes == the
     real arguments', the predicted peak within PEAK_BAR of
     max_memory_allocated, the roofline's largest term no larger than the
     measured step; the kernel route's time and K5 / K6 launches beside
     it; (c) pipeline_apply over the world of one (S = 1, 8
     microbatches) == the stage in sequence; HW's HBM size against the
     card's; the phase under 150 s;
 15  print the kernels line (JSON), then the ok line (JSON) last.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.launch.dryrun import HW  # noqa: E402  the card's peaks


def use_tree(root):
    """Import ``repro_torch`` from the checkout at ``root`` from here on:
    its src first on the path, and the package that this module loaded
    from its own checkout (for HW) dropped, so that an A/B script's
    process measures the tree it was given."""
    sys.path.insert(0, str(Path(root) / "src"))
    for name in [m for m in sys.modules
                 if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]


HBM_BYTES_PER_S = HW["hbm_bw"]  # H100 SXM published peak
F32_OPS_PER_S = HW["peak_flops_f32"]  # published f32 peak, no tensor cores
RTOL, ATOL = 1e-5, 1e-6  # duals: the reference's kernel-vs-oracle bar
REL, ABS = 2e-5, 1e-5  # service metrics: the reference's cross-engine bar
# Dual-space capacity of the kernel checks: at the Fig. 5 ratio of H to
# demand the capacity never binds (mu stays 0); at 0.2 of it, it does.
CHECK_H = 0.2
METRICS = ("accuracy", "offload_frac", "admit_frac", "avg_power_per_dev",
           "avg_load", "avg_delay_ms", "tasks", "mu_final")
# kernel -> (its library, built from src/repro_torch/kernels/csrc/<library>.cu;
#            the TPU kernel it replaces)
PORTED = {
    "onalgo_chunked": ("onalgo_step", "src/repro/kernels/onalgo_step.py:371"),
    "onalgo_tiled": ("onalgo_step", "src/repro/kernels/onalgo_step.py:667"),
    "onalgo_chunked_topo": ("onalgo_step",
                            "src/repro/kernels/onalgo_step.py:196"),
    "onalgo_tiled_topo": ("onalgo_step",
                          "src/repro/kernels/onalgo_step.py:549"),
    "onalgo_duals": ("onalgo_step", "src/repro/kernels/onalgo_step.py:42"),
    "flash_attention": ("attention",
                        "src/repro/kernels/flash_attention.py:67"),
    "decode_attention": ("attention",
                         "src/repro/kernels/decode_attention.py:58"),
    "ssd_chunk": ("ssd_chunk", "src/repro/kernels/ssd_chunk.py:50"),
    # the cell axis of K1 and K2: what jax.vmap makes of the two Pallas
    # kernels in the chunked sweep (src/repro/scenarios/sweeps.py:105-116)
    "onalgo_chunked_cells": ("onalgo_step",
                             "src/repro/kernels/onalgo_step.py:371"),
    "onalgo_tiled_cells": ("onalgo_step",
                           "src/repro/kernels/onalgo_step.py:667"),
    # no pallas_call behind it: the reference's XLA fuses the draws into
    # its jitted lowering, first of all here
    "draws": ("draws", "src/repro/workload/service.py:63"),
}
REPLACES = {name: replaces for name, (_, replaces) in PORTED.items()}
SOURCES = {name: f"src/repro_torch/kernels/csrc/{lib}.cu"
           for name, (lib, _) in PORTED.items()}
LIBRARIES = sorted({lib for lib, _ in PORTED.values()})
# Peak operation rates by input type (H100 SXM, dense): the attention
# kernels' products of bf16 inputs could run on the tensor cores, float32
# ones only on the CUDA cores.
PEAK_OPS = {"bfloat16": HW["peak_flops_bf16"], "float32": F32_OPS_PER_S}
# K4 runs its float32 products on the tensor cores as three tf32 products
# each (3xTF32; csrc/ssd_chunk.cu): 495 TFLOP/s dense tf32 over 3.
TF32X3_OPS_PER_S = 495e12 / 3
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
# Phase 12c holds the zoo's kernel routes to the same bar: on the CPU, at
# the published depths and head layouts and narrower widths, the routes'
# logits differ by 0.011-0.051 of max(|logit|, 1)
# (scripts/zoo_bf16_bar_cpu.py).
# Phase 7d: the K4 route and the plain route of mamba2-370m compute the
# same function.  In bfloat16 the plain route rounds x * dt, L, the scores
# and the decays to bf16 before its within-chunk products (the reference's
# numerics, models/ssm.py), the K4 route keeps them in float32, so each of
# 48 layers enters a difference of about 2^-8 of its output, and a
# random-weight SSM stack amplifies it about a hundredfold.  On the CPU
# (bf16, (2, 256) tokens, state 128, head dim 64, random weights) the two
# routes' last-position logits differed by 0.35 of max |logit| at d_model
# 1024 with 48 layers, 0.31-0.46 at 256-512 with 48, 0.19 at 512 with 24,
# 0.06 at 1024 with 12; bf16 against float32 of one route by as much
# (0.32-0.45 at 48 layers).  The bar, 0.75 of max(max |logit|, 1), holds
# what rounding can do and fails garbage or non-finite logits.  The same
# weights in float32 take the K4 route's arithmetic through all 48 layers:
# there the routes differ by summation order only (K4's sums against the
# cuBLAS products of the plain route; on the CPU, where both routes reach
# the same matrix products, by exactly 0).  On an H100 (80GB HBM3, 700 W)
# they differed by 1.8e-4 of max |logit|; that bar is 1e-2, fifty times
# that and thirty times below what bf16 rounding alone does.
SSM_BF16_PATH_BAR = 0.75
SSM_F32_BAR = 1e-2
# Phase 8: benchmarks/bench_fleet_scale.py's N=10^6 point (_horizon(10^6)).
FLEET_N, FLEET_T = 1_000_000, 256
# The draws kernel's bound by operations, from the issue rates of an
# H100 SXM's SM: each of its 4 sub-partitions issues one warp instruction
# a clock, to a pipe of 16 lanes: the ALU pipe (integer add, logic,
# shifts, compares, selects) or the FMA pipe (float32 arithmetic and the
# integer multiply-adds, IMAD and its forms, which the compiler also uses
# for moves and adds).  So a pipe takes 64 lanes an SM a clock, a quarter
# of F32_OPS_PER_S (128 float32 lanes, an FMA counted as two), and the
# issue 128.  A threefry's time is at least the larger of its ALU-pipe
# and its FMA-pipe instructions, and of half of all it issues, at the
# pipe rate (phase 8a counts them from the SASS).
PIPE_OPS_PER_S = F32_OPS_PER_S / 4
ALU_PIPE = {"IADD3", "LOP3", "SHF", "LEA", "PRMT", "ISETP", "FSETP", "SEL",
            "FSEL", "IMNMX", "FMNMX", "PLOP3", "IABS", "BMSK", "SGXT"}
FMA_PIPE = {"IMAD", "IMUL", "FFMA", "FMUL", "FADD"}
# The draws kernel's instructions a threefry-2x32, by hand: 20 rounds of
# add, rotate and xor, 5 key injections of two adds, the two initial adds
# and the float conversion, about 80, at most two thirds of them on one
# pipe; phase 8a takes the counts from the SASS instead where it finds
# the rotates.
THREEFRY_HAND_OPS = 80
DRAWS_SLAB_KERNEL = "draws_kernelILb1ELb0E"  # draws_kernel<true, false>


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


def device_ms(fn, reps):
    """Device time of fn() in ms: reps calls captured in one CUDA graph and
    replayed between two events, so no host work sits between them (the
    per-call time_ms counts the wrapper's host work as well)."""
    import torch
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps=200):
    """Host time of one fn() call in microseconds: reps calls enqueued
    back to back (the device catches up afterwards), so this is what the
    wrapper and the launch cost the host, the decode loop's bottleneck."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return 1e6 * dt / reps


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


def topo_rollout_cost(T, N, M, o_rows, K, assoc_tv):
    """``rollout_cost`` with the topology's inputs and outputs in place of
    the scalar mu0 and H in and mu_seq (T,) and mu out: assoc ((T, N) or
    (N,) int32), H_k and mu0 (K,) read; mu_seq (T, K) and mu (K,)
    written.  Operations: 2 more per (slot, device) (the price gather
    and the cloudlet sum) and 5 per (slot, cloudlet) (the mu_k ascent and
    its square).  The per-block partial rows are the kernel's own
    traffic, not the function's, so they are reported beside the bound,
    not in it."""
    nbytes, nops = rollout_cost(T, N, M, o_rows)
    nbytes += (4 * (T * N if assoc_tv else N) + 8 * K + 4 * T * K + 4 * K
               - (8 + 4 * T + 4))
    return nbytes, nops + 2 * T * N + 5 * T * K


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


def slot_split(stamps, route, topo):
    """(µs a slot, {interval: mean µs}) from a rollout's per-slot stamps
    (block 0's %globaltimer; onalgo_step.SLOT_SPLIT names the intervals;
    the one named "device phase..." is the device phase, the rest the
    slot boundary).  A tiled rollout's last interval of slot s ends at
    slot s + 1's first stamp, so its last slot is left out."""
    from repro_torch.kernels import onalgo_step as k
    labels = k.SLOT_SPLIT[route, topo]
    st = stamps.double().cpu()
    if route == "tiled":
        st = st[:-1]
    n = len(labels)
    means = ((st[:, 1:n + 1] - st[:, :n]) / 1e3).mean(0).tolist()
    per_slot = float(st[-1, n] - st[0, 0]) / 1e3 / st.shape[0]
    return per_slot, dict(zip(labels, means))


def split_text(per_slot, parts):
    dev = next(k for k in parts if k.startswith("device phase"))
    return (f"{per_slot:.2f} us a slot: {dev} {parts[dev]:.2f} / slot "
            f"boundary {sum(parts.values()) - parts[dev]:.2f} ("
            + ", ".join(f"{k} {v:.2f}" for k, v in parts.items() if k != dev)
            + ")")


# The kernel torch.cuda._sleep launches: profiled() brackets fn() with it.
SPIN_KERNEL = "spin_kernel"


def profiled(fn):
    """fn() under torch.profiler: {CUDA kernel name: (count, device ms)}.
    The window stays open 0.1 s past the synchronize so that the tracer
    can deliver the last kernels' records (with no pause, a T=512 call of
    K2 once counted 405 of its 512), and fn()'s kernels sit between two
    spin kernels (SPIN_KERNEL), so that neither the first nor the last
    record of the window is one of them (a lone kernel's record was
    sometimes missing)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        fn()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.1)
    return {e.key: (e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def kernels_per_call(fn, family, expect=None, tries=3):
    """How many CUDA kernels whose name holds ``family`` one fn() enqueues,
    counted by torch.profiler (``profiled``; its spin kernels left out).
    The profiler now and then loses a record (a T=512 K2-topo call once
    counted 1003 of its 1024 kernels) but never adds one, so this takes
    the largest count of up to ``tries`` profiles, stopping once it
    reaches ``expect``."""
    best = 0
    for _ in range(tries):
        best = max(best, sum(count for key, (count, _) in profiled(fn).items()
                             if family in key and SPIN_KERNEL not in key))
        if expect is not None and best >= expect:
            break
    return best


def tiled_run(label, kern, args, T, topo, reps, want):
    """K2 / K2-topo (``kern`` takes stamps=): held against ``want`` (the
    plain version's result on the same inputs), two launches
    bit-identical, timed (CUDA events, per call), split per slot and the
    kernels one call enqueues counted (T for K2, 2 T for K2-topo).
    Returns a dict with the plan and the count."""
    import torch
    from repro_torch.kernels import onalgo_step as k
    wrapper = k.onalgo_tiled_topo_cuda if topo else k.onalgo_tiled_cuda
    stamps = torch.zeros((T, k.STAMPS), dtype=torch.int64, device="cuda")
    got = kern(*args(), stamps=stamps)
    again = kern(*args())
    torch.cuda.synchronize()
    err = hold(label, got, want)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        fail(f"{label}: two launches differ")
    ms = time_ms(kern, args, reps)
    per_slot, parts = slot_split(stamps, "tiled", topo)
    plan = wrapper.plan
    n_k = kernels_per_call(lambda: kern(*args()), "onalgo_tiled",
                           expect=(2 if topo else 1) * T)
    if n_k != (2 if topo else 1) * T:
        fail(f"{label}: one call enqueued {n_k} tiled kernels for T={T} "
             f"slots")
    print(f"    {label} ({plan.counts} counts, grid {plan.grid} x "
          f"{plan.threads}, units of {plan.unit_tiles} tile(s) in "
          f"{plan.passes} pass(es), {plan.smem} B shared; {n_k} kernels a "
          f"call): 0 decision / 0 count mismatches, repeat identical, max "
          f"|diff| {err:.3g}; {ms:.3f} ms; " + split_text(per_slot, parts))
    return dict(ms=ms, per_slot=per_slot, split=parts, max_abs_err=err,
                plan=plan, kernels=n_k)


def hold(name, got, want):
    """A rollout kernel's outputs against its plain version's: equal
    decisions and visit counts, duals within RTOL / ATOL.  Returns the
    duals' max |diff|."""
    n_off = int((got[0] != want[0]).sum())
    n_cnt = int((got[5] != want[5]).sum())
    if n_off or n_cnt:
        fail(f"{name}: {n_off} decision and {n_cnt} count mismatches")
    return max(check_close(f"{name} {what}", got[i], want[i])
               for i, what in ((1, "mu_seq"), (2, "lnorm"), (3, "lam"),
                               (4, "mu")))


def split_run(label, kern, args, T, topo, reps, want, route):
    """The rollout kernel ``kern`` (taking stamps= and the wrappers'
    _streaming test hook) on ``route``: its result held against ``want``
    (the plain version's on the same inputs), its plan, time and per-slot
    split.  Returns a dict."""
    import torch
    from repro_torch.kernels import onalgo_step as k
    wrapper = k.onalgo_chunked_topo_cuda if topo else k.onalgo_chunked_cuda
    kw = dict(_streaming=route == "streaming")
    stamps = torch.zeros((T, k.STAMPS), dtype=torch.int64, device="cuda")
    got = kern(*args(), stamps=stamps, **kw)
    torch.cuda.synchronize()
    plan = wrapper.plan
    if plan.route != route:
        fail(f"{label}: took the {plan.route} route, not {route} "
             f"({plan.why})")
    err = hold(f"{label} ({route})", got, want)
    ms = time_ms(lambda *a: kern(*a, **kw), args, reps)
    per_slot, parts = slot_split(stamps, route, topo)
    print(f"    {label} on the {route} route (grid {plan.grid} x "
          f"{plan.warps} warps): 0 decision / 0 count mismatches, max "
          f"|diff| {err:.3g}; {ms:.3f} ms; " + split_text(per_slot, parts))
    return dict(ms=ms, grid=plan.grid, warps=plan.warps, per_slot=per_slot,
                split=parts, max_abs_err=err)


def routes(label, kern, args, T, topo, reps, want):
    """``split_run`` on each route at the same inputs.  Returns
    {route: dict}."""
    return {route: split_run(label, kern, args, T, topo, reps, want, route)
            for route in ("resident", "streaming")}


def rollout_inputs(cs, device, cap=1.0):
    """The rollout kernels' operands on the main path (dual space), with
    the capacity scaled by ``cap``."""
    from repro_torch.core import onalgo
    from repro_torch.core.fleet import _overlay_slot_values

    o_tab, h_tab, w_tab = cs.tables
    o_s, h_s, B1, H1 = onalgo.precondition_tables(o_tab, h_tab, cs.params)
    sv = _overlay_slot_values(cs.overlay, cs.params)
    return (o_s, h_s, w_tab, B1, H1 * cap, cs.rule.a, cs.rule.beta), sv


def check_rollouts(cs, n_slots, t0, cap, device, reps, detail=False):
    """K1 and K2 against their plain version on slots (t0, t0 + n_slots]
    of the compiled service, resuming from the plain version's state after
    t0 slots; K1 must take the resident route; K2 is split per slot and
    its kernels a call counted.  With ``detail`` K1 is also timed, split
    and held against the plain version on both routes, and on the
    resident route with one shared row of o in place of the (N, M) table
    (a different rollout: the same work less the table's staging).
    Returns {name: result dict} and that state."""
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
    head = f"T={n_slots} N={N} M={M} t0={t0} H x{cap}"
    o_rows = N if fixed[0].ndim == 2 else 0
    results = {}

    name = "onalgo_chunked"
    kern = lambda *a, **kw: k.onalgo_chunked_cuda(*a, t0=t0, slot_values=sv_w,
                                                  **kw)
    got = kern(*rollout_args())
    torch.cuda.synchronize()
    plan = k.onalgo_chunked_cuda.plan
    if plan.route != "resident":
        fail(f"onalgo_chunked took the {plan.route} route at N={N} M={M} "
             f"T={n_slots} ({plan.why})")
    err = hold(name, got, want)
    ms = time_ms(kern, rollout_args, reps=reps)
    results[name] = r = dict(name=name, max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             T=n_slots, t0=t0, mu_final=float(got[4]))
    print(f"  {name}: {head}: {plan.route} route (grid {plan.grid} x "
          f"{plan.warps} warps, {plan.smem} B shared); 0 decision / 0 count "
          f"mismatches, max |diff| {err:.3g}, mu {float(got[4]):.6g}; kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
          f"({b_by})")
    if detail:
        r["routes"] = routes(name, kern, rollout_args, n_slots, False, reps,
                             want)
        o_row = (fixed[0][0].contiguous(), *fixed[1:])
        shared_args = lambda: (j_w, lam0.clone(), mu0.clone(),
                               counts0.clone(), *o_row)
        r["o_shared"] = split_run(
            f"{name} with o shared (M,)", kern, shared_args, n_slots, False,
            reps, plain(*shared_args()), "resident")
        r["max_abs_err"] = max([err, r["o_shared"]["max_abs_err"]]
                               + [x["max_abs_err"]
                                  for x in r["routes"].values()])

    name = "onalgo_tiled"
    print(f"  {name} (block_n=256): {head}:")
    r = tiled_run(
        name, lambda *a, **kw: k.onalgo_tiled_cuda(
            *a, block_n=256, t0=t0, slot_values=sv_w, **kw),
        rollout_args, n_slots, False, reps, want)
    results[name] = dict(
        name=name, max_abs_err=r["max_abs_err"], ms=r["ms"],
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, T=n_slots, t0=t0,
        per_slot=r["per_slot"], split=r["split"], kernels=r["kernels"])
    print(f"  {name}: kernel {r['ms']:.3f} ms, plain {plain_ms:.3f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}), streaming floor "
          f"{tiled_floor_ms(n_slots, N, M, o_rows, r['plan']):.3f} ms")
    return results, (lam0, mu0, counts0, t0, fixed)


def tiled_floor_ms(T, N, M, o_rows, plan, K=0, assoc_tv=False):
    """K2's / K2-topo's own bytes a call at the HBM rate: each slot reads
    the ``o_rows`` rows of o (N, or 0 when o is (M,)) and the count rows
    of the call's scratch
    (uint16 or float32 in rows of plan.stride), j and the three overlay
    streams (and a time-varying assoc), lam and B, writes lam, the visited
    counts and off; K2-topo also writes and reads its tile K-rows."""
    esize = 2 if plan.counts == "uint16" else 4
    per_slot = (4 * M * o_rows + N * plan.stride * esize + 16 * N + 8 * N + 4 * N
                + esize * N + N + (4 * N if assoc_tv else 0))
    if K:
        per_slot += 2 * 8 * K * -(-N // 256)
    return 1e3 * T * per_slot / HBM_BYTES_PER_S


def streaming_size_check(device, N=400_000, M=73, T=512, seed=17):
    """Phase 2, beyond the resident size: random inputs from ``seed`` at
    N=400000, M=73 with the overlay (j and the overlay streams 3.3 GB on
    the card).  K1 must take its streaming route there; K2 (block_n=256)
    is held against the plain version over T=64 slots resumed at t0=64
    and over the whole T=512 call from t0=0, where K2 and K1's streaming
    route are timed on the same inputs (K1 held too).  Returns K2's
    largest duals |diff|."""
    import torch
    from repro_torch.kernels import onalgo_step as k
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rand = lambda *shape: torch.rand(shape, generator=gen, device=device)
    j = torch.randint(0, M, (T, N), generator=gen, device=device,
                      dtype=torch.int32)
    sv = (rand(T, N), rand(T, N), rand(T, N) - 0.1)
    fixed = (rand(N, M), rand(M), rand(M) - 0.2, rand(N) + 0.05,
             torch.tensor(0.02 * N, device=device), 0.4, 0.5)
    lam0 = rand(N) * 0.1
    torch.cuda.synchronize()
    errs = []
    for t0, n_slots in ((64, 64), (0, T)):
        if t0:
            _, _, _, lam, mu, counts = k.onalgo_chunked_plain(
                j[:t0], lam0, 0.05, torch.zeros((N, M), device=device),
                *fixed, t0=0, slot_values=tuple(x[:t0] for x in sv))
        else:
            lam, mu, counts = lam0, torch.tensor(0.05, device=device), \
                torch.zeros((N, M), device=device)
        j_w = j[t0:t0 + n_slots].contiguous()
        sv_w = tuple(x[t0:t0 + n_slots].contiguous() for x in sv)
        args = lambda: (j_w, lam.clone(), mu.clone(), counts.clone(), *fixed)
        want = k.onalgo_chunked_plain(*args(), t0=t0, slot_values=sv_w)
        label = f"N={N} M={M} T={n_slots} t0={t0}"
        run = tiled_run(f"onalgo_tiled {label}", lambda *a, **kw:
                        k.onalgo_tiled_cuda(*a, block_n=256, t0=t0,
                                            slot_values=sv_w, **kw),
                        args, n_slots, False, 3, want)
        errs.append(run["max_abs_err"])
        if t0:
            continue
        k1 = lambda *a: k.onalgo_chunked_cuda(*a, t0=t0, slot_values=sv_w)
        got = k1(*args())
        torch.cuda.synchronize()
        plan = k.onalgo_chunked_cuda.plan
        if plan.route != "streaming":
            fail(f"onalgo_chunked took the {plan.route} route at {label}, "
                 f"beyond the resident size")
        hold(f"onalgo_chunked {label} (streaming)", got, want)
        k1_ms = time_ms(k1, args, 3)
        print(f"  {label}: K2 {run['ms']:.3f} ms, K1 on its streaming "
              f"route ({plan.why}) {k1_ms:.3f} ms, K2's streaming floor "
              f"{tiled_floor_ms(n_slots, N, M, N, run['plan']):.3f} ms")
    del j, sv, fixed
    return max(errs)


def check_duals(state):
    """K3 against its plain version at a rollout state: g_pow bit for bit,
    load within rtol 1e-5, two calls bit for bit, one kernel a call; its
    time per call and on the device, then the same at the serve loop's
    N=32 (random inputs from a seed)."""
    import torch

    lam0, mu0, counts0, t0, fixed = state
    o_s, h_s, w_tab, B1 = fixed[:4]
    duals = (lam0, mu0, counts0 * float(1.0 / t0), o_s, h_s, w_tab, B1)
    row = duals_row("N=100000 (the state after 64 slots)", duals, reps=50)
    gen = torch.Generator(device="cuda").manual_seed(32)
    N, M = 32, counts0.shape[1]
    f = lambda *shape: torch.rand(shape, generator=gen, device="cuda")
    rho = f(N, M)
    small = (f(N), torch.tensor(0.3, device="cuda"), rho / rho.sum(1, True),
             f(N, M), f(M), f(M) - 0.2, f(N) + 0.05)
    duals_row("N=32 (the serve loop's fleet)", small, reps=200)
    return row


def duals_row(label, duals, reps, count_kernels=True):
    """One K3 check (see check_duals); returns the kernels line's row.
    ``count_kernels=False`` leaves out the profiler's count of kernels a
    call (phase 2 holds it; late in a run the profiler has been seen to
    record none of a call's kernels: phase 8a's draws, 10c's K3)."""
    import torch
    from repro_torch.kernels import onalgo_step as k
    N, M = duals[2].shape
    g_want, l_want = k.onalgo_duals_plain(*duals)
    g_got, l_got = k.onalgo_duals_cuda(*duals)
    g_two, l_two = k.onalgo_duals_cuda(*duals)
    if not torch.equal(g_got, g_want):
        fail(f"onalgo_duals {label}: g_pow differs from the plain version's "
             f"(max |diff| {float((g_got - g_want).abs().max()):g})")
    if not (torch.equal(g_got, g_two) and torch.equal(l_got, l_two)):
        fail(f"onalgo_duals {label}: two calls differ")
    err = max(check_close("onalgo_duals g_pow", g_got, g_want),
              check_close("onalgo_duals load", l_got, l_want, atol=0.0))
    if count_kernels:
        n_kernels = kernels_per_call(lambda: k.onalgo_duals_cuda(*duals), "",
                                     expect=1)
        if n_kernels != 1:
            fail(f"onalgo_duals {label}: {n_kernels} kernels a call, not 1")
    ms = time_ms(k.onalgo_duals_cuda, lambda: duals, reps=reps)
    dev = device_ms(lambda: k.onalgo_duals_cuda(*duals), reps)
    plain_ms = time_ms(k.onalgo_duals_plain, lambda: duals, reps=10)
    b_ms, b_by = bound_ms(*duals_cost(N, M, duals[3].shape[0]))
    print(f"  onalgo_duals {label}: M={M}: g_pow equal, load max |diff| "
          f"{err:.3g}{', 1 kernel a call' if count_kernels else ''}; "
          f"kernel {ms:.4f} ms a call, "
          f"{dev:.4f} ms on the device; plain {plain_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})")
    return dict(name="onalgo_duals", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                device_ms=dev)


def check_kernels(cs, device):
    """Phase 2: each kernel against its plain version on the card.

    The rollouts run twice: over slots 65..128 resuming at t0=64 with the
    capacity tightened (CHECK_H), and over the main path's own call (all
    T slots from t0=0, the path's capacity), whose times the kernels line
    reports, where K1 is also split and timed on both routes and K2 on
    three launch modes; then K2 beyond the resident size
    (streaming_size_check).  K3 runs at the state after 64 slots."""
    resumed, state = check_rollouts(cs, 64, 64, CHECK_H, device, reps=10)
    path, _ = check_rollouts(cs, cs.sim.T, 0, 1.0, device, reps=3,
                             detail=True)
    for name, r in path.items():
        r["max_abs_err"] = max(r["max_abs_err"],
                               resumed[name]["max_abs_err"])
    big = streaming_size_check(device)
    path["onalgo_tiled"]["max_abs_err"] = max(
        path["onalgo_tiled"]["max_abs_err"], big)
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
    lowering_stages(sim, pool, device)
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
        launches = sum(e.count for e in kernels)
        reductions = sum(e.count for e in kernels if "reduce" in e.key)
        print(f"  {label}: rollout {roll_ms:.2f} ms, metrics fold "
              f"{fold_ms:.2f} ms; {busy}; {launches / sim.T:.2f} kernels "
              f"and {reductions / sim.T:.2f} reductions a slot")
        for e in sorted(kernels, key=dev_us, reverse=True)[:4]:
            print(f"    {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} "
                  f"{e.key[:70]}")


def lowering_stages(sim, pool, device):
    """compile_service's time by stage, from the program's own spans
    (``repro_torch.obs``): one call under a CPU-activity torch.profiler,
    each span's host ms and device ms (the stream's time between its
    events), and the host syncs of the call.  Nothing synchronizes around
    the stages: the lowering runs as the entry point calls it."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import obs
    from repro_torch.serve.compile import compile_service

    obs.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        compile_service(sim, pool, device=device)
    rep = obs.report()
    obs.reset()
    print("  compile_service by span (host / device ms): " + ", ".join(
        f"{name} {s['host_ms']:.2f} / {s['device_ms']:.2f}"
        for name, s in rep["spans"].items())
        + f"; {rep['host_syncs']} host syncs")


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
        if kernel == "onalgo_chunked":
            from repro_torch.kernels import onalgo_step as k
            plan = k.onalgo_chunked_cuda.plan
            print(f"    K1 on the {plan.route} route, grid {plan.grid}")
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


def check_topo_rollouts(cs, topo, n_slots, t0, cap, device, reps,
                        detail=False):
    """K1-topo and K2-topo against the plain K-vector rollout on slots
    (t0, t0 + n_slots] of the compiled service under ``topo`` with every
    capacity scaled by ``cap``, resuming from the plain version's state
    after t0 slots, plus scalar K1 / K2 on the same inputs for
    comparison; K1-topo must take the resident route; K2-topo is split
    per slot and its kernels a call counted.  With ``detail`` K1-topo is
    also timed, split and held against the plain version on both
    routes.  Returns {name: result dict}."""
    import torch
    from repro_torch.core import onalgo
    from repro_torch.kernels import onalgo_step as k

    j = cs.trace.j_idx
    N, M, K = j.shape[1], cs.space.M, topo.K
    fixed, sv = rollout_inputs(cs, device, cap)
    H_k = onalgo.precondition_capacities(topo.H_k, cs.params) * cap
    assoc = (lambda a, b: topo.assoc[a:b].contiguous()) if \
        topo.time_varying else (lambda a, b: topo.assoc)
    lam0 = torch.zeros(N, device=device)
    mu0 = torch.zeros(K, device=device)
    counts0 = torch.zeros((N, M), device=device)
    if t0:
        _, _, _, lam0, mu0, counts0 = k.onalgo_chunked_plain(
            j[:t0], lam0, mu0, counts0, *fixed, t0=0,
            slot_values=tuple(x[:t0] for x in sv), assoc=assoc(0, t0),
            H_k=H_k)
    win = slice(t0, t0 + n_slots)
    j_w = j[win].contiguous()
    sv_w = tuple(x[win].contiguous() for x in sv)
    a_w = assoc(t0, t0 + n_slots)

    def args(mu=mu0):
        return (j_w, lam0.clone(), mu.clone(), counts0.clone(), *fixed)

    topo_kw = dict(t0=t0, slot_values=sv_w, assoc=a_w, H_k=H_k)
    plain = lambda *a: k.onalgo_chunked_plain(*a, **topo_kw)
    want = plain(*args())
    plain_ms = time_ms(plain, args, reps=2)
    b_ms, b_by = bound_ms(*topo_rollout_cost(n_slots, N, M, fixed[0].shape[0],
                                             K, topo.time_varying))
    scalar_mu = torch.zeros((), device=device)
    scalar_ms = {
        "onalgo_chunked_topo": time_ms(lambda *a: k.onalgo_chunked_cuda(
            *a, t0=t0, slot_values=sv_w), lambda: args(scalar_mu), reps),
        "onalgo_tiled_topo": time_ms(lambda *a: k.onalgo_tiled_cuda(
            *a, block_n=256, t0=t0, slot_values=sv_w),
            lambda: args(scalar_mu), reps)}
    head = f"K={K} T={n_slots} N={N} M={M} t0={t0} H x{cap}"
    results = {}

    name = "onalgo_chunked_topo"
    kern = lambda *a, **kw: k.onalgo_chunked_topo_cuda(*a, **topo_kw, **kw)
    got = kern(*args())
    again = kern(*args())
    torch.cuda.synchronize()
    plan = k.onalgo_chunked_topo_cuda.plan
    if plan.route != "resident":
        fail(f"{name} K={K} took the {plan.route} route at N={N} M={M} "
             f"T={n_slots} ({plan.why})")
    err = hold(f"{name} K={K}", got, want)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        fail(f"{name} K={K}: two runs of the kernel differ")
    ms = time_ms(kern, args, reps=reps)
    live = int((got[4] > 0).sum())
    results[name] = r = dict(name=name, max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             scalar_ms=scalar_ms[name], live=live,
                             route=plan.route, grid=plan.grid)
    print(f"  {name}: {head}: {plan.route} route (grid {plan.grid} x "
          f"{plan.warps} warps); 0 decision / 0 count mismatches, repeat "
          f"identical, max |diff| {err:.3g}, {live} of {K} mu_k > 0; kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
          f"({b_by}), scalar onalgo_chunked {scalar_ms[name]:.3f} ms")
    if detail:
        r["routes"] = routes(f"{name} K={K}", kern, args, n_slots, True,
                             reps, want)
        r["max_abs_err"] = max([err] + [x["max_abs_err"]
                                        for x in r["routes"].values()])

    name = "onalgo_tiled_topo"
    print(f"  {name} (block_n=256): {head}:")
    run = tiled_run(f"{name} K={K}", lambda *a, **kw:
                    k.onalgo_tiled_topo_cuda(*a, block_n=256, **topo_kw,
                                             **kw),
                    args, n_slots, True, reps, want)
    live = int((want[4] > 0).sum())
    results[name] = dict(name=name, max_abs_err=run["max_abs_err"],
                         ms=run["ms"], plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, scalar_ms=scalar_ms[name], live=live,
                         per_slot=run["per_slot"], split=run["split"],
                         kernels=run["kernels"])
    floor = tiled_floor_ms(n_slots, N, M, N if fixed[0].ndim == 2 else 0,
                           run["plan"], K, topo.time_varying)
    print(f"  {name}: kernel {run['ms']:.3f} ms, plain {plain_ms:.3f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}), streaming floor {floor:.3f} ms, "
          f"scalar onalgo_tiled {scalar_ms[name]:.3f} ms, {live} of {K} "
          f"mu_k > 0")
    return results


def topo_partial_bytes(K, N, G):
    """Per-slot float64 partial rows of the topology kernels: G blocks of
    K1-topo (the grid of the engine's own call, on the resident route)
    and ceil(N / 256) tiles of K2-topo, each written once and read
    once."""
    tiles = -(-N // 256)
    for label, rows in (("K1-topo", G), ("K2-topo", tiles)):
        print(f"  {label} partial rows at K={K}: {rows} x {K} doubles = "
              f"{rows * K * 8 / 2**20:.2f} MiB written and read per slot")


def topology_tier(pool, device, N=100_000, T=512):
    """Phase 6: the topology tier at the service width (see the module
    docstring).  Returns (kernel results for the kernels line, launches
    of the K=1024 engine runs)."""
    import torch
    from repro_torch.core import baselines as bl
    from repro_torch.kernels import ops
    from repro_torch.serve.compile import compile_service
    from repro_torch.serve.simulator import SimConfig, simulate_service
    from repro_torch.topology import Topology

    sim = SimConfig(num_devices=N, T=T, B_n=0.06, H=N / 4 * 441e6, seed=1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    cs = compile_service(sim, pool, device=device)
    torch.cuda.synchronize()
    lower_ms = 1e3 * (time.perf_counter() - t)
    t = time.perf_counter()
    topos = {1: Topology.uniform(1, N, sim.H, device=device),
             4: Topology.hotspot(4, N, sim.H, hot_frac=0.5, device=device),
             1024: Topology.mobility_walk(1024, N, T, sim.H,
                                          p_handover=0.02, seed=3,
                                          device=device)}
    torch.cuda.synchronize()
    print(f"  compile_service N={N} T={T} (capacity N/4 tasks per slot): "
          f"{lower_ms:.2f} ms; topologies built in "
          f"{1e3 * (time.perf_counter() - t):.2f} ms")

    # (a) the kernels against their plain version: over T=64 resumed at
    # t0=64 with the capacity tightened (CHECK_H) so every K's duals move,
    # and over the engine's own call (the path's capacity; at K=1024 also
    # the tightened one, which the engines run below)
    results, live = {}, {}
    for K in (4, 1024, 4096):
        topo = (topos[K] if K in topos else Topology.mobility_walk(
            K, N, T, sim.H, p_handover=0.02, seed=3, device=device))
        resumed = check_topo_rollouts(cs, topo, 64, 64, CHECK_H, device,
                                      reps=5)
        path = check_topo_rollouts(cs, topo, T, 0, 1.0, device, reps=3,
                                   detail=True)
        for name, r in path.items():
            if resumed[name]["live"] == 0:
                fail(f"{name} K={K} H x{CHECK_H}: no mu_k > 0 at the end: "
                     f"the per-cloudlet duals never engaged")
            r["max_abs_err"] = max(r["max_abs_err"],
                                   resumed[name]["max_abs_err"])
        live[K] = path["onalgo_chunked_topo"]["live"]
        if K == 1024:
            tight = check_topo_rollouts(cs, topo, T, 0, CHECK_H, device,
                                        reps=1)
            live["1024 tight"] = tight["onalgo_chunked_topo"]["live"]
            for name, r in path.items():
                r["max_abs_err"] = max(r["max_abs_err"],
                                       tight[name]["max_abs_err"])
        results[K] = path
        if K == 4096:
            topo_partial_bytes(K, N, path["onalgo_chunked_topo"]["grid"])
        del topo

    # (b) the service end to end on every engine and topology; the walk
    # also at CHECK_H of the capacity, where its duals engage
    engines = {"scan": dict(engine="scan"),
               "chunked": dict(engine="chunked", chunk=16),
               "tiled": dict(engine="chunked", chunk=16, block_n=256)}
    kernel_of = {"chunked": "onalgo_chunked", "tiled": "onalgo_tiled"}

    def run(label, sim, **kw):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t = time.perf_counter()
        metrics = simulate_service(sim, pool, device=device, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = {n: c for n, c in ops.launch_counts().items() if c}
        if not all(math.isfinite(v) for v in metrics.values()):
            fail(f"{label}: non-finite metrics {metrics}")
        print(f"  {label}: wall {wall:.3f} s, {N * T / wall:.4g} devslots/s,"
              f" launches {counts}")
        return metrics, counts

    scalar = {e: run(f"scalar {e}", sim, **kw)[0]
              for e, kw in engines.items()}
    tight_sim = dataclasses.replace(sim, H=sim.H * CHECK_H)
    topos["1024 tight"] = Topology.mobility_walk(
        1024, N, T, tight_sim.H, p_handover=0.02, seed=3, device=device)
    launches = {}
    for K, topo in topos.items():
        run_sim = tight_sim if K == "1024 tight" else sim
        runs = {}
        for e, kw in engines.items():
            metrics, counts = run(f"K={K} {e}", run_sim, topology=topo, **kw)
            if e in kernel_of:
                name = kernel_of[e] + ("" if K == 1 else "_topo")
                if counts.get(name, 0) <= 0:
                    fail(f"K={K} {e} ran without launching {name}")
                if K == 1024:
                    launches[name] = counts[name]
            runs[e] = metrics
        print(f"    K={K} scan metrics {json.dumps(runs['scan'])}")
        if K == 1:
            for e, m in runs.items():
                if m != scalar[e]:
                    fail(f"K=1 {e}: {m} != the scalar run's {scalar[e]}")
            print("    K=1 == the scalar run on every engine (==)")
            continue
        agree(runs)
        if K in live:
            print(f"    K={K}: {live[K]} of {topo.K} mu_k > 0 at the end "
                  f"(the engine's own K1-topo call, checked above)")
        if K in (4, "1024 tight") and not runs["chunked"]["mu_final"] > 0:
            fail(f"K={K}: no mu_k > 0 at the end of the run")
        if K != "1024 tight":
            binned = {b: run(f"K={K} chunked topo_binned={b}", sim,
                             topology=topo, topo_binned=b,
                             **engines["chunked"])[0]
                      for b in (True, False)}
            if any(m != runs["chunked"] for m in binned.values()):
                fail(f"K={K}: topo_binned changes the chunked run")
            print(f"    K={K} engines agree; topo_binned None / True / "
                  f"False identical on chunked")
        else:
            print(f"    K={K} engines agree")

    # admission stage: the batched (T, N) per-cloudlet admission
    topo = topos[1024]
    off = cs.trace.j_idx > 0
    h = cs.overlay.h
    for label, fn in (
            ("scalar admit_by_capacity", lambda: bl.admit_by_capacity(
                off, h, cs.params.H)),
            ("admit_by_capacity_topo K=1024",
             lambda: bl.admit_by_capacity_topo(off, h, topo.assoc,
                                               topo.H_k))):
        print(f"  {label} over (T, N) = ({T}, {N}): "
              f"{time_ms(fn, lambda: (), reps=3):.2f} ms")
    print(f"  stages at K=1024: lowering {lower_ms:.2f} ms; rollout K1-topo "
          f"{results[1024]['onalgo_chunked_topo']['ms']:.2f} ms / K2-topo "
          f"{results[1024]['onalgo_tiled_topo']['ms']:.2f} ms")
    for K in (4, 1024, 4096):
        print(f"  kernels at K={K}: " + ", ".join(
            f"{n} {r['ms']:.3f} ms (scalar {r['scalar_ms']:.3f}, plain "
            f"{r['plain_ms']:.3f}, bound {r['bound_ms']:.4f}, "
            f"{r['live']} mu_k > 0)" for n, r in results[K].items()))
        print(f"    K1-topo at K={K}: " + "; ".join(
            f"{route} {r['ms']:.3f} ms, " + split_text(r["per_slot"],
                                                      r["split"])
            for route, r in results[K]["onalgo_chunked_topo"]
            ["routes"].items()))
        r = results[K]["onalgo_tiled_topo"]
        print(f"    K2-topo at K={K}: {r['ms']:.3f} ms, {r['kernels']} "
              f"kernels a call, " + split_text(r["per_slot"], r["split"]))
    rows = []
    for name in ("onalgo_chunked_topo", "onalgo_tiled_topo"):
        r = dict(results[1024][name])
        r["max_abs_err"] = max(results[K][name]["max_abs_err"]
                               for K in results)
        rows.append(r)
    return rows, launches


def randn(shape, dtype, gen):
    import torch
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def sdpa_call(q, k, v, causal):
    """torch's scaled_dot_product_attention on the same function, as a
    yardstick (the port never calls it), over (B, H, S, D) copies made
    here, outside any timed region."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    gqa = qt.shape[1] != kt.shape[1]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal,
                                                  enable_gqa=gqa)


def sdpa_within_bar(sdpa, want, dtype):
    """Whether SDPA's own output meets the bar the kernel is held to (it
    rounds P to bf16 before P V, as tensor-core attention does): the
    yardstick's accuracy, printed beside its time."""
    import torch
    from repro_torch.kernels.flash_attention import TOLERANCE
    got = sdpa().transpose(1, 2).float()
    err = float((got - want.float()).abs().max())
    ok = torch.allclose(got, want.float(), **TOLERANCE[dtype])
    return f"sdpa {'within' if ok else 'outside'} the bar (max |diff| {err:.3g})"


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


def check_flash(B, S, Hq, Hkv, D, causal, dtype, gen, reps, fault=False,
                Skv=None):
    """K5 against its plain version at one shape (S query rows against Skv
    key rows, S where not given); returns the result row.  With
    ``fault``, also show that the bar rejects a dropped key group."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    Skv = S if Skv is None else Skv
    q = randn((B, S, Hq, D), dtype, gen)
    k, v = (randn((B, Skv, Hkv, D), dtype, gen) for _ in range(2))
    name = str(dtype).removeprefix("torch.")
    route = ("tensor cores (wgmma, TMA)" if dtype == torch.bfloat16
             else "CUDA cores")
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    got = fa.flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    err = check_close(f"flash_attention {name} causal={causal} Hkv={Hkv} "
                      f"D={D} Skv={Skv}",
                      got.float(), want.float(), **fa.TOLERANCE[dtype])
    kernel = lambda: fa.flash_attention_cuda(q, k, v, causal=causal)
    ms = time_ms(kernel, lambda: (), reps=reps)
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                        causal=causal),
                       lambda: (), reps=2)
    sdpa = sdpa_call(q, k, v, causal)
    lib_ms = time_ms(sdpa, lambda: (), reps=reps)
    dev_ms, dev_lib = device_ms(kernel, reps), device_ms(sdpa, reps)
    # (key, query) pairs: j <= i when causal (S <= Skv here), all else
    pairs = S * (S + 1) // 2 if causal else S * Skv
    nbytes = q.element_size() * (2 * B * S * Hq * D + 2 * B * Skv * Hkv * D)
    b_ms, b_by = attention_bound(nbytes, 4 * B * Hq * pairs * D, name)
    kv = "" if Skv == S else f" Skv={Skv}"
    print(f"  flash_attention B={B} S={S}{kv} Hq={Hq} Hkv={Hkv} D={D} {name} "
          f"causal={causal} [{route}]: max |diff| {err:.3g}; kernel "
          f"{ms:.4f} ms (device {dev_ms:.4f}), plain {plain_ms:.3f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}), sdpa {lib_ms:.4f} ms (device "
          f"{dev_lib:.4f}); kernel / sdpa {ms / lib_ms:.2f} (device "
          f"{dev_ms / dev_lib:.2f}); {sdpa_within_bar(sdpa, want, dtype)}")
    if fault:
        bar_rejects_fault("flash_attention", q, k, v, causal, Skv, want)
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
    splits = len(da.split_plan(B, Hkv, min(n, S)))
    cores = ("tensor cores (mma.sync)" if dtype == torch.bfloat16
             else "CUDA cores")
    route = f"{cores}, {splits} split{'s' if splits > 1 else ''}"
    want = da.decode_attention_plain(q, kc, vc, n)
    got = da.decode_attention_cuda(q, kc, vc, n)
    torch.cuda.synchronize()
    err = check_close(f"decode_attention {name} cache_len={n} Hkv={Hkv} "
                      f"D={D}",
                      got.float(), want.float(), **TOLERANCE[dtype])
    kernel = lambda: da.decode_attention_cuda(q, kc, vc, n)
    ms = time_ms(kernel, lambda: (), reps=reps)
    plain_ms = time_ms(lambda: da.decode_attention_plain(q, kc, vc, n),
                       lambda: (), reps=2)
    sdpa = sdpa_call(q, kc[:, :n], vc[:, :n], False)
    lib_ms = time_ms(sdpa, lambda: (), reps=reps)
    dev_ms, dev_lib = device_ms(kernel, reps), device_ms(sdpa, reps)
    host, host_lib = host_us(kernel), host_us(sdpa)
    nbytes = q.element_size() * (2 * B * Hq * D + 2 * B * n * Hkv * D)
    b_ms, b_by = attention_bound(nbytes, 4 * B * Hq * n * D, name)
    print(f"  decode_attention B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} {name} "
          f"cache_len={n} [{route}]: max |diff| {err:.3g}; kernel "
          f"{ms:.4f} ms (device {dev_ms:.4f}), plain {plain_ms:.4g} ms, "
          f"bound {b_ms:.4f} ms ({b_by}), sdpa {lib_ms:.4f} ms (device "
          f"{dev_lib:.4f}); kernel / sdpa {ms / lib_ms:.2f} (device "
          f"{dev_ms / dev_lib:.2f}); host per call {host:.1f} us, sdpa's "
          f"{host_lib:.1f} us; {sdpa_within_bar(sdpa, want, dtype)}")
    if fault:
        bar_rejects_fault("decode_attention", q, kc, vc, False, n, want)
    return dict(name="decode_attention", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


def split_sweep(B, S, Hq, Hkv, D, gen, reps):
    """K6's device time at cache_len S under split_plan and under other
    split counts (the plan replaced for the sweep only), so the plan's
    choice stands beside the alternatives it was chosen over."""
    import torch
    from repro_torch.kernels import decode_attention as da
    q = randn((B, 1, Hq, D), torch.bfloat16, gen)
    kc, vc = (randn((B, S, Hkv, D), torch.bfloat16, gen) for _ in range(2))
    kernel = lambda: da.decode_attention_cuda(q, kc, vc, S)
    plan = da.split_plan
    rows = [f"plan ({len(plan(B, Hkv, S))}) {device_ms(kernel, reps):.4f}"]
    try:
        for P in (1, 2, 4, 8):
            size = -(-(-(-S // P)) // 64) * 64
            forced = tuple((s, min(S, s + size)) for s in range(0, S, size))
            da.split_plan = lambda *a, forced=forced: forced
            rows.append(f"{P}: {device_ms(kernel, reps):.4f}")
    finally:
        da.split_plan = plan
    print(f"  decode_attention B={B} Hq={Hq} Hkv={Hkv} cache_len {S}, "
          f"device ms by split count: {', '.join(rows)}")


def attention_build_clean():
    """Fail if ptxas reported spills in the attention kernels or serialized
    K5's wgmma (a wgmma in a branch, or an accumulator read mid-flight)."""
    from repro_torch.kernels import build
    log = build.PTXAS_LOG.get("attention")
    if log is None:
        print("  (attention library already built: no ptxas report)")
        return
    spills = [ln for ln in log.splitlines() if "spill" in ln
              and " 0 bytes spill stores, 0 bytes spill loads" not in ln]
    name = None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "spill" in ln and ln in spills and (
                "_tc_kernel" in name or "decode_" in name):
            fail(f"ptxas spills in {name}: {ln.strip()}")
    if "wgmma.mma_async instructions are serialized" in log:
        fail("ptxas serialized the wgmma of flash_attention_tc_kernel")
    print("  ptxas: no spills in the new kernels, no serialized wgmma")


def onalgo_build_clean():
    """Fail unless ptxas kept the row partials of the resident and tiled
    rollout kernels and of K3 in registers: no stack frame, no spills in
    any of them."""
    from repro_torch.kernels import build
    log = build.PTXAS_LOG.get("onalgo_step")
    if log is None:
        print("  (onalgo_step library already built: no ptxas report)")
        return
    name, seen = None, {"onalgo_resident_kernel": 0, "onalgo_tiled": 0,
                        "onalgo_duals_kernel": 0, "onalgo_cells_kernel": 0}
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            continue
        family = next((f for f in seen if name and f in name), None)
        if family and "stack" in ln:
            seen[family] += 1
            if not ln.strip().startswith("0 bytes stack frame, 0 bytes "
                                         "spill stores, 0 bytes spill "
                                         "loads"):
                fail(f"ptxas: {name}: {ln.strip()}")
    # two resident kernels (K1, K1-topo); ten tiled (uint16 / float32
    # counts x K2 / K2-topo x (M,) / (N, M) h and w, and K2 with the cell
    # axis) and the cloudlet pass; K3; the cell-axis K1 (128 registers)
    if seen != {"onalgo_resident_kernel": 2, "onalgo_tiled": 11,
                "onalgo_duals_kernel": 1, "onalgo_cells_kernel": 1}:
        fail(f"ptxas reported {seen} kernels, not 2 resident, 11 tiled, K3 "
             f"and the cell-axis K1")
    print("  ptxas: no stack frame and no spills in the 2 resident, 11 "
          "tiled and the cell-axis rollout kernels and in K3")


def check_attention():
    """Phase 4: K5 and K6 against their plain versions on the card.  The
    kernels line reports K5 at the phase-5c shape (bf16, causal) and K6 at
    a long cache, where attention is the work (bf16, cache_len 4096; the
    bound in csrc/attention.cu's note); max_abs_err is the largest over
    all checks of the kernel."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    attention_build_clean()
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
    # G = 7 and 8 (the repo's GQA configs), with a split boundary +- 1 key
    decode.append(check_decode(2, 4096, 14, 2, 128, 2049, bf16, gen,
                               reps=20))
    decode.append(check_decode(16, 4096, 32, 4, 128, 4096, bf16, gen,
                               reps=20))
    # the serving path's own call: 16 prompts of 16 tokens, 8 generated,
    # a cache of 25 (launch/serve.py's defaults)
    decode.append(check_decode(16, 25, 16, 16, 128, 24, bf16, gen, reps=20))
    # the model zoo's calls at head size 64 in bf16 (phase 12c): seamless's
    # encoder self-attention (512 frames, full) and its prefill
    # cross-attention (16 prompt rows against the 512 memory rows);
    # internvl2's steps (G = 7, a 384-row cache holding 256 prefix rows,
    # 16 prompt rows and 8 steps) and seamless's (its one-row
    # cross-attention against the memory, its self-attention cache)
    flash.append(check_flash(4, 512, 16, 16, 64, False, bf16, gen, reps=10,
                             fault=True))
    flash.append(check_flash(4, 16, 16, 16, 64, False, bf16, gen, reps=10,
                             fault=True, Skv=512))
    decode.append(check_decode(4, 384, 14, 2, 64, 280, bf16, gen, reps=20,
                               fault=True))
    decode.append(check_decode(4, 512, 16, 16, 64, 512, bf16, gen, reps=20,
                               fault=True))
    decode.append(check_decode(4, 24, 16, 16, 64, 24, bf16, gen, reps=20,
                               fault=True))
    split_sweep(16, 4096, 16, 4, 128, gen, reps=20)
    out = []
    for rows in (flash, decode):
        r = dict(rows[0])
        r["max_abs_err"] = max(x["max_abs_err"] for x in rows)
        out.append(r)
    return out


def ssd_cost(b, nc, Q, h, p, n, g):
    """K4: x (b, nc, Q, h, p), dt (b, nc, Q, h), A (h,), B and C (b, nc,
    Q, g, n) read once, y_diag (b, nc, Q, h, p) and states (b, nc, h, p,
    n) written once, float32.  Operations of the causal products that the
    function needs: n Q (Q + 1) for C B^T over j <= i once per (cell,
    group), since a group's heads read the same B and C; per (cell, head)
    p Q (Q + 1) for its product with xbar and 2 Q p n for the states (the
    O(Q^2) exps and scalings left out)."""
    nbytes = 4 * (2 * b * nc * Q * h * p + b * nc * Q * h + h
                  + 2 * b * nc * Q * g * n + b * nc * h * p * n)
    nops = b * nc * (g * n * Q * (Q + 1)
                     + h * (p * Q * (Q + 1) + 2 * Q * p * n))
    return nbytes, nops


def ssd_bound(nbytes, nops):
    """K4's bound: bytes over the HBM rate or its operations at the rate of
    the arithmetic it runs (3xTF32 on the tensor cores), whichever is
    larger."""
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = nops / TF32X3_OPS_PER_S
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                         else "operations")


def ssd_build_clean():
    """Fail unless ptxas gave K4 no stack frame and no spills (its C B^T
    strip stays in registers for all its heads) and its SASS runs the
    products on the tensor cores (HMMA)."""
    from repro_torch.kernels import build
    log = build.PTXAS_LOG.get("ssd_chunk")
    if log is None:
        print("  (ssd_chunk library already built: no ptxas report)")
    else:
        name, seen = None, 0
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                name = ln.split("'")[1]
            elif name and "ssd_chunk_kernel" in name and "stack" in ln:
                seen += 1
                if not ln.strip().startswith("0 bytes stack frame, 0 bytes "
                                             "spill stores, 0 bytes spill "
                                             "loads"):
                    fail(f"ptxas: {name}: {ln.strip()}")
        if seen != 3:
            fail(f"ptxas reported {seen} ssd_chunk kernels, not 3 (p "
                 f"chunks 16, 32, 64)")
        if "wgmma.mma_async instructions are serialized" in log:
            fail("ptxas serialized a wgmma of ssd_chunk_kernel")
    sass = subprocess.run(
        ["/usr/local/cuda/bin/cuobjdump", "-sass",
         str(build.library_path("ssd_chunk"))], capture_output=True,
        text=True, timeout=120).stdout
    hmma = sum(" HMMA." in ln for ln in sass.splitlines())
    if hmma == 0:
        fail("ssd_chunk's SASS holds no HMMA: K4 is off the tensor cores")
    if log is not None:
        print("  ptxas: no stack frame and no spills in the 3 ssd_chunk "
              "kernels")
    print(f"  {hmma} HMMA instructions in ssd_chunk's SASS")


def ssd_inputs(b, nc, Q, h, p, n, g, gen):
    """K4's operands drawn as the reference's kernel test draws them:
    normal x, softplus(normal) / 2 steps, A = -exp(0.3 normal), B and C
    0.5 normal (g groups)."""
    import torch
    r = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    return (r(b, nc, Q, h, p),
            torch.nn.functional.softplus(r(b, nc, Q, h)) * 0.5,
            -torch.exp(r(h) * 0.3), r(b, nc, Q, g, n) * 0.5,
            r(b, nc, Q, g, n) * 0.5)


def ssd_dropping_diagonal(y_diag, x, dt, B, C):
    """K4's y_diag with position j == i left out of each row's causal sum
    (a mask off by one, j < i): y_diag minus (C_i . B_i) x_i dt_i.  A
    kernel with this fault must fail the bar K4 is held to."""
    import torch
    h = x.shape[3]
    Bh, Ch = (t.repeat_interleave(h // t.shape[3], dim=3) for t in (B, C))
    diag = torch.einsum("bcihn,bcihn->bcih", Ch, Bh)
    return y_diag - diag[..., None] * x * dt[..., None]


def check_ssd(label, shape, g, gen, reps, fault=True):
    """K4 against its plain version at one shape (B and C with g groups);
    returns the result row.  With ``fault``, also show that the bar
    rejects the diagonal dropped."""
    import torch
    from repro_torch.kernels import ssd_chunk as sc
    b, nc, Q, h, p, n = shape
    args = ssd_inputs(b, nc, Q, h, p, n, g, gen)
    want = sc.ssd_chunk_plain(*args)
    got = sc.ssd_chunk_cuda(*args)
    again = sc.ssd_chunk_cuda(*args)
    torch.cuda.synchronize()
    err = max(check_close(f"ssd_chunk {label} {what}", got[i], want[i],
                          **sc.TOLERANCE)
              for i, what in ((0, "y_diag"), (1, "states")))
    if not all(torch.equal(a, r) for a, r in zip(got, again)):
        fail(f"ssd_chunk {label}: two calls differ")
    plan = sc.ssd_chunk_cuda.plan
    ms = time_ms(lambda: sc.ssd_chunk_cuda(*args), lambda: (), reps=reps)
    dev = device_ms(lambda: sc.ssd_chunk_cuda(*args), reps)
    plain_ms = time_ms(lambda: sc.ssd_chunk_plain(*args), lambda: (),
                       reps=2)
    cost = ssd_cost(b, nc, Q, h, p, n, g)
    b_ms, b_by = ssd_bound(*cost)
    core_ms, _ = bound_ms(*cost)
    print(f"  ssd_chunk {label} b={b} nc={nc} Q={Q} h={h} p={p} n={n} g={g}:"
          f" max |diff| {err:.3g}, two calls equal; {plan.heads} heads a "
          f"block, {plan.blocks} blocks; kernel {ms:.4f} ms a call, "
          f"{dev:.4f} ms on the device; plain {plain_ms:.4f} ms; bound "
          f"{b_ms:.4f} ms ({b_by}; on the CUDA cores {core_ms:.4f} ms)")
    if fault:
        faulty = ssd_dropping_diagonal(want[0], *args[:2], *args[3:])
        d = float((faulty - want[0]).abs().max())
        if torch.allclose(faulty, want[0], **sc.TOLERANCE):
            fail(f"ssd_chunk {label}: the bar accepts the diagonal of the "
                 f"causal sum dropped (max |diff| {d:g})")
        print(f"    diagonal dropped from the causal sum: max |diff| "
              f"{d:.3g}, rejected by the bar")
    return dict(name="ssd_chunk", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def check_ssd_kernel():
    """Phase 7a: K4 against its plain version on the card at mamba2-370m's
    widths (h=32 heads of p=64, n=128, 1 group) and Jamba's (h=128, p=64,
    n=16, 1 group).  The kernels line reports
    the (4, 2048) forward's shape, where K4 is the work (no single PyTorch
    call computes this function, so there is no library time);
    max_abs_err is the largest over all checks."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = [check_ssd("(4, 2048) forward", (4, 16, 128, 32, 64, 128), 1,
                      gen, reps=10),
            check_ssd("(4, 2048) forward, B/C head-expanded",
                      (4, 16, 128, 32, 64, 128), 32, gen, reps=5,
                      fault=False),
            check_ssd("serving wave", (16, 1, 16, 32, 64, 128), 1, gen,
                      reps=50),
            check_ssd("ragged chunk", (16, 1, 33, 32, 64, 128), 1, gen,
                      reps=20),
            # Jamba's Mamba layers (h=128 heads of p=64, n=16, 1 group):
            # the serving wave of phase 12b and a (4, 2048) forward
            check_ssd("Jamba serving wave", (16, 1, 16, 128, 64, 16), 1,
                      gen, reps=50),
            check_ssd("Jamba (4, 2048) forward", (4, 16, 128, 128, 64, 16),
                      1, gen, reps=5)]
    r = dict(rows[0])
    r["max_abs_err"] = max(x["max_abs_err"] for x in rows)
    return r


def reduced_serving_matches_cpu(arch):
    """Phases 5a / 7b: a reduced serving run of ``arch`` on the card (K3,
    and K6 or K4) gives the CPU run's (plain versions') lines and greedy
    tokens, with the same weights (drawn on the CPU, copied to the
    card)."""
    import copy
    import torch
    from repro_torch.launch.serve import build_model, parse_args, serve
    argv = ["--arch", arch, "--reduced", "--slots", "20"]
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
    print(f"  reduced {arch}, 20 slots: card and cpu print the same lines "
          f"and {runs['cpu'][1].numel()} equal greedy tokens; last line: "
          f"{runs['cpu'][0][-1]}")


def host_syncs(fn):
    """How many operations of fn() make the host wait for the card, as
    torch's sync debug mode reports them (a prototype: it may miss some
    kinds of sync)."""
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # (not the mode's own notice that it is a prototype)
    return sum("called a synchronizing" in str(w.message) for w in caught)


def full_width_serving(arch, layers=None):
    """Phases 5b / 7c / 12b: the entry point's loop at the full width of
    ``arch`` in bf16 on the card (its defaults otherwise; ``layers`` cuts
    the depth, weights drawn as ``build_model`` draws them), with the
    launch counts of this run; then the times of its prefill and decode
    steps, the decode step's device-busy share and its host syncs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_model, parse_args, serve
    from repro_torch.models.api import ModelAPI
    args = parse_args(["--arch", arch])
    t = time.perf_counter()
    if layers is None:
        cfg, params = build_model(args)
    else:
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=layers)
        print(f"  reduced: num_layers {full.num_layers} → {layers} "
              f"({full.param_count()} parameters do not fit in bf16 on "
              f"one card)")
        params, _ = ModelAPI(cfg).init(torch.Generator(
            device="cuda").manual_seed(args.seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    attn_layers = sum(cfg.block_kind(i) == "attn"
                      for i in range(cfg.num_layers))
    ssm = (f"{cfg.ssm_heads} SSM heads x {cfg.ssm_headdim}, d_inner "
           f"{cfg.d_inner}, d_state {cfg.ssm_state}, "
           f"{cfg.ssm_ngroups} group(s)")
    mixer = (f"{cfg.num_heads} heads ({cfg.num_kv_heads} KV) x "
             f"{cfg.resolved_head_dim}" if attn_layers else ssm)
    if attn_layers and attn_layers < cfg.num_layers:
        mixer += (f" in {attn_layers} layers, {ssm} in "
                  f"{cfg.num_layers - attn_layers}")
    if cfg.num_experts:
        mixer += (f"; MoE {cfg.num_experts} experts top-{cfg.top_k} "
                  f"({cfg.moe_impl}) in "
                  f"{sum(cfg.ffn_kind(i) == 'moe' for i in range(cfg.num_layers))}"
                  f" layers")
    print(f"  {cfg.name}: d_model {cfg.d_model}, {cfg.num_layers} layers, "
          f"{mixer}, vocab {cfg.vocab_size}, {cfg.dtype}; {n_params} "
          f"parameters (analytic {cfg.param_count()}), drawn in "
          f"{time.perf_counter() - t:.2f} s")
    waves = []
    gc.collect()  # tensors of earlier phases held only by cycles
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated() / 2**20
    weights = sum(p.numel() * p.element_size()
                  for p in params.parameters()) / 2**20
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
    # K3 once per slot; K6 once per attention layer per decode step; K4
    # once per SSM layer per prefill; K5 never (prefill with a cache runs
    # the plain flash loop, as the reference's does)
    expect = {"onalgo_duals": (args.slots, "once per slot"),
              "decode_attention": (st.decode_calls * attn_layers,
                                   f"{st.decode_calls} decode steps x "
                                   f"{attn_layers} attention layers"),
              "ssd_chunk": (st.prefill_calls * (cfg.num_layers - attn_layers),
                            f"{st.prefill_calls} prefills x "
                            f"{cfg.num_layers - attn_layers} SSM layers"),
              "flash_attention": (0, "never")}
    for name, (n, why) in expect.items():
        if counts[name] != n:
            fail(f"{name} launched {counts[name]} times, expected {n} "
                 f"({why})")
    toks = torch.cat([o for _, o in waves])
    if toks.shape != (served, args.gen_steps) or int(toks.min()) < 0 or \
            int(toks.max()) >= cfg.vocab_size:
        fail(f"generated ids: shape {tuple(toks.shape)}, range "
             f"[{int(toks.min())}, {int(toks.max())}]")
    print(f"  serve loop: {args.slots} slots, {served}/{offered} tasks "
          f"served in {len(waves)} waves, wall {wall:.2f} s (ends in "
          f"synchronize), peak {peak:.1f} MiB ({live:.1f} MiB live before "
          f"the loop, weights {weights:.1f} MiB), launches {counts}")

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
        syncs = host_syncs(step)
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
          f"{B / dec_ms * 1e3:.1f} tokens/s; {busy}; host syncs a decode "
          f"step {syncs}")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:5]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} "
              f"{e.key[:70]}")
    return cfg, params, counts


def full_width_forward(cfg, params):
    """Phases 5c / 7d: lm.forward(use_kernel=True) over (4, 2048) tokens
    (K5 in every attention layer, K4 in every SSM layer) against the route
    without that kernel on the same tokens — ModelAPI.prefill_step (plain
    flash over the cache) for attention, lm.forward(use_kernel=False) for
    SSM — last-position logits within the bf16 bar.  An SSM stack also
    runs both routes on a float32 copy of the weights, where they differ
    by float32 rounding only."""
    import copy
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.models.api import ModelAPI
    from repro_torch.models.layers import lm_logits
    ssm_stack = cfg.family == "ssm"
    kernel, tag, bar = (("ssd_chunk", "K4", SSM_BF16_PATH_BAR) if ssm_stack
                        else ("flash_attention", "K5", BF16_PATH_BAR))
    gen = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (4, 2048), generator=gen,
                           device="cuda")

    def last_logits(cfg, params, use_kernel):
        hidden, _, _ = lm.forward(cfg, params, tokens, use_kernel=use_kernel)
        return lm_logits(cfg, params["embed"], hidden[:, -1:]).float()

    def compare(got, want, what, bar):
        err = float((got - want).abs().max())
        scale = max(float(want.abs().max()), 1.0)
        if not bool(torch.isfinite(got).all()) or err > bar * scale:
            fail(f"{what}: max |diff| {err:g} above {bar} x max(|logit|, 1) "
                 f"= {bar * scale:g} (or non-finite logits)")
        return f"max |diff| {err:.4g} = {err / scale:.4g} of max(|logit|, 1)"

    with torch.inference_mode():
        last_logits(cfg, params, True)  # warm-up
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = last_logits(cfg, params, True)
        torch.cuda.synchronize()
        fwd_ms = 1e3 * (time.perf_counter() - t)
        counts = ops.launch_counts()
        t = time.perf_counter()
        if ssm_stack:
            want = last_logits(cfg, params, False)
            route = "forward without K4 (bf16 products)"
        else:
            want, _ = ModelAPI(cfg).prefill_step(params, {"tokens": tokens},
                                                 2048)
            want = want.float()
            route = "prefill_step (plain flash)"
        torch.cuda.synchronize()
        pf_ms = 1e3 * (time.perf_counter() - t)
        if counts[kernel] != cfg.num_layers:
            fail(f"{kernel} launched {counts[kernel]} times in a "
                 f"{cfg.num_layers}-layer forward")
        diff = compare(got, want, f"forward(use_kernel=True) vs {route}",
                       bar)
        print(f"  (4, 2048) tokens: forward with {tag} {fwd_ms:.1f} ms, "
              f"{route} {pf_ms:.1f} ms; last-position logits {diff} (bar "
              f"{bar}); launches {counts}")
        if ssm_stack:
            cfg32 = dataclasses.replace(cfg, dtype_name="float32")
            p32 = copy.deepcopy(params).float()
            diff = compare(last_logits(cfg32, p32, True),
                           last_logits(cfg32, p32, False),
                           "float32 forward with K4 vs without", SSM_F32_BAR)
            print(f"  the same in float32 weights: {diff} (bar "
                  f"{SSM_F32_BAR})")
            del p32
    return counts


# ---------------------------------------------------------------------------
# Phase 8: the streaming engine (materialize=False) and the draws kernel


def draws_build_clean():
    """Fail on a stack frame or spills in the 4 draws kernels; return the
    pipe slots a threefry takes, from the service slab kernel's SASS: its
    instructions over its inlined threefry copies (20 rotates, SHF.L.W,
    each), the busiest of the ALU pipe's, the FMA pipe's and half of all
    it issues (PIPE_OPS_PER_S), the bound's operation count."""
    import re
    from repro_torch.kernels import build
    log = build.PTXAS_LOG.get("draws")
    if log is None:
        print("  (draws library already built: no ptxas report)")
    else:
        seen = 0
        for ln in log.splitlines():
            if "stack" in ln:
                seen += 1
                if not ln.strip().startswith("0 bytes stack frame, 0 bytes "
                                             "spill stores, 0 bytes spill "
                                             "loads"):
                    fail(f"ptxas: draws: {ln.strip()}")
        if seen != 4:
            fail(f"ptxas reported {seen} draws kernels, not 4")
        print("  ptxas: no stack frame and no spills in the 4 draws kernels")
    sass = subprocess.run(
        ["/usr/local/cuda/bin/cuobjdump", "-sass",
         str(build.library_path("draws"))], capture_output=True, text=True,
        timeout=120).stdout
    body = next((part for part in sass.split("Function : ")[1:]
                 if DRAWS_SLAB_KERNEL in part.split("\n", 1)[0]), "")
    ops = [op.split(".")[0] for op in re.findall(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", body)]
    ops = [op for op in ops if op != "NOP"]
    rot = body.count("SHF.L.W")
    if rot < 20:
        print(f"  draws SASS: {len(ops)} instructions, {rot} rotates: "
              f"taking the hand count, {THREEFRY_HAND_OPS} a threefry, two "
              f"thirds on one pipe")
        return THREEFRY_HAND_OPS * 2 / 3
    copies = rot / 20
    alu = sum(op in ALU_PIPE for op in ops) / copies
    fma = sum(op in FMA_PIPE for op in ops) / copies
    issued = len(ops) / copies
    hist = collections.Counter(ops).most_common(12)
    print(f"  draws SASS (service slab kernel): {len(ops)} instructions, "
          f"{rot} rotates = {copies:g} threefry copies; a threefry "
          f"{issued:.1f} issued, {alu:.1f} on the ALU pipe, {fma:.1f} on "
          f"the FMA pipe: {max(alu, fma, issued / 2):.1f} pipe slots; "
          f"opcodes {dict(hist)}")
    return max(alu, fma, issued / 2)


def draws_need(proc, b0, nb, entry, off, length, n0, n_cols, boundary,
               device):
    """(threefry calls, threefry calls issued, bytes) of one call.  Calls
    this call's data needs: a block key per (walked block, column), the
    arrival-init draw of a fresh service column; per walked row the
    service's chain and change draws (and the image draw on a kept row)
    or the walk's handover draw; and one draw per change (u < p, or slot
    0 for the service), counted from the plain uniforms of the change
    channel.  Issued: the same with each change draw counted for all 32
    lanes of a warp (32 consecutive columns) in which any lane changes,
    as the kernel's warps take it.  Bytes: the entry states read, the
    outputs written."""
    import torch
    from repro_torch.kernels.draws import RB, ServiceProcess
    from repro_torch.workload import streams
    service = isinstance(proc, ServiceProcess)
    rows = (nb - 1) * RB if boundary else off + length
    kept = 0 if boundary else length
    blocks = -(-rows // RB)
    c, p = (2, proc.p_change) if service else (0, proc.p_handover)
    changes = warp_changes = 0
    for b in range(blocks):
        r = min(RB, rows - b * RB)
        u = streams.uniform_block_range(
            proc.seed, proc.sid, b0 + b, 1, proc.N, proc.channels, n0=n0,
            n_cols=n_cols, device=device)[c, :r]
        hit = u < p
        if service and b0 + b == 0:
            hit[0] = True
        changes += int(hit.sum())
        lanes = torch.nn.functional.pad(hit, (0, -n_cols % 32))
        warp_changes += 32 * int(lanes.view(r, -1, 32).any(-1).sum())
        del u, hit, lanes
    calls = blocks * n_cols + changes
    if service:
        calls += 2 * rows * n_cols + kept * n_cols
        calls += n_cols if entry is None else 0
    else:
        calls += rows * n_cols
    width = 5 if service else 4  # on + rate, or assoc, per column
    nbytes = (0 if entry is None else width * n_cols) + (
        width * nb * n_cols if boundary
        else (9 if service else 4) * length * n_cols)
    return calls, calls - changes + warp_changes, nbytes


def draws_row(label, proc, b0, nb, entry, device, threefry_slots, reps=20,
              **kw):
    """One draws check (phase 8a): kernel against plain version bit for
    bit, twice bit for bit, one launch a call; its time a call (host work
    inside) and on the device, the plain version's and the bound."""
    import torch
    from repro_torch.kernels import draws as dr
    got = dr.draws_cuda(proc, b0, nb, entry, device=device, **kw)
    want = dr.draws_plain(proc, b0, nb, entry, device=device, **kw)
    again = dr.draws_cuda(proc, b0, nb, entry, device=device, **kw)
    for x, y, z in zip(got, want, again):
        if not (x.dtype == y.dtype and torch.equal(x, y)):
            fail(f"draws {label}: kernel differs from the plain version in "
                 f"{int((x != y).sum())} of {x.numel()} elements")
        if not torch.equal(x, z):
            fail(f"draws {label}: two calls differ")
    del got, want, again
    dr.draws_cuda.launches = 0
    call = lambda: dr.draws_cuda(proc, b0, nb, entry, device=device, **kw)
    call()
    per_call = dr.draws_cuda.launches
    # the profiler may miss a lone kernel's record (0); more than one
    # would be a second launch
    n_kernels = kernels_per_call(call, "draws_kernel", expect=1)
    if per_call != 1 or n_kernels > 1:
        fail(f"draws {label}: {per_call} launches, {n_kernels} kernels a "
             f"call")
    ms = time_ms(lambda: call(), lambda: (), reps=reps)
    dev_ms = device_ms(call, reps)
    plain_ms = time_ms(lambda: dr.draws_plain(proc, b0, nb, entry,
                                              device=device, **kw),
                       lambda: (), reps=1)
    n_cols = kw.get("n_cols") or proc.N - kw.get("n0", 0)
    calls, issued, nbytes = draws_need(
        proc, b0, nb, entry, kw.get("off", 0), kw.get("length", 0),
        kw.get("n0", 0), n_cols, kw.get("boundary", False), device)
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = calls * threefry_slots / PIPE_OPS_PER_S
    b_ms = 1e3 * max(by_bytes, by_ops)
    b_by = "bytes" if by_bytes >= by_ops else "operations"
    issued_ms = 1e3 * issued * threefry_slots / PIPE_OPS_PER_S
    print(f"  draws {label}: bit for bit, twice equal, 1 launch a call "
          f"({n_kernels} kernel under the profiler); "
          f"{ms:.4f} ms a call, {dev_ms:.4f} ms on the device, plain "
          f"{plain_ms:.2f} ms; bound {b_ms:.4f} ms ({b_by}: {calls:.4g} "
          f"threefry, {nbytes / 1e6:.1f} MB); device / bound "
          f"{dev_ms / b_ms:.2f}; the warps issue {issued:.4g} threefry "
          f"({issued / calls:.3f} of the need: divergent change draws), "
          f"{issued_ms:.4f} ms at the pipe rate", flush=True)
    return dict(name="draws", max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by)


def check_draws(device, threefry_slots):
    """Phase 8a: the draws kernel against its plain version at the shapes
    the paths give it.  Returns the kernels line's row: the 64-slot
    slab at N=10^6 (8c's streamed runs call it there)."""
    from repro_torch.kernels.draws import WalkProcess
    from repro_torch.workload import lower_service_workload, service_process
    N, T = 100_000, 512
    proc = service_process(0, N, 64, 3)
    draws_row("materialized horizon T=512 N=100000", proc, 0, 8, None,
              device, threefry_slots, length=T)
    wl = lower_service_workload(0, T, N, 64, 3, device=device)
    entry = lambda b: (wl.on_entry[b], wl.rate_entry[b])
    draws_row("slab t0=64 L=64 N=100000", proc, 1, 1, entry(1),
              device, threefry_slots, off=0, length=64)
    draws_row("slab t0=100 L=64 off the block N=100000", proc, 1, 2,
              entry(1),
              device, threefry_slots, off=36, length=64)
    del wl
    big = service_process(1, FLEET_N, 64, 3)
    draws_row("boundary pass N=10^6 T=256", big, 0, FLEET_T // 64, None,
              device, threefry_slots, reps=5, boundary=True)
    wl = lower_service_workload(1, FLEET_T, FLEET_N, 64, 3, device=device)
    row = draws_row("slab t0=64 L=64 N=10^6 (8c)", big, 1, 1,
                    (wl.on_entry[1], wl.rate_entry[1]), device,
                    threefry_slots, reps=5, off=0, length=64)
    del wl
    walk = WalkProcess(seed=3, N=N, K=1024, p_handover=float(
        __import__("numpy").float32(0.02)))
    draws_row("walk K=1024 N=100000 T=512", walk, 0, 8, None, device,
              threefry_slots, length=T)
    col = service_process(2, 2 ** 25, 64, 3)
    for kw in (dict(length=128), dict(boundary=True)):
        draws_row(f"column form N=2^25 n0=N-1000 n_cols=1000 "
                  f"{'boundary' if kw.get('boundary') else 'L=128'}", col,
                  0, 2, None, device, threefry_slots, n0=2 ** 25 - 1000,
                  n_cols=1000, **kw)
    return row


def stream_series_check(label, sim, pool, device, block_n, chunk=16,
                        slab=64):
    """Phase 8b/8c: the chunked engine over the materialized workload
    against the streaming engine (slab ``slab``, the same chunk):
    offloads, admits and tasks exactly, the other series within the
    duals' bar (rtol 1e-5, atol 1e-6); the slab loop runs under
    set_sync_debug_mode("error")."""
    import torch
    from repro_torch.core import fleet
    from repro_torch.serve.compile import (compile_service,
                                           compile_service_streaming)
    cs = compile_service(sim, pool, device=device)
    want, _ = fleet.simulate_chunked(
        *cs.simulate_args(), cs.rule, chunk=chunk, block_n=block_n,
        overlay=cs.overlay, enforce_slot_capacity=True, device=device)
    del cs
    ss = compile_service_streaming(sim, pool, device=device)
    fleet.SLAB_LOOP_SYNC_DEBUG = "error"
    try:
        got, _ = fleet.simulate_chunked_stream(
            ss.slab, sim.T, sim.num_devices, ss.tables, ss.params, ss.rule,
            chunk=chunk, slab=slab, block_n=block_n,
            enforce_slot_capacity=True, device=device)
    finally:
        fleet.SLAB_LOOP_SYNC_DEBUG = None
    err = 0.0
    for key, w in want.items():
        if key in ("offloads", "admits", "tasks"):
            if not torch.equal(got[key], w):
                fail(f"{label}: streamed {key} differs from materialized")
        else:
            err = max(err, check_close(f"{label} {key}", got[key], w))
    print(f"  {label}: streamed series == materialized (offloads, admits, "
          f"tasks exactly; the rest max |diff| {err:.3g}); no host sync in "
          f"the slab loop", flush=True)


def range_flag_check(device, N=5000, T=128):
    """Phase 8b: a state index out of range in one slab of a streamed run
    (K1 and K2) raises the run's ValueError after the slab loop, the
    kernels having held it to the tables, and the card works on."""
    import torch
    from repro_torch.core import fleet
    from repro_torch.serve.compile import compile_service
    from repro_torch.serve.simulator import SimConfig, synthetic_pool
    sim = SimConfig(num_devices=N, T=T, B_n=0.06, H=0.1 * N * 441e6, seed=5)
    cs = compile_service(sim, synthetic_pool(), device=device)
    j = cs.trace.j_idx.clone()
    j[70, 123] = cs.tables[0].shape[-1]
    for block_n in (None, 256):
        try:
            fleet.simulate_chunked_stream(
                lambda t0, L: (j[t0:t0 + L], None), T, N, cs.tables,
                cs.params, cs.rule, chunk=16, slab=64, block_n=block_n,
                device=device)
        except ValueError as e:
            if "j_seq holds state indices outside" not in str(e):
                raise
        else:
            fail(f"block_n={block_n}: a j out of range did not raise")
        torch.cuda.synchronize()
    print("  a j out of range in a streamed slab raises after the slab "
          "loop on K1 and K2; the card works on")


def service_runs(label, sim, pool, device, runs):
    """simulate_service for each (name, kwargs) of ``runs``, with launch
    counts set to 0 just before each and read just after; returns
    {name: (metrics, wall s, peak MiB, launches)}; prints devslots/s."""
    import torch
    from repro_torch.core import fleet
    from repro_torch.kernels import ops
    from repro_torch.serve.simulator import simulate_service
    out = {}
    for name, kw in runs:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        fleet.SLAB_LOOP_SYNC_DEBUG = "error"
        t = time.perf_counter()
        try:
            metrics = simulate_service(sim, pool, device=device, **kw)
            torch.cuda.synchronize()
        finally:
            fleet.SLAB_LOOP_SYNC_DEBUG = None
        wall = time.perf_counter() - t
        counts = {n: c for n, c in ops.launch_counts().items() if c}
        peak = torch.cuda.max_memory_allocated() / 2**20
        if not all(math.isfinite(v) for v in metrics.values()):
            fail(f"{label} {name}: non-finite metrics {metrics}")
        print(f"  {label} {name}: wall {wall:.3f} s (ends in synchronize), "
              f"{sim.num_devices * sim.T / wall:.4g} devslots/s, peak "
              f"{peak:.1f} MiB, launches {counts}", flush=True)
        out[name] = (metrics, wall, peak, counts)
    return out


def streamed_runs(label, sim, pool, device, block_ns=(None, 256)):
    """The materialized chunked run and the streamed run (slab 64, chunk
    16) per rollout kernel, through simulate_service; every streamed
    run's metrics equal the materialized run's of the same kernel."""
    runs = []
    for bn in block_ns:
        tag = "K1" if bn is None else f"K2 block_n={bn}"
        runs.append((f"materialized {tag}", dict(engine="chunked", chunk=16,
                                                  block_n=bn)))
        runs.append((f"streamed {tag}", dict(engine="chunked", chunk=16,
                                             block_n=bn, materialize=False,
                                             slab=64)))
    out = service_runs(label, sim, pool, device, runs)
    for name, (m, _, _, counts) in out.items():
        kernel = "onalgo_chunked" if " K1" in name else "onalgo_tiled"
        need = [kernel] + (["draws"] if name.startswith("streamed") else [])
        if any(counts.get(n, 0) <= 0 for n in need):
            fail(f"{label} {name} ran without launching {need}: {counts}")
        ref = out[name.replace("streamed", "materialized")][0]
        if m != ref:
            fail(f"{label} {name}: metrics {m} != the materialized run's "
                 f"{ref}")
    first = next(iter(out.values()))[0]
    print(f"    {label}: streamed == materialized on each kernel (==); "
          f"metrics {json.dumps(first)}")
    agree({n: m for n, (m, *_) in out.items()})
    return out


def fleet_scale(pool, device):
    """Phase 8c: benchmarks/bench_fleet_scale.py's N=10^6 point (T=256,
    slab 64, nothing cut).  Returns the launch counts of the main path's
    run (the streamed K2 run)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import fleet
    from repro_torch.kernels import onalgo_step as k
    from repro_torch.serve.compile import compile_service_streaming
    from repro_torch.serve.simulator import SimConfig, simulate_service
    N, T = FLEET_N, FLEET_T
    sim = SimConfig(num_devices=N, T=T, algo="onalgo", B_n=0.06,
                    H=N / 4 * 2 * 441e6, seed=1)
    stream_series_check(f"N={N} T={T} K2", sim, pool, device, 256)
    out = streamed_runs(f"N={N} T={T}", sim, pool, device)
    plan = k.onalgo_chunked_cuda.plan
    mat = max(peak for name, (_, _, peak, _) in out.items()
              if name.startswith("materialized"))
    main = "streamed K2 block_n=256"
    _, wall, peak, counts = out[main]
    print(f"    K1 at N={N}: the {plan.route} route ({plan.why}); peak "
          f"{peak:.1f} MiB streamed against {mat:.1f} MiB materialized "
          f"(trace and overlay alone T*N*28 B = {T * N * 28 / 2**20:.1f} "
          f"MiB)")
    kw = dict(engine="chunked", chunk=16, block_n=256, materialize=False,
              slab=64)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        simulate_service(sim, pool, device=device, **kw)
        torch.cuda.synchronize()
        time.sleep(0.1)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"    {main}: {busy:.2f} ms device time = busy share "
          f"{busy / (1e3 * wall):.3f} of the unprofiled run "
          f"({1e3 * wall:.1f} ms); top kernels:")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:6]:
        print(f"      {e.self_device_time_total / 1e3:9.3f} ms  "
              f"x{e.count:<5d} {e.key[:70]}")
    # K2's fixed cost a call (its uint16 round trip of counts among it):
    # the intercept of a 64- and a 128-slot call on one slab source
    ss = compile_service_streaming(sim, pool, device=device)
    from repro_torch.core import onalgo
    o_s, h_s, B_eff, H_eff = onalgo.precondition_tables(
        ss.tables[0], ss.tables[1], ss.params)
    j, ov = ss.slab(0, 128)
    sv = fleet._overlay_slot_values(ov, ss.params)
    M = ss.tables[0].shape[0]

    def k2(L, lam0, counts0):
        k.onalgo_tiled_cuda(
            j[:L], lam0, torch.zeros((), device=device), counts0, o_s, h_s,
            ss.tables[2], B_eff, H_eff, ss.rule.a, ss.rule.beta,
            block_n=256, slot_values=tuple(x[:L] for x in sv))

    def fresh(L):
        return lambda: (L, torch.zeros(N, device=device),
                        torch.zeros((N, M), device=device))
    t64 = time_ms(k2, fresh(64), reps=3)
    t128 = time_ms(k2, fresh(128), reps=3)
    fixed = max(2 * t64 - t128, 0.0)
    print(f"    K2 a call at N={N}: 64 slots {t64:.3f} ms, 128 slots "
          f"{t128:.3f} ms: fixed cost a call {fixed:.3f} ms (its uint16 "
          f"round trip of counts among it) = share {fixed / t64:.3f} of a "
          f"64-slot slab's call; {k.onalgo_tiled_cuda.plan.counts} counts")
    del j, ov, sv
    t = time.perf_counter()
    res = fleet.autotune(ss.tables, ss.params, ss.rule, source=ss.slab,
                         T=T, N=N, block_ns=(None, 256), slabs=(64, 128),
                         enforce_slot_capacity=True,
                         repeats=2, warmup=1, device=device)
    print(f"    autotune(source=..., slabs=(64, 128)) over {len(res.timings)} "
          f"candidates in {time.perf_counter() - t:.1f} s: pick "
          f"{res.kwargs} ({1e3 * res.seconds:.1f} ms for 128 slots); "
          + ", ".join(f"{key}: {1e3 * s:.1f}" for key, s in
                      sorted(res.timings.items(), key=lambda kv: kv[1])))
    return counts


def streamed_walk(pool, device, N=100_000, T=512):
    """Phase 8d: phase 6's mobility walk (K=1024, p_handover=0.02, seed 3)
    at 0.2 of its capacity, streamed (Topology.mobility_walk(
    streaming=True), the streaming engine) against the materialized walk
    and workload, on K1-topo and K2-topo."""
    from repro_torch.serve.simulator import SimConfig
    from repro_torch.topology import Topology
    sim = SimConfig(num_devices=N, T=T, B_n=0.06,
                    H=N / 4 * 441e6 * CHECK_H, seed=1)
    dense = Topology.mobility_walk(1024, N, T, sim.H, p_handover=0.02,
                                   seed=3, device=device)
    lazy = Topology.mobility_walk(1024, N, T, sim.H, p_handover=0.02,
                                  seed=3, streaming=True, device=device)
    runs = []
    for bn, kernel in ((None, "onalgo_chunked_topo"),
                       (256, "onalgo_tiled_topo")):
        runs += [(f"{kernel} materialized walk", dict(
                     engine="chunked", chunk=16, block_n=bn,
                     topology=dense)),
                 (f"{kernel} streamed walk", dict(
                     engine="chunked", chunk=16, block_n=bn, topology=lazy,
                     materialize=False, slab=64))]
    out = service_runs(f"walk K=1024 N={N}", sim, pool, device, runs)
    for name, (m, _, _, counts) in out.items():
        kernel = name.split(" ")[0]
        if counts.get(kernel, 0) <= 0:
            fail(f"{name} ran without launching {kernel}")
        ref = out[f"{kernel} materialized walk"][0]
        if m != ref:
            fail(f"{name}: {m} != the materialized walk's {ref}")
        if not m["mu_final"] > 0:
            fail(f"{name}: no mu_k > 0 at the end")
    print(f"    streamed walk == materialized walk on K1-topo and K2-topo "
          f"(==); metrics {json.dumps(next(iter(out.values()))[0])}")


def streaming_engine(pool, device, threefry_slots):
    """Phase 8 (see the module docstring).  Returns the draws kernel's
    row of the kernels line and the main path's launch counts."""
    import torch
    from repro_torch.serve.simulator import SimConfig
    phase("phase 8a: the draws kernel against its plain version")
    row = check_draws(device, threefry_slots)
    gc.collect()
    torch.cuda.empty_cache()
    N, T = 100_000, 512
    sim = SimConfig(num_devices=N, T=T, B_n=0.06, H=0.5 * N * 441e6, seed=0)
    print("  compile_service on the kernel (phase 3b's split re-run):")
    lowering_stages(sim, pool, device)
    phase("phase 8b: phase 3's service through the streaming engine")
    stream_series_check(f"N={N} T={T} K1", sim, pool, device, None)
    stream_series_check(f"N={N} T={T} K2", sim, pool, device, 256)
    range_flag_check(device)
    streamed_runs(f"N={N} T={T}", sim, pool, device)
    gc.collect()
    torch.cuda.empty_cache()
    phase("phase 8c: the fleet-scale point, N=10^6")
    counts = fleet_scale(pool, device)
    gc.collect()
    torch.cuda.empty_cache()
    phase("phase 8d: phase 6's mobility walk, streamed")
    streamed_walk(pool, device)
    return row, counts


# --------------------------------------------------------------------------
# Phase 9: the scenario engine and the sweeps

EXACT_SERIES = ("offloads", "admits", "tasks")
# Phase 9c: benchmarks/bench_convergence.py's sweep scale (N=8) and the
# reference's step-rule and budget axes: (i) a x beta x B x H, 64 cells
# (B takes four values, as in (ii)); (ii), (iii) a x B, 16 cells
SWEEP_A = (0.1, 0.2, 0.5, 1.0)
SWEEP_BETA = (0.5, 0.75)
SWEEP_B = (0.04, 0.06, 0.08, 0.1)
SWEEP_CAP = (0.15, 0.25)  # H = cap * N * 441e6


def series_agree(label, got, want):
    """Two runs' series at the cross-engine bar (rel=2e-5, abs=1e-5;
    offloads, admits and tasks exactly)."""
    import torch
    for key, w in want.items():
        g, w = got[key].detach().cpu().double(), w.detach().cpu().double()
        if key in EXACT_SERIES:
            if not torch.equal(g, w):
                fail(f"{label}: series {key} differs in "
                     f"{int((g != w).sum())} slots")
        elif not torch.allclose(g, w, rtol=REL, atol=ABS):
            fail(f"{label}: series {key} differs by "
                 f"{float((g - w).abs().max()):g}")


def scenario_metrics(series):
    """A run's aggregate metrics (the cross-engine bar's quantities):
    offload and admit shares of the tasks, reward a task, mean power a
    device and load a slot, the last and the mean mu."""
    tasks = float(series["tasks"].sum())
    return {"offload_frac": float(series["offloads"].sum()) / tasks,
            "admit_frac": float(series["admits"].sum()) / tasks,
            "reward_per_task": float(series["reward"].sum()) / tasks,
            "avg_power_per_dev": float(series["power_per_dev"].mean()),
            "avg_load": float(series["load"].mean()),
            "mu_final": float(series["mu"][-1]),
            "mu_mean": float(series["mu"].mean())}


def rollout_kernel(compiled, block_n):
    """The rollout kernel a chunked run of ``compiled`` launches."""
    topo = compiled.topology is not None and compiled.topology.K > 1
    return (("onalgo_tiled" if block_n else "onalgo_chunked")
            + ("_topo" if topo else ""))


def scenario_kinds(device):
    """Phase 9a: every kind of default_scenarios() (T=2000, N=8) and every
    catalog entry, compiled on the card and on the CPU (equal), run on
    scan, chunked (K1 / K1-topo) and chunked block_n=4 (K2 / K2-topo).
    Each card engine is held to the CPU port's same engine (the kernels
    share their plain versions' summation order): K1 and K2 to the CPU
    chunked run, scan (K3 once a slot on the card) to the CPU scan with
    K3's plain version; one rollout call a kernel run; no offload while a
    fleet-wide outage lasts.  The engines agree with scan (card and CPU)
    at the reference's own cross-engine size, T=240 and N=6
    (tests/test_scenarios.py's _small): over 2000 slots the engines'
    different summation orders flip a threshold now and then and the
    duals' paths part, so their offloads there are counted, not held."""
    import dataclasses
    import torch
    from repro_torch.core.onalgo import StepRule
    from repro_torch.kernels import ops
    from repro_torch.scenarios import (CatalogEntry, compile_scenario,
                                       default_scenarios, load_catalog,
                                       run_scenario)
    rule = StepRule.inv_sqrt(0.5)
    small = lambda s: dataclasses.replace(s, T=240, N=6)
    items = [(s.kind, lambda dev, s=s: compile_scenario(s, device=dev),
              lambda dev, s=s: compile_scenario(small(s), device=dev))
             for s in default_scenarios()]
    items += [(f"catalog {name}", lambda dev, e=e: e.compile(device=dev),
               lambda dev, e=e: CatalogEntry(
                   e.name, small(e.base), tuple(small(m) for m in e.modifiers)
               ).compile(device=dev))
              for name, e in load_catalog().items()]
    engines = (("scan", dict(engine="scan")),
               ("K1", dict(engine="chunked", chunk=8)),
               ("K2", dict(engine="chunked", chunk=8, block_n=4)))
    for label, make, make_small in items:
        cpu, card = make("cpu"), make(device)
        for x, y in ((card.trace.j_idx, cpu.trace.j_idx),
                     (card.trace.d_local, cpu.trace.d_local),
                     *zip(card.tables, cpu.tables)):
            if not torch.equal(x.cpu(), y):
                fail(f"{label}: compiled on the card != on the cpu")
        T = card.trace.T
        topo = card.topology is not None and card.topology.K > 1
        want = {"K1": run_scenario(cpu, rule=rule, engine="chunked",
                                   chunk=8, device="cpu")[0]}
        want["K2"] = want["K1"]
        if not topo:
            want["scan"] = run_scenario(cpu, rule=rule, engine="scan",
                                        use_kernel=True, device="cpu")[0]
        runs = {}
        for eng, kw in engines:
            ops.reset_launch_counts()
            got, _, _ = run_scenario(card, rule=rule, device=device, **kw)
            torch.cuda.synchronize()
            counts = {n: c for n, c in ops.launch_counts().items() if c}
            kernel = (rollout_kernel(card, kw.get("block_n"))
                      if eng != "scan" else "onalgo_duals")
            n_want = 1 if eng != "scan" else (0 if topo else T)
            if counts != ({kernel: n_want} if n_want else {}):
                fail(f"{label} {eng}: launch counts {counts}, expected "
                     f"{n_want} of {kernel}")
            if eng in want:
                series_agree(f"{label} {eng} (card vs cpu)", got, want[eng])
            runs[eng] = got
            if "outage_starts" in card.meta:
                off = got["offloads"].cpu().numpy()
                if off[card.meta["down"]].sum() or not off.sum():
                    fail(f"{label} {eng}: offloads while the cloudlet is "
                         "down, or none at all")
        flips = int((runs["K1"]["offloads"] != runs["scan"]["offloads"])
                    .sum())
        c_small, d_small = make_small("cpu"), make_small(device)
        base = run_scenario(c_small, rule=rule, engine="scan",
                            device="cpu")[0]
        for eng, kw in engines:
            series_agree(f"{label} {eng} at T=240 vs cpu scan",
                         run_scenario(d_small, rule=rule, device=device,
                                      **kw)[0], base)
        print(f"  {label}: T={T} N={card.trace.N} M={card.M}"
              + (f" K={card.topology.K}" if topo else "")
              + f": {rollout_kernel(card, None)}, {rollout_kernel(card, 4)}"
              + ("" if topo else ", scan + K3")
              + " == the cpu's; at T=240 every engine == cpu scan; at "
              f"T={T} K1 and scan differ in {flips} slots' offloads; "
              f"mu_final {float(runs['K1']['mu'][-1]):.4g}")


def full_width_scenarios(device, N=100_000, T=512):
    """Phase 9b: the catalog's chains at the service fleet's size: the
    metro_daily chain (bursty_counter, diurnal period 128 amp 0.7, churn
    0.25) on scan, K1 and K2; the metro_mobility chain (mobility K=4
    p_handover 0.03, cloudlet_outage down_k 2 for 64 slots) on scan,
    K1-topo and K2-topo; heterogeneous (its (N, M) h and w send K1 to the
    streaming route).  Each: compile seconds, the run's wall, devslots/s,
    peak memory, the route; K1 and K2 equal (the kernels share one
    summation order), and scan agrees with them on the run's metrics at
    the cross-engine bar (a per-slot series of 10^5 devices may differ by
    a flipped threshold: see phase 9a).  (bursty_trace's and
    flash_crowd's per-device host loops stay out.)"""
    import torch
    from repro_torch.core.onalgo import StepRule
    from repro_torch.kernels import onalgo_step as k
    from repro_torch.kernels import ops
    from repro_torch.scenarios import (Scenario, compile_scenario, compose,
                                       run_scenario)
    rule = StepRule.inv_sqrt(0.5)
    kw = dict(T=T, N=N)
    chains = {
        "metro_daily": [
            Scenario("bursty_counter", seed=3, task_prob=0.6, **kw),
            Scenario("diurnal", seed=3, **kw).with_extra(period=128,
                                                         amp=0.7),
            Scenario("churn", seed=3, **kw).with_extra(churn_frac=0.25)],
        "metro_mobility": [
            Scenario("bursty_counter", seed=11, **kw),
            Scenario("mobility", seed=11, **kw).with_extra(K=4,
                                                           p_handover=0.03),
            Scenario("cloudlet_outage", seed=11, **kw).with_extra(
                K=4, n_outages=1, outage_len=64, down_k=2)],
        "heterogeneous": [Scenario("heterogeneous", seed=0, **kw)
                          .with_extra(o_spread=0.5)],
    }
    for name, specs in chains.items():
        torch.cuda.synchronize()
        t = time.perf_counter()
        c = compile_scenario(specs[0], device=device)
        for mod in specs[1:]:
            c = compose(c, mod)
        torch.cuda.synchronize()
        print(f"  {name} (N={N}, T={T}, M={c.M}): compiled in "
              f"{time.perf_counter() - t:.2f} s")
        runs = {}
        for eng, ekw in (("scan", dict(engine="scan")),
                         ("K1", dict(engine="chunked", chunk=16)),
                         ("K2", dict(engine="chunked", chunk=16,
                                     block_n=256))):
            run_scenario(c, rule=rule, device=device, **ekw)  # warm
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t = time.perf_counter()
            series, _, _ = run_scenario(c, rule=rule, device=device, **ekw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            counts = {n: v for n, v in ops.launch_counts().items() if v}
            route = ""
            if eng == "K1":
                plan = (k.onalgo_chunked_topo_cuda.plan if c.topology
                        else k.onalgo_chunked_cuda.plan)
                route = f"; K1 on the {plan.route} route ({plan.why})"
            if not all(torch.isfinite(v).all() for v in series.values()):
                fail(f"{name} {eng}: non-finite series")
            runs[eng] = series
            print(f"    {eng}: {1e3 * wall:.2f} ms, {N * T / wall:.4g} "
                  f"devslots/s, peak "
                  f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
                  f"launches {counts}{route}")
        series_agree(f"{name} K2 vs K1", runs["K2"], runs["K1"])
        metrics = {eng: scenario_metrics(r) for eng, r in runs.items()}
        for eng in ("K1", "K2"):
            for key, want in metrics["scan"].items():
                if abs(metrics[eng][key] - want) > REL * abs(want) + ABS:
                    fail(f"{name} {eng} {key}={metrics[eng][key]!r} "
                         f"disagrees with scan's {want!r}")
        flips = int((runs["K1"]["offloads"] != runs["scan"]["offloads"])
                    .sum())
        print(f"    K2 == K1 in every series; the metrics agree with "
              f"scan's (its offloads differ in {flips} of {T} slots): "
              f"{json.dumps(metrics['K1'])}")


def cells_cost(G, T, N, M):
    """Bytes and f32 operations of a G-cell rollout over one trace: j (T,
    N) read once; per cell o' (N, M), h' and w (M,), B and lam (N,),
    counts (N, M) read, off (T, N) bool, mu_seq and lnorm (T,), lam and
    counts written; ``rollout_cost``'s operations per cell."""
    per_cell = (4 * N * M + 8 * M + 8 * N + 4 * N * M
                + T * N + 8 * T + 4 * N + 4 * N * M + 8)
    return 4 * T * N + G * per_cell, G * (10 * T * N * M + 12 * T * N)


def sweep_grid_check(label, c, grid, device, block_n, reps):
    """One grid (phase 9c): the cell-axis rollout of the grid in one call
    (K1 with block_n None, else K2), bit for bit against G single-cell
    calls, its first and last cells against the plain version; timed
    against the loop of the G calls.  Returns (row numbers, the plan)."""
    import torch
    from repro_torch.kernels import onalgo_step as k
    from repro_torch.scenarios.sweeps import cell_tables
    j = c.trace.j_idx
    T, N = j.shape
    M, G = c.M, grid.G
    o_s, h_s, B_eff, H_eff = cell_tables(c.tables[0], c.tables[1],
                                         grid.params)
    w = c.tables[2]
    a, beta = grid.rules.a, grid.rules.beta

    def fresh():
        return (j, torch.zeros((G, N), device=device),
                torch.zeros((G,), device=device),
                torch.zeros((G, N, M), device=device), o_s, h_s, w, B_eff,
                H_eff, a, beta)

    if block_n is None:
        cells = k.onalgo_chunked_cells_cuda
        one = k.onalgo_chunked_cuda
        kw = {}
    else:
        cells = k.onalgo_tiled_cells_cuda
        one = k.onalgo_tiled_cuda
        kw = dict(block_n=block_n)

    def single(g, x):
        return one(x[0], x[1][g], x[2][g], x[3][g], x[4][g],
                   x[5][g].reshape(M), x[6], x[7][g], x[8][g], float(a[g]),
                   float(beta[g]), **kw)

    def loop(*x):
        return [single(g, x) for g in range(G)]

    got = cells(*fresh(), **kw)
    again = cells(*fresh(), **kw)
    plan = cells.plan
    x = fresh()
    singles = loop(*x)
    torch.cuda.synchronize()
    for y, z in zip(got, again):
        if not torch.equal(y, z):
            fail(f"{label}: two calls differ")
    for g, out in enumerate(singles):
        for i, (y, z) in enumerate(zip(got, out)):
            if not torch.equal(y[g], z):
                fail(f"{label}: cell {g} output {i} != its single-cell call")
    err = 0.0
    for g in sorted({0, G - 1}):
        x = fresh()
        want = k.onalgo_chunked_plain(
            x[0], x[1][g], x[2][g], x[3][g], x[4][g], x[5][g].reshape(M),
            x[6], x[7][g], x[8][g], float(a[g]), float(beta[g]))
        err = max(err, hold(f"{label} cell {g}",
                            tuple(y[g] for y in got), want))
    ms = time_ms(lambda *x: cells(*x, **kw), fresh, reps)
    loop_ms = time_ms(loop, fresh, max(1, reps // 2))
    nbytes, nops = cells_cost(G, T, N, M)
    bound, by = bound_ms(nbytes, nops)
    extra = ""
    if block_n is not None:
        extra = (f", G x its streaming floor "
                 f"{G * tiled_floor_ms(T, N, M, N, plan):.3f} ms")
    else:  # o' read every slot, were it from device memory
        extra = (f", o' floor {T * G * N * M * 4 / HBM_BYTES_PER_S * 1e3:.3f}"
                 f" ms (G N M 4 B a slot at the HBM rate)")
    print(f"    {label}: one call {ms:.3f} ms against the loop of {G} "
          f"single-cell calls {loop_ms:.3f} ms ({loop_ms / ms:.2f}x); bound "
          f"{bound:.4f} ms ({by}){extra}; bit for bit with the {G} calls, "
          f"cells 0 and {G - 1} == plain (max |diff| {err:.3g}); plan "
          f"{plan.route if block_n is None else plan.counts}: {plan.why}")
    if block_n is None and plan.route == "cells":
        stamps = torch.zeros((T, k.STAMPS), dtype=torch.int64,
                             device=device)
        cells(*fresh(), stamps=stamps)
        torch.cuda.synchronize()
        print(f"      lane groups of {plan.group_width} threads, "
              f"{plan.lane_groups} a block, {plan.passes} pass(es) a slot, "
              f"{plan.stages} o' stage(s) a group; block 0: "
              + split_text(*slot_split(stamps, "cells", False)))
    return dict(ms=ms, loop_ms=loop_ms, bound_ms=bound, bound_by=by,
                max_abs_err=err), plan


def plain_ms(c, grid, device):
    """One call of the cell-axis plain version on the grid's inputs, on
    the card (CUDA events; the plain version is eager PyTorch, so there is
    nothing to warm up but the allocator)."""
    import torch
    from repro_torch.kernels import onalgo_step as k
    from repro_torch.scenarios.sweeps import cell_tables
    o_s, h_s, B_eff, H_eff = cell_tables(c.tables[0], c.tables[1],
                                         grid.params)
    G, (T, N), M = grid.G, c.trace.j_idx.shape, c.M
    args = (c.trace.j_idx, torch.zeros((G, N), device=device),
            torch.zeros((G,), device=device),
            torch.zeros((G, N, M), device=device), o_s, h_s, c.tables[2],
            B_eff, H_eff, grid.rules.a, grid.rules.beta)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    k.onalgo_cells_plain(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def metro_daily_chain(N, device, T=512):
    """Phase 9c's scenario: metro_daily's chain (bursty_counter, diurnal
    period 128 amp 0.7, churn 0.25; seed 3) at N devices, compiled on
    ``device``."""
    from repro_torch.scenarios import Scenario, compile_scenario, compose
    kw = dict(T=T, N=N)
    c = compile_scenario(Scenario("bursty_counter", seed=3, **kw),
                         device=device)
    c = compose(c, Scenario("diurnal", seed=3, **kw).with_extra(
        period=128, amp=0.7))
    return compose(c, Scenario("churn", seed=3, **kw).with_extra(
        churn_frac=0.25))


def a_by_b_grid(N, H, device):
    """Phase 9c's grids (ii) and (iii): the 16 cells a x B (beta 0.5, the
    capacity H)."""
    import torch
    from repro_torch.core.onalgo import OnAlgoParams, StepRule
    from repro_torch.scenarios import grid_from_cells
    return grid_from_cells([
        (f"a={a}/B={B}", StepRule.power(a, 0.5), OnAlgoParams(
            B=torch.full((N,), B, device=device),
            H=torch.tensor(H, dtype=torch.float32, device=device)))
        for a in SWEEP_A for B in SWEEP_B])


def cell_axis_sweeps(device):
    """Phase 9c: sweeps with the cell axis.  (i) the reference's sweep
    scale: stationary at N=8, T=4000, 64 cells (a x beta x B x H) on K1;
    (ii) 16 cells (a x B) over the metro_daily chain at N=8192, T=512 on
    K1 (one resident launch); (iii) the same 16 cells at N=100000, T=512
    on K2 (block_n 256).  Each grid is one call, bit for bit against G
    single-cell calls, timed against their loop and beside its bound;
    each through sweep_simulate(engine="chunked") with launch counts (one
    call of the cell-axis kernel and nothing else).  Returns the two
    kernels' rows (grid (ii) for K1, (iii) for K2) and the launch counts
    of those grids' sweep runs."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.scenarios import (Scenario, compile_scenario,
                                       product_grid, sweep_simulate)

    def launches_of(c, grid, block_n):
        """The grid through sweep_simulate(engine="chunked"): one call of
        the cell-axis kernel and nothing else, finite series; then the
        wall of a second such sweep, beside the kernel's time."""
        def sweep():
            return sweep_simulate(c.trace, c.tables, grid, engine="chunked",
                                  chunk=16, block_n=block_n,
                                  enforce_slot_capacity=True, device=device)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        series, _ = sweep()
        torch.cuda.synchronize()
        counts = {n: v for n, v in ops.launch_counts().items() if v}
        name = "onalgo_chunked_cells" if block_n is None else \
            "onalgo_tiled_cells"
        if counts != {name: 1}:
            fail(f"sweep_simulate(engine='chunked', block_n={block_n}): "
                 f"launch counts {counts}, expected one {name}")
        if not all(torch.isfinite(v).all() for v in series.values()):
            fail("a sweep's series are not finite")
        t = time.perf_counter()
        sweep()
        torch.cuda.synchronize()
        print(f"    sweep_simulate(engine='chunked'): one {name} launch, "
              f"finite series; a sweep's wall "
              f"{(time.perf_counter() - t) * 1e3:.1f} ms")
        return counts[name]

    daily = lambda N: metro_daily_chain(N, device)
    a_by_b = lambda N, H: a_by_b_grid(N, H, device)
    rows = {}
    print("  (i) stationary N=8, T=4000, 64 cells (a x beta x B x H), K1:")
    c = compile_scenario(Scenario("stationary", T=4000, N=8, seed=0),
                         device=device)
    grid = product_grid(8, a_values=SWEEP_A, beta_values=SWEEP_BETA,
                        B_values=SWEEP_B,
                        H_values=tuple(f * 8 * 441e6 for f in SWEEP_CAP),
                        device=device)
    if grid.G != 64:
        fail(f"grid (i) holds {grid.G} cells, not 64")
    _, plan = sweep_grid_check("K1 cells, 64 x N=8", c, grid, device, None,
                               reps=3)
    if plan.route != "cells" or len(plan.groups) != 1:
        fail(f"grid (i) is not one cell-axis launch: {plan}")
    launches_of(c, grid, None)
    print("  (ii) metro_daily N=8192, T=512, 16 cells (a x B), K1:")
    c = daily(8192)
    grid = a_by_b(8192, c.scenario.H)
    r2, plan = sweep_grid_check("K1 cells, 16 x N=8192", c, grid, device,
                                None, reps=3)
    if plan.route != "cells" or len(plan.groups) != 1:
        fail(f"grid (ii) is not one resident launch: {plan}")
    k1_launches = launches_of(c, grid, None)
    r2["plain_ms"] = plain_ms(c, grid, device)
    rows["onalgo_chunked_cells"] = r2
    print(f"    its plain version (onalgo_chunked_plain cell by cell, on "
          f"the card): {r2['plain_ms']:.1f} ms")
    print("  (iii) metro_daily N=100000, T=512, the same 16 cells, K2 "
          "(block_n 256):")
    c = daily(100_000)
    grid = a_by_b(100_000, c.scenario.H)
    r3, plan = sweep_grid_check("K2 cells, 16 x N=100000", c, grid, device,
                                256, reps=2)
    k2_launches = launches_of(c, grid, 256)
    r3["plain_ms"] = plain_ms(c, grid, device)
    print(f"    its plain version on the card: {r3['plain_ms']:.1f} ms")
    rows["onalgo_tiled_cells"] = r3
    out = [dict(name=name, library_ms=None, **r) for name, r in rows.items()]
    return out, {"onalgo_chunked_cells": k1_launches,
                 "onalgo_tiled_cells": k2_launches}


def scenario_engine(device):
    """Phase 9 (see the module docstring).  Returns the two cell-axis
    kernels' rows of the kernels line and their launch counts."""
    import torch
    phase("phase 9a: every scenario kind and catalog entry")
    scenario_kinds(device)
    phase("phase 9b: the scenario chains at full width")
    full_width_scenarios(device)
    gc.collect()
    torch.cuda.empty_cache()
    phase("phase 9c: sweeps with the cell axis")
    return cell_axis_sweeps(device)


# --------------------------------------------------------------------------
# Phase 10: the gain tier and the live serving gateway

GAIN_S, GAIN_C = 16384, 10  # the gain pool: S images, C classes
GAIN_N, GAIN_T = 100_000, 512  # 10a: the service fleet of phase 3
GATEWAY_T = 256  # 10c: slots the gateway serves
PROFILED_TICKS = 64  # 10c: ticks under torch.profiler for the busy share
PROFILE_TRIES = 3  # 10c: profiles tried for one that holds every K3 record


def gain_problem():
    """The gain pool and its model sources: oracle_pool over
    synthetic_gain_problem(S=16384, C=10, seed=0) (its phi_hat ARE the
    true gains), and ``models(device)``: {"ridge": the class-specific
    ridge fitted on it, "seq": a seeded, untrained SSD head (phase 13e
    trains one)} as ModelGain sources with their weights on ``device``
    (the head drawn on the CPU, so every device gets the same weights)."""
    import torch
    from repro_torch.gain import (ModelGain, SeqGainConfig, SeqGainModel,
                                  fit_ridge_gain, oracle_pool,
                                  synthetic_gain_problem)
    from repro_torch.gain.model import init_seq_params
    probs, gains = synthetic_gain_problem(S=GAIN_S, C=GAIN_C, seed=0)
    pool = oracle_pool(probs, gains, seed=0)
    cfg = SeqGainConfig(feat_dim=GAIN_C + 4)

    def models(device, quantize=True):
        seq = SeqGainModel(cfg=cfg, params=init_seq_params(
            torch.Generator().manual_seed(0), cfg, device=device),
            sigma=torch.full((GAIN_C,), 0.02, device=device))
        return {"ridge": ModelGain(fit_ridge_gain(probs, gains,
                                                  device=device), probs,
                                   quantize=quantize),
                "seq": ModelGain(seq, probs, quantize=quantize)}
    return pool, models


def gain_sim(T=None, N=None):
    """10a's (and 10c's, with T=GATEWAY_T) SimConfig: phase 3's fleet."""
    from repro_torch.serve.simulator import SimConfig
    T = GAIN_T if T is None else T
    N = GAIN_N if N is None else N
    return SimConfig(num_devices=N, T=T, B_n=0.06, H=0.5 * N * 441e6, seed=0)


def timed_s(fn):
    """(fn(), seconds) with the card drained before and after."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def gain_engines(sim, pool, src, device):
    """One source on the four service engines of 10a: {engine: (metrics,
    wall s, launch counts)}: chunked (K1), block_n=256 (K2), the slot loop
    with use_kernel (K3 once a slot) and streamed (materialize=False, K1
    over slabs of 64)."""
    from repro_torch.core.fleet import simulate
    from repro_torch.kernels import ops
    from repro_torch.serve.compile import compile_service, service_metrics
    from repro_torch.serve.simulator import simulate_service

    def slot_loop():
        cs = compile_service(sim, pool, gain_source=src, device=device)
        series, _ = simulate(*cs.simulate_args(), cs.rule, use_kernel=True,
                             enforce_slot_capacity=True, overlay=cs.overlay,
                             device=device)
        return service_metrics(sim, series)

    runs = {"K1": lambda: simulate_service(sim, pool, engine="chunked",
                                           chunk=16, gain_source=src,
                                           device=device),
            "K2": lambda: simulate_service(sim, pool, engine="chunked",
                                           chunk=16, block_n=256,
                                           gain_source=src, device=device),
            "scan+K3": slot_loop,
            "streamed": lambda: simulate_service(
                sim, pool, engine="chunked", chunk=16, materialize=False,
                slab=64, gain_source=src, device=device)}
    expect = {"K1": "onalgo_chunked", "K2": "onalgo_tiled",
              "scan+K3": "onalgo_duals", "streamed": "onalgo_chunked"}
    out = {}
    for eng, run in runs.items():
        ops.reset_launch_counts()
        metrics, wall = timed_s(run)
        counts = {n: c for n, c in ops.launch_counts().items() if c}
        if not counts.get(expect[eng]):
            fail(f"10a {eng}: {expect[eng]} never launched ({counts})")
        if eng == "scan+K3" and counts.get("onalgo_duals") != sim.T:
            fail(f"10a scan+K3: K3 launched {counts.get('onalgo_duals')} "
                 f"times in {sim.T} slots")
        out[eng] = (metrics, wall, counts)
    return out


def card_vs_cpu_run(label, sim, pool, src_card, src_cpu, device):
    """A chunked (K1) run on the card against the CPU port's chunked run
    (plain versions) on the same tables: offloads, admits and tasks per
    slot exactly, the final duals within RTOL / ATOL."""
    import torch
    from repro_torch.core.fleet import simulate_chunked
    from repro_torch.serve.compile import compile_service
    res = []
    for dev, src in ((device, src_card), ("cpu", src_cpu)):
        cs = compile_service(sim, pool, gain_source=src, device=dev)
        res.append(simulate_chunked(*cs.simulate_args(), cs.rule, chunk=16,
                                    overlay=cs.overlay,
                                    enforce_slot_capacity=True, device=dev))
    (s_card, f_card), (s_cpu, f_cpu) = res
    for key in EXACT_SERIES:
        if not torch.equal(s_card[key].cpu(), s_cpu[key]):
            fail(f"{label}: series {key} card != cpu")
    err = max(check_close(f"{label} lam", f_card.lam.cpu(), f_cpu.lam),
              check_close(f"{label} mu", f_card.mu.cpu(), f_cpu.mu))
    return err


def gain_sources_phase(device, smi, pool, models):
    """Phase 10a: the gain sources at the service fleet (N=100000, T=512,
    M=73; pool S=16384).  TableGain / OverlayGain equal gain_source=None,
    metrics exactly, on K1, K2, the slot loop with K3 and streamed;
    ModelGain(ridge) resolves on the card to the CPU port's tables exactly
    (snapped and not), ModelGain(seq) within K4's bar (its chunk scan is
    K4 on the card, the plain version on the CPU); their K1 runs equal the
    CPU port's chunked run (T=32 prefix, the CPU's plain rollout of 10^5
    devices being slow: decisions exactly, duals at RTOL / ATOL; seq on the
    card's resolved tables, frozen); resolution ms, walls, devslots/s;
    K4 held at the head's shape.  Returns (K4 row, K4 launches of the seq
    run)."""
    import dataclasses
    import torch
    from repro_torch.gain import OverlayGain, TableGain
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_chunk as sc
    sim = gain_sim()
    card, cpu = models(device), models("cpu")
    print(f"  [{smi}] N={sim.num_devices} T={sim.T}, pool S={GAIN_S} C="
          f"{GAIN_C}")
    base = gain_engines(sim, pool, None, device)
    for name, src in (("table", TableGain()), ("overlay", OverlayGain())):
        runs = gain_engines(sim, pool, src, device)
        for eng, (m, wall, _) in runs.items():
            if any(m[k] != base[eng][0][k] for k in METRICS):
                fail(f"10a {name} on {eng}: metrics differ from "
                     f"gain_source=None")
            print(f"  {name:8s} {eng:8s}: == gain_source=None; wall "
                  f"{wall:.3f} s, {sim.num_devices * sim.T / wall:.4g} "
                  f"devslots/s")
    for eng, (m, wall, counts) in base.items():
        print(f"  none     {eng:8s}: wall {wall:.3f} s, "
              f"{sim.num_devices * sim.T / wall:.4g} devslots/s, launches "
              f"{counts}, accuracy {m['accuracy']:.6f}")
    seq_launches = None
    for name in ("ridge", "seq"):
        src, ref = card[name], cpu[name]
        src.tables(pool, sim, device=device)  # first call: K4's library
        ops.reset_launch_counts()
        (gt, res_s) = timed_s(lambda: src.tables(pool, sim, device=device))
        counts = {n: c for n, c in ops.launch_counts().items() if c}
        want = ref.tables(pool, sim, device="cpu")
        raw = models(device, quantize=False)[name].tables(pool, sim,
                                                          device=device)
        raw_cpu = models("cpu", quantize=False)[name].tables(pool, sim,
                                                             device="cpu")
        n_diff = int((gt.phi_hat.cpu() != want.phi_hat).sum())
        if name == "ridge":
            if n_diff or not torch.equal(raw.phi_hat.cpu(), raw_cpu.phi_hat):
                fail(f"10a ridge: card tables differ from the cpu's "
                     f"({n_diff} snapped entries)")
            detail = "snapped and raw tables equal to the cpu's"
            cpu_src = ref
        else:
            if counts.get("ssd_chunk") != 1:
                fail(f"10a seq: K4 launched {counts} in one resolution")
            err = check_close("10a seq raw phi (card vs cpu)", raw.phi_hat,
                              raw_cpu.phi_hat.to(device), **sc.TOLERANCE)
            detail = (f"raw phi within K4's bar of the cpu's (max |diff| "
                      f"{err:.3g}); snapped tables differ from the cpu's in "
                      f"{n_diff} of {GAIN_S} entries; K4 launches {counts}")
            cpu_src = TableGain()
        if not torch.equal(gt.sigma.cpu(), want.sigma):
            fail(f"10a {name}: sigma differs card vs cpu")
        # decisions: card K1 against the cpu port's chunked run
        short = dataclasses.replace(sim, T=32)
        frozen = (pool if name == "ridge"
                  else src.to_pool_tables(pool, sim, device=device))
        err = card_vs_cpu_run(f"10a {name}", short, frozen,
                              src if name == "ridge" else TableGain(),
                              cpu_src, device)
        ops.reset_launch_counts()
        from repro_torch.serve.simulator import simulate_service
        m, wall = timed_s(lambda: simulate_service(
            sim, pool, engine="chunked", chunk=16, gain_source=src,
            device=device))
        if name == "seq":
            seq_launches = ops.launch_counts()["ssd_chunk"]
        print(f"  {name:8s}: resolved in {1e3 * res_s:.3f} ms; {detail}; "
              f"K1 at T=32 == the cpu's chunked run (duals max |diff| "
              f"{err:.3g}); K1 at T={sim.T}: wall {wall:.3f} s, "
              f"{sim.num_devices * sim.T / wall:.4g} devslots/s, accuracy "
              f"{m['accuracy']:.6f}, offload_frac {m['offload_frac']:.6f}")
    gen = torch.Generator(device=device).manual_seed(21)
    row = check_ssd(f"gain head (S={GAIN_S})",
                    (1, GAIN_S // 128, 128, 2, 16, 8), 1, gen, reps=50)
    return row, seq_launches


def regret_phase(device, smi, pool, models):
    """Phase 10b: evaluate_regret over GATE_SCENARIOS at the catalog's
    sizes, max_T=600, on the card's scan and chunked engines, equal to
    the CPU port's rows (accuracy, offload share, tasks); ridge's mean
    regret at most 0.15 (the reference's gate).  Then metro_daily at
    N=10^5, T=512 (phase 9b's chain): each source through scenario_sim and
    simulate_service on K1, against TableGain as the oracle."""
    from repro_torch.gain import (GATE_SCENARIOS, OverlayGain, TableGain,
                                  evaluate_regret)
    from repro_torch.gain.regret import scenario_sim
    from repro_torch.serve.simulator import simulate_service
    card, cpu = models(device), models("cpu")
    print(f"  [{smi}]")
    for engine in ("scan", "chunked"):
        kw = dict(max_T=600, engine=engine)
        got, wall = timed_s(lambda: evaluate_regret(
            {"table": TableGain(), "overlay": OverlayGain(),
             "ridge": card["ridge"]}, pool, device=device, **kw))
        want = evaluate_regret({"table": TableGain(), "overlay": OverlayGain(),
                                "ridge": cpu["ridge"]}, pool, device="cpu",
                               **kw)
        if got != want:
            fail(f"10b {engine}: regret rows differ card vs cpu: {got} vs "
                 f"{want}")
        mean = got["mean_regret"]
        if mean["table"] != 0.0 or mean["overlay"] != 0.0 or \
                not mean["ridge"] <= 0.15:
            fail(f"10b {engine}: mean regret {mean} (table and overlay 0, "
                 f"ridge <= 0.15)")
        rows = "; ".join(
            f"{sc} ridge acc {got['scenarios'][sc]['ridge']['accuracy']:.4f}"
            f" regret {got['scenarios'][sc]['ridge']['regret']:+.4f}"
            for sc in GATE_SCENARIOS)
        print(f"  evaluate_regret {engine}: == the cpu's; mean regret "
              f"ridge {mean['ridge']:+.4f}, table {mean['table']:+.4f}, "
              f"overlay {mean['overlay']:+.4f}; {rows}; wall {wall:.2f} s")
    c, comp_s = timed_s(lambda: metro_daily_chain(GAIN_N, device))
    sim = scenario_sim(c)
    on = c.task_mask()[:sim.T]
    sources = {"table": TableGain(), "overlay": OverlayGain(), **card}
    acc = {}
    for name, src in sources.items():
        m, wall = timed_s(lambda: simulate_service(
            sim, pool, on=on, engine="chunked", chunk=16, gain_source=src,
            device=device))
        acc[name] = m["accuracy"]
        regret = (acc["table"] - m["accuracy"]) / max(acc["table"], 1e-9)
        if name == "overlay" and regret != 0.0:
            fail("10b metro_daily: overlay's regret is not 0")
        print(f"  metro_daily N={sim.num_devices} T={sim.T} (compiled in "
              f"{comp_s:.2f} s) {name:8s}: accuracy {m['accuracy']:.6f}, "
              f"regret {regret:+.4f}, offload_frac {m['offload_frac']:.4f}, "
              f"K1 wall {wall:.3f} s")


def replay_masks(replies, waves, T, N):
    import numpy as np
    off = np.zeros((T, N), bool)
    adm = np.zeros_like(off)
    for t, r in enumerate(replies):
        if r.fallback or r.t != t:
            fail(f"10c: wave {t} answered by slot {r.t}, fallback "
                 f"{r.fallback}")
        off[t, waves[t].idx] = r.offload
        adm[t, waves[t].idx] = r.admitted
    return off, adm


def tick_split(core, waves):
    """Per-tick dispatch and resolve ms (tick_async, then resolve_timed),
    and the loop's wall."""
    import numpy as np
    disp, res = [], []
    t_all = time.perf_counter()
    for wv in waves:
        t0 = time.perf_counter()
        p = core.tick_async(wv.idx, wv.o, wv.h, wv.w)
        t1 = time.perf_counter()
        core.resolve_timed(p)
        t2 = time.perf_counter()
        disp.append(1e3 * (t1 - t0))
        res.append(1e3 * (t2 - t1))
    wall = time.perf_counter() - t_all
    d, r = np.asarray(disp), np.asarray(res)
    return d, r, d + r, wall


def gateway_phase(device, smi, pool, models):
    """Phase 10c: GatewayCore.for_sim(gain_source=ModelGain(ridge)) at
    N=100000 with default_buckets, fed by ServiceLoadGen(slab=64) over
    T=256 slots: the closed loop and the pipelined loop at depths 1, 2, 4
    give the decisions of the card's fleet.simulate(collect_decisions,
    enforce_slot_capacity, overlay, use_kernel) on the same service, K3
    once a tick; tick_async never waits for the card; warmup seconds,
    the tick's p50 / p99 split into dispatch and resolve, waves/s, the
    tick loop's busy share (torch.profiler);
    again under mobility_walk(1024, p_handover=0.02, seed=3,
    streaming=True) at 0.2 of the capacity (the plain topology route, no
    K3; the mu_k move); a LiveGateway soak
    of 200 waves at a 50 ms SLO: no shed, no fallback, decisions equal.
    Returns (K3 row at the gateway's state, K3 launches of the closed
    loop)."""
    import numpy as np
    import torch
    from repro_torch.core import onalgo
    from repro_torch.core.fleet import simulate
    from repro_torch.kernels import ops
    from repro_torch.serve.compile import (compile_service,
                                           compile_service_streaming)
    from repro_torch.serve.gateway import (GatewayCore, default_buckets,
                                           run_closed_loop,
                                           run_pipelined_loop)
    from repro_torch.topology import Topology
    from repro_torch.workload import ServiceLoadGen
    ridge = models(device)["ridge"]
    sim = gain_sim(T=GATEWAY_T, N=GAIN_N)
    N, T = sim.num_devices, sim.T
    print(f"  [{smi}] N={N} T={T}, buckets {default_buckets(N)}")

    def oracle(topology=None):
        cs = compile_service(sim, pool, gain_source=ridge, device=device)
        series, _ = simulate(*cs.simulate_args(), cs.rule,
                             use_kernel=topology is None, overlay=cs.overlay,
                             enforce_slot_capacity=True, topology=topology,
                             collect_decisions=True, device=device)
        return (series["offload_mask"].cpu().numpy(),
                series["admit_mask"].cpu().numpy())

    st = compile_service_streaming(sim, pool, gain_source=ridge,
                                   device=device)
    waves = list(ServiceLoadGen(st, slab=64).waves())
    reports = sum(w.size for w in waves)
    want = oracle()
    core, build_s = timed_s(lambda: GatewayCore.for_sim(
        sim, pool, gain_source=ridge, device=device))
    _, warm_s = timed_s(core.warmup)
    ops.reset_launch_counts()
    (replies, stats), wall = timed_s(lambda: run_closed_loop(
        core, ServiceLoadGen(st, slab=64), slo_ms=1e9))
    k3 = ops.launch_counts()["onalgo_duals"]
    if k3 != T:
        fail(f"10c: K3 launched {k3} times in {T} ticks")
    got = replay_masks(replies, waves, T, N)
    if not (np.array_equal(got[0], want[0])
            and np.array_equal(got[1], want[1])):
        fail(f"10c closed loop: {int((got[0] != want[0]).sum())} offload, "
             f"{int((got[1] != want[1]).sum())} admit decisions differ "
             f"from fleet.simulate")
    duals = (core.state.lam, core.state.mu, core.state.rho.rho,
             *onalgo.precondition_tables(core.tables[0], core.tables[1],
                                         core.params)[:2], core.tables[2],
             torch.ones_like(core.params.B))
    print(f"  for_sim (ridge) {build_s:.3f} s; warmup {warm_s:.3f} s "
          f"({len(default_buckets(N))} buckets); closed loop: {T} waves, "
          f"{reports} reports, == fleet.simulate; K3 {k3} launches (one a "
          f"tick); wall {wall:.3f} s, {T / wall:.1f} waves/s, p50 "
          f"{stats.percentile(50):.3f} ms, p99 {stats.percentile(99):.3f} ms")
    row = duals_row(f"gateway tick (N={N}, the state after {T} ticks)",
                    duals, reps=50, count_kernels=False)
    # tick_async never waits for the card: 16 dispatches under sync debug
    # mode "error", then one behind a sleep kernel whose event must not
    # have fired when it returns
    core = GatewayCore.for_service(st)
    core.warmup()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = [core.tick_async(w.idx, w.o, w.h, w.w) for w in waves[:16]]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for p in pending:
        core.resolve_timed(p)
    torch.cuda._sleep(int(3e8))
    p = core.tick_async(waves[16].idx, waves[16].o, waves[16].h,
                        waves[16].w)
    if p.done():
        fail("10c: tick_async waited for the card (its decisions' event "
             "had fired behind a sleep kernel)")
    core.resolve_timed(p)
    print("  tick_async: 16 dispatches under sync debug mode 'error'; "
          "behind a sleep kernel it returns before its decisions land")
    for depth in (1, 2, 4):
        core = GatewayCore.for_service(st)
        core.warmup()
        (replies, stats), wall = timed_s(lambda: run_pipelined_loop(
            core, ServiceLoadGen(st, slab=64, prefetch=True),
            max_in_flight=depth, slo_ms=1e9))
        got = replay_masks(replies, waves, T, N)
        if not (np.array_equal(got[0], want[0])
                and np.array_equal(got[1], want[1])):
            fail(f"10c pipelined depth {depth}: decisions differ")
        print(f"  pipelined depth {depth}: == fleet.simulate; "
              f"{T / wall:.1f} waves/s, p50 {stats.percentile(50):.3f} ms, "
              f"p99 {stats.percentile(99):.3f} ms, in flight up to "
              f"{stats.max_in_flight_seen}")
    core = GatewayCore.for_service(st)
    core.warmup()
    d, r, tot, loop_wall = tick_split(core, waves)
    # the busy share over the first PROFILED_TICKS ticks, against the same
    # ticks' unprofiled times, read from a trace that holds every tick's
    # K3 record (the profiler now and then loses records late in a run:
    # up to PROFILE_TRIES profiles; none whole, no share)
    window = float(tot[:PROFILED_TICKS].sum())
    busy = None
    for attempt in range(1, PROFILE_TRIES + 1):
        core = GatewayCore.for_service(st)
        core.warmup()
        prof = profiled(lambda: [core.tick(w.idx, w.o, w.h, w.w)
                                 for w in waves[:PROFILED_TICKS]])
        k3_seen = sum(n for key, (n, _) in prof.items()
                      if "onalgo_duals_kernel" in key)
        if k3_seen == PROFILED_TICKS:
            busy = sum(ms for key, (_, ms) in prof.items()
                       if SPIN_KERNEL not in key)
            break
    pct = lambda x, q: float(np.percentile(x, q))
    share = (f"device busy {busy:.2f} ms of the first {PROFILED_TICKS} "
             f"ticks' {window:.2f} ms = busy share {busy / window:.3f} "
             f"(profile {attempt}: all {PROFILED_TICKS} K3 records)"
             if busy is not None else
             f"busy share not measured ({PROFILE_TRIES} profiles, the last "
             f"with {k3_seen} of {PROFILED_TICKS} K3 records)")
    print(f"  tick (tick_async + resolve_timed): p50 {pct(tot, 50):.3f} ms "
          f"(dispatch {pct(d, 50):.3f}, resolve {pct(r, 50):.3f}), p99 "
          f"{pct(tot, 99):.3f} ms (dispatch {pct(d, 99):.3f}, resolve "
          f"{pct(r, 99):.3f}); {T / loop_wall:.1f} waves/s; {share}")
    # the mobility walk: K = 1024 cloudlets, the plain topology route, at
    # 0.2 of the capacity (as phase 6's walk), where the mu_k move
    topo = Topology.mobility_walk(1024, N, T, CHECK_H * sim.H,
                                  p_handover=0.02, seed=3, streaming=True,
                                  device=device)
    want_topo = oracle(topo)
    core = GatewayCore.for_sim(sim, pool, gain_source=ridge, topology=topo,
                               device=device)
    core.warmup()
    ops.reset_launch_counts()
    d, r, tot, loop_wall = tick_split(core, waves)
    counts = {n: c for n, c in ops.launch_counts().items() if c}
    core = GatewayCore.for_sim(sim, pool, gain_source=ridge, topology=topo,
                               device=device)
    off = np.zeros((T, N), bool)
    adm = np.zeros_like(off)
    for wv in waves:
        o, a = core.tick(wv.idx, wv.o, wv.h, wv.w)
        off[wv.t, wv.idx], adm[wv.t, wv.idx] = o, a
    if not (np.array_equal(off, want_topo[0])
            and np.array_equal(adm, want_topo[1])):
        fail("10c mobility walk: decisions differ from fleet.simulate")
    if not (core.mu > 0).any():
        fail("10c mobility walk: no mu_k above 0; the check needs a "
             "binding capacity")
    print(f"  mobility_walk(1024, streaming, 0.2 of the capacity): == "
          f"fleet.simulate; launches "
          f"{counts or 'none (plain route)'}; tick p50 {pct(tot, 50):.3f} ms,"
          f" p99 {pct(tot, 99):.3f} ms; {T / loop_wall:.1f} waves/s; "
          f"mu_k > 0 at {int((core.mu > 0).sum())} cloudlets")
    # the soak: 200 waves under a 50 ms SLO
    soak = min(200, T)
    core = GatewayCore.for_service(st)
    core.warmup()
    (replies, stats), wall = timed_s(lambda: run_closed_loop(
        core, ServiceLoadGen(st, slab=64), slots=soak, slo_ms=50.0))
    if stats.shed_chunks or stats.fallback_waves:
        fail(f"10c soak: {stats.shed_chunks} shed, {stats.fallback_waves} "
             f"fallback waves")
    got = replay_masks(replies, waves, soak, N)
    if not (np.array_equal(got[0], want[0][:soak])
            and np.array_equal(got[1], want[1][:soak])):
        fail("10c soak: decisions differ from fleet.simulate")
    print(f"  LiveGateway soak, {soak} waves, SLO 50 ms: no shed, no "
          f"fallback, == fleet.simulate; p50 {stats.percentile(50):.3f} ms,"
          f" p99 {stats.percentile(99):.3f} ms, {soak / wall:.1f} waves/s")
    return row, k3


def gain_and_gateway(device, smi):
    """Phase 10: 10a, 10b, 10c.  Returns (kernel rows, each with the
    launches of its own run)."""
    pool, models = gain_problem()
    phase("phase 10a: gain sources at the service fleet")
    k4, k4_launches = gain_sources_phase(device, smi, pool, models)
    k4["launches"] = k4_launches
    phase("phase 10b: regret")
    regret_phase(device, smi, pool, models)
    phase("phase 10c: the live serving gateway")
    k3, k3_launches = gateway_phase(device, smi, pool, models)
    k3["launches"] = k3_launches
    return [k4, k3]


# ---------------------------------------------------------------------------
# Phase 11: the sharded engines on torch.distributed (a world of one, NCCL)


def nccl_profile(fn, T):
    """fn() under torch.profiler: (NCCL kernels recorded, their device ms
    a slot over ``T`` slots, the device ms of all kernels)."""
    prof = profiled(fn)
    nccl = [(n, ms) for key, (n, ms) in prof.items() if "nccl" in key.lower()]
    busy = sum(ms for key, (_, ms) in prof.items() if SPIN_KERNEL not in key)
    return sum(n for n, _ in nccl), sum(ms for _, ms in nccl) / T, busy


def counted_run(fn, sync_debug=True):
    """fn() with the kernel launch counts and the collective counts set to
    0 just before and read just after, the slot / slab loops under sync
    debug mode "error"; returns (fn(), wall s, peak MiB, launches,
    collectives)."""
    import torch
    from repro_torch.core import collectives, fleet
    from repro_torch.kernels import ops
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    collectives.reset_collective_counts()
    fleet.SLAB_LOOP_SYNC_DEBUG = "error" if sync_debug else None
    t = time.perf_counter()
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        fleet.SLAB_LOOP_SYNC_DEBUG = None
    wall = time.perf_counter() - t
    launches = {n: c for n, c in ops.launch_counts().items() if c}
    return (out, wall, torch.cuda.max_memory_allocated() / 2**20, launches,
            collectives.collective_counts())


def sharded_service(device, smi, pool, mesh, N=100_000, T=512, K=1024):
    """Phase 11a-b: simulate_service(engine="sharded") on phase 3's fleet,
    against the scan engine and K1; then under hotspot(4) and the
    streamed mobility_walk(K) at 0.2 of the capacity against the scan
    engine."""
    from repro_torch.core import fleet
    from repro_torch.serve.compile import compile_service, service_metrics
    from repro_torch.serve.simulator import SimConfig, simulate_service
    from repro_torch.topology import Topology
    sim = SimConfig(num_devices=N, T=T, B_n=0.06, H=0.5 * N * 441e6, seed=0)
    runs = {}
    for label, kw in (("scan", dict(engine="scan")),
                      ("K1", dict(engine="chunked", chunk=16)),
                      ("sharded", dict(engine="sharded", mesh=mesh))):
        m, wall, peak, launches, coll = counted_run(
            lambda: simulate_service(sim, pool, device=device, **kw),
            sync_debug=label == "sharded")
        runs[label] = m
        print(f"  [{smi}] 11a {label}: wall {wall:.3f} s (ends in "
              f"synchronize), {N * T / wall:.4g} devslots/s, peak "
              f"{peak:.1f} MiB, launches {launches or 'none'}, collectives "
              f"{coll}", flush=True)
        if label == "sharded" and coll != {"all_reduce": T, "all_gather": 3}:
            fail(f"11a: the sharded run issued {coll}, not {T} all-reduces "
                 f"(one a slot) and 3 all-gathers")
        if label == "K1" and not launches.get("onalgo_chunked"):
            fail("11a: the chunked run launched no K1")
    agree(runs)
    same = "equal to" if runs["sharded"] == runs["scan"] else "not equal to"
    print(f"  11a: sharded == scan == K1 at rel {REL}, abs {ABS} (sharded "
          f"{same} scan exactly); metrics {json.dumps(runs['sharded'])}; "
          f"the slot loop ran under sync debug mode 'error'")
    n_nccl, nccl_ms, busy = nccl_profile(lambda: simulate_service(
        sim, pool, engine="sharded", mesh=mesh, device=device), T)
    print(f"  11a sharded under torch.profiler: {n_nccl} NCCL kernel "
          f"records over {T} slots, {nccl_ms:.5f} ms a slot"
          + ("" if n_nccl else " (none recorded: a world of one's "
             "all-reduce may launch no kernel)")
          + f"; device time of the run {busy:.2f} ms")

    cs = compile_service(sim, pool, device=device)
    args = (*cs.simulate_args(), cs.rule)
    kw = dict(overlay=cs.overlay, enforce_slot_capacity=True, device=device)
    for name, topo in (
            ("hotspot(4)", Topology.hotspot(4, N, CHECK_H * sim.H,
                                            hot_frac=0.5, device=device)),
            (f"mobility_walk({K}, streaming)", Topology.mobility_walk(
                K, N, T, CHECK_H * sim.H, p_handover=0.02, seed=3,
                streaming=True, device=device))):
        (want, _), scan_wall, *_ = counted_run(
            lambda: fleet.simulate(*args, topology=topo, **kw),
            sync_debug=False)
        (got, fin), wall, peak, _, coll = counted_run(
            lambda: fleet.simulate_sharded(*args, mesh, topology=topo,
                                           **kw))
        if coll["all_reduce"] != T:
            fail(f"11b {name}: {coll['all_reduce']} all-reduces in {T} "
                 f"slots")
        agree({"scan": service_metrics(sim, want),
               "sharded": service_metrics(sim, got)})
        if not (fin.mu > 0).any():
            fail(f"11b {name}: no mu_k ended above 0")
        print(f"  [{smi}] 11b {name} at {CHECK_H} of the capacity: sharded "
              f"== scan at the bar; wall {wall:.3f} s (scan {scan_wall:.3f});"
              f" peak {peak:.1f} MiB; {int((fin.mu > 0).sum())} of "
              f"{fin.mu.numel()} mu_k above 0; collectives {coll}",
              flush=True)


def sharded_stream(device, smi, pool, mesh, N=FLEET_N, T=FLEET_T):
    """Phase 11c: phase 8c's point (N=10^6, T=256, slab 64) on the sharded
    stream: the full-width ``source`` run and the shard-local
    ``source_cols`` run bit for bit, their metrics against the streamed K2
    run's."""
    import torch
    from repro_torch.core import fleet
    from repro_torch.serve.compile import (compile_service_streaming,
                                           service_metrics)
    from repro_torch.serve.simulator import SimConfig, simulate_service
    sim = SimConfig(num_devices=N, T=T, algo="onalgo", B_n=0.06,
                    H=N / 4 * 2 * 441e6, seed=1)
    k2, k2_wall, *_ = counted_run(lambda: simulate_service(
        sim, pool, engine="chunked", chunk=16, block_n=256,
        materialize=False, slab=64, device=device))
    ss = compile_service_streaming(sim, pool, device=device)
    series = {}
    for label, cols in (("source", None), ("source_cols", ss.slab_cols)):
        (s, _), wall, peak, _, coll = counted_run(
            lambda: fleet.simulate_sharded_stream(
                ss.slab, T, N, ss.tables, ss.params, ss.rule, mesh, slab=64,
                enforce_slot_capacity=True, source_cols=cols, device=device))
        series[label] = s
        print(f"  [{smi}] 11c sharded stream ({label}): wall {wall:.3f} s, "
              f"{N * T / wall:.4g} devslots/s, peak {peak:.1f} MiB; "
              f"collectives {coll}", flush=True)
        if coll != {"all_reduce": T, "all_gather": -(-T // 64) + 2}:
            fail(f"11c {label}: collectives {coll}")
    for key, v in series["source"].items():
        if not torch.equal(series["source_cols"][key], v):
            fail(f"11c: the source_cols run's {key} differs from the "
                 f"full-width run's")
    m = service_metrics(sim, series["source"])
    agree({"sharded stream": m, "streamed K2": k2})
    print(f"  11c: source_cols == source bit for bit (every series); "
          f"metrics == the streamed K2 run's at the bar (K2 {k2_wall:.3f} "
          f"s); {json.dumps(m)}")


def mesh_gateway(device, smi, models, gain_pool, mesh, N=GAIN_N,
                 T=GATEWAY_T):
    """Phase 11d: GatewayCore.for_sim(mesh=...) at 10c's fleet (N=100000,
    T=256, the ridge source): decisions and final lam equal the unsharded
    core's bit for bit, K3 once a tick, two collectives a tick; the tick's
    p50 / p99 beside the unsharded core's; the pipelined loop at depth
    2."""
    import numpy as np
    import torch
    from repro_torch.core import collectives
    from repro_torch.kernels import ops
    from repro_torch.serve.compile import compile_service_streaming
    from repro_torch.serve.gateway import GatewayCore, run_pipelined_loop
    from repro_torch.workload import ServiceLoadGen
    ridge = models(device)["ridge"]
    sim = gain_sim(T=T, N=N)
    st = compile_service_streaming(sim, gain_pool, gain_source=ridge,
                                   device=device)
    waves = list(ServiceLoadGen(st, slab=64).waves())
    masks, lams, ticks = {}, {}, {}
    for label, kw in (("unsharded", {}), ("mesh", dict(mesh=mesh))):
        core = GatewayCore.for_sim(sim, gain_pool, gain_source=ridge,
                                   device=device, **kw)
        core.warmup()
        ops.reset_launch_counts()
        collectives.reset_collective_counts()
        off = np.zeros((T, N), bool)
        adm = np.zeros_like(off)
        for wv in waves:
            off[wv.t, wv.idx], adm[wv.t, wv.idx] = core.tick(
                wv.idx, wv.o, wv.h, wv.w)
        k3 = ops.launch_counts()["onalgo_duals"]
        coll = collectives.collective_counts()
        if k3 != T:
            fail(f"11d {label}: K3 launched {k3} times in {T} ticks")
        if coll != ({"all_reduce": 0, "all_gather": 0} if label ==
                    "unsharded" else {"all_reduce": T, "all_gather": T}):
            fail(f"11d {label}: collectives {coll} in {T} ticks")
        masks[label], lams[label] = (off, adm), core.state.lam.clone()
        core = GatewayCore.for_service(st, **kw)
        core.warmup()
        ticks[label] = tick_split(core, waves)
        print(f"  [{smi}] 11d {label} core: K3 {k3} launches in {T} ticks, "
              f"collectives {coll}", flush=True)
    if not (np.array_equal(masks["mesh"][0], masks["unsharded"][0])
            and np.array_equal(masks["mesh"][1], masks["unsharded"][1])
            and torch.equal(lams["mesh"], lams["unsharded"])):
        fail("11d: the mesh core's decisions or lam differ from the "
             "unsharded core's")
    pct = lambda x, q: float(np.percentile(x, q))
    for label, (d, r, tot, wall) in ticks.items():
        print(f"  11d {label} tick: p50 {pct(tot, 50):.3f} ms (dispatch "
              f"{pct(d, 50):.3f}, resolve {pct(r, 50):.3f}), p99 "
              f"{pct(tot, 99):.3f} ms; {T / wall:.1f} waves/s")
    # what the mesh adds to a tick: its two collectives' host time
    shards = collectives.shards_of(mesh, "data", device)
    load = torch.zeros((), device=device)
    offload = torch.zeros((N,), dtype=torch.bool, device=device)
    print(f"  11d a tick's collectives on the world of one, host time a "
          f"call: all_reduce of the load "
          f"{host_us(lambda: collectives.all_reduce(load, shards.group)):.1f}"
          f" us, all-gather of the ({N},) offloads "
          f"{host_us(lambda: collectives.gather_cols(offload, shards)):.1f}"
          f" us")
    # tick_async on the mesh never waits for the card either
    core = GatewayCore.for_service(st, mesh=mesh)
    core.warmup()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = [core.tick_async(w.idx, w.o, w.h, w.w) for w in waves[:16]]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for p in pending:
        core.resolve_timed(p)
    core = GatewayCore.for_service(st, mesh=mesh)
    core.warmup()
    (replies, stats), wall = timed_s(lambda: run_pipelined_loop(
        core, ServiceLoadGen(st, slab=64, prefetch=True), max_in_flight=2,
        slo_ms=1e9))
    got = replay_masks(replies, waves, T, N)
    if not (np.array_equal(got[0], masks["unsharded"][0])
            and np.array_equal(got[1], masks["unsharded"][1])):
        fail("11d pipelined depth 2 on the mesh: decisions differ")
    print(f"  11d: mesh core == unsharded core (decisions and final lam bit "
          f"for bit); tick_async: 16 dispatches under sync debug mode "
          f"'error'; pipelined depth 2 on the mesh: == unsharded, "
          f"{T / wall:.1f} waves/s, p50 {stats.percentile(50):.3f} ms, p99 "
          f"{stats.percentile(99):.3f} ms")


def sharded_engines(device, smi):
    """Phase 11: a world of one over NCCL (launch.mesh.world_of_one), its
    1-D mesh over "data"; 11a-11d; the process group destroyed at the
    end."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import collectives
    from repro_torch.launch import mesh as lmesh
    from repro_torch.serve.simulator import synthetic_pool
    if not lmesh.world_of_one(device):
        fail("phase 11: a process group already existed")
    try:
        mesh = lmesh.default_mesh("data", device)
        # the communicator's first collective, outside the timed runs
        collectives.all_reduce(torch.zeros(1, device=device),
                               mesh.get_group("data"))
        torch.cuda.synchronize()
        print(f"  world of one: backend {dist.get_backend()}, world size "
              f"{dist.get_world_size()}, mesh {mesh}")
        phase("phase 11a-b: simulate_service(engine='sharded')")
        sharded_service(device, smi, synthetic_pool(), mesh)
        phase("phase 11c: the sharded stream at N=10^6")
        sharded_stream(device, smi, synthetic_pool(), mesh)
        phase("phase 11d: the gateway on a mesh")
        gain_pool, models = gain_problem()
        mesh_gateway(device, smi, models, gain_pool, mesh)
    finally:
        dist.destroy_process_group()



# ---------------------------------------------------------------------------
# Phase 12: the model zoo (MoE, hybrid Jamba, encoder-decoder, VLM prefix)

# 12a: the card (use_kernel=True) against the CPU (the kernels' plain
# versions) on the same float32 weights, last-position logits at every
# step within the reference's own float32 bar for a model's logits (2e-4
# of max(max |logit|, 1): prefill + decode against the full forward,
# tests/test_models.py:116); greedy tokens equal.
ZOO_F32_BAR = 2e-4
# 12c: the other configurations on the card, (architecture, depth kept or
# None for the published depth): deepseek-67b's 95 layers (134.8 GB in
# bf16) and arctic-480b's 35 (953.7 GB) do not fit on one card.
ZOO_ON_CARD = (("yi-9b", None), ("command-r-35b", None),
               ("internvl2-1b", None), ("seamless-m4t-medium", None),
               ("deepseek-67b", 40), ("arctic-480b", 2))
ZOO_B, ZOO_PROMPT, ZOO_STEPS = 4, 16, 8


def zoo_inputs(cfg, B, S, gen, device):
    """Prompt tokens (B, S) and the modality input of ``cfg``'s family
    (the VLM's prefix embeddings (B, frontend_tokens, D), the enc-dec's
    source frames (B, frontend_tokens, D)), drawn from ``gen``."""
    import torch
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen, device=device,
                                     dtype=torch.int32)}
    shape = (B, cfg.frontend_tokens, cfg.d_model)
    if cfg.family == "vlm":
        batch["prefix_embeds"] = 0.02 * torch.randn(shape, generator=gen,
                                                    device=device)
    if cfg.family == "encdec":
        batch["src_embeds"] = 0.1 * torch.randn(shape, generator=gen,
                                                device=device)
    return batch


def zoo_max_len(cfg, S, steps):
    """The cache length for a prompt of S tokens (after the VLM's prefix)
    and ``steps`` decode steps: past 128 a multiple of 128, K6's block
    contract (the reference's too), which a prefix of 256 rows breaks
    otherwise."""
    need = S + steps + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    return need if need <= 128 else -(-need // 128) * 128


def zoo_greedy(api, params, batch, max_len, steps, use_kernel):
    """ModelAPI.prefill_step + ``steps`` greedy decode_steps: (tokens (B,
    steps + 1), last-position logits (B, steps + 1, V) in float32)."""
    import torch
    with torch.inference_mode():
        logits, state = api.prefill_step(params, batch, max_len,
                                         use_kernel=use_kernel)
        outs, toks = [logits[:, -1:].float()], []
        for _ in range(steps):
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            toks.append(tok)
            logits, state = api.decode_step(params, tok, state,
                                            use_kernel=use_kernel)
            outs.append(logits.float())
        toks.append(torch.argmax(logits[:, -1:], dim=-1).to(torch.int32))
    return torch.cat(toks, 1), torch.cat(outs, 1)


def zoo_route_run(api, params, batch, feed, max_len, use_kernel):
    """ModelAPI.prefill_step over ``batch``, then one decode_step a column
    of ``feed`` (the same tokens on either route): (last-position logits
    (B, steps + 1, V) in float32, each MoE call's top-k sets (B, S, K)
    sorted, in call order, the launch counts, prefill ms, decode-step
    ms)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    on_card = feed.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    routed, real_route = [], moe.route

    def recording_route(*a):
        out = real_route(*a)
        routed.append(torch.sort(out[2], dim=-1).values)
        return out

    ops.reset_launch_counts()
    moe.route = recording_route
    try:
        with torch.inference_mode():
            sync()
            t = time.perf_counter()
            logits, state = api.prefill_step(params, batch, max_len,
                                             use_kernel=use_kernel)
            sync()
            pf_ms = 1e3 * (time.perf_counter() - t)
            outs = [logits[:, -1:].float()]
            t = time.perf_counter()
            for i in range(feed.shape[1]):
                logits, state = api.decode_step(params, feed[:, i:i + 1],
                                                state, use_kernel=use_kernel)
                outs.append(logits.float())
            sync()
            dec_ms = 1e3 * (time.perf_counter() - t) / feed.shape[1]
    finally:
        moe.route = real_route
    return torch.cat(outs, 1), routed, ops.launch_counts(), pf_ms, dec_ms


def zoo_route_gap(api, params, batch, feed, max_len, warm_up=False):
    """Phase 12c's comparison (and ``scripts/zoo_bf16_bar_cpu.py``'s): the
    kernel route (use_kernel=True, after a warm-up run where asked)
    against the plain route on the same weights and tokens.  Returns a
    dict: ``got`` / ``want`` the two routes' logits, ``held`` the (row,
    step) logits to hold, ``err`` their max |diff|, ``scale``
    max(max |logit|, 1), ``flips`` the token routings that differ, ``n``
    the routings, ``kernel`` / ``plain`` each run's (counts, prefill ms,
    decode-step ms).

    An MoE layer routes by a discrete top-k: where the two routes' hidden
    states (bf16 rounding apart) straddle a near-tie, a token takes
    another expert and its row parts from then on.  Such rows are held
    only up to the step before their first flip."""
    import torch
    if warm_up:
        zoo_route_run(api, params, batch, feed, max_len, True)
    got, r_got, *kernel = zoo_route_run(api, params, batch, feed, max_len,
                                        True)
    want, r_want, *plain = zoo_route_run(api, params, batch, feed, max_len,
                                         False)
    if len(r_got) != len(r_want):
        fail(f"the kernel route made {len(r_got)} MoE calls, the plain "
             f"route {len(r_want)}")
    B, steps = feed.shape
    held = torch.ones(B, steps + 1, dtype=torch.bool, device=got.device)
    flips = 0
    per_step = len(r_got) // (steps + 1) if r_got else 0
    for c, (a, b) in enumerate(zip(r_got, r_want)):
        flips += int((a != b).any(-1).sum())
        held[(a != b).flatten(1).any(-1), c // per_step:] = False
    diff = (got - want).abs().amax(-1)
    return dict(got=got, want=want, held=held,
                err=float(diff[held].max()) if bool(held.any()) else 0.0,
                scale=max(float(want.abs().max()), 1.0), flips=flips,
                n=sum(x.shape[0] * x.shape[1] for x in r_got),
                kernel=kernel, plain=plain)


def zoo_reduced_card_matches_cpu(smi):
    """Phase 12a: every architecture of the registry at reduced() (olmoe
    in both MoE forms), weights drawn on the CPU and copied to the card:
    prefill + 4 greedy decode steps on the card with the kernels against
    the CPU's plain versions."""
    import copy
    import torch
    from repro_torch.configs import get_config, list_archs
    from repro_torch.models.api import ModelAPI
    from repro_torch.models import moe
    # the dropless case prefills 2 x 80 tokens: more than DENSE_TOKENS, so
    # its prefill takes the grouped form and its steps the dense one
    cases = [(a, None, 16) for a in list_archs()] + [
        ("olmoe_1b_7b", "dropless", 80)]
    assert 2 * 80 > moe.DENSE_TOKENS
    for arch, impl, S in cases:
        cfg = get_config(arch).reduced()
        if impl:
            cfg = dataclasses.replace(cfg, moe_impl=impl)
        api = ModelAPI(cfg)
        params, _ = api.init(torch.Generator().manual_seed(0))
        batch = zoo_inputs(cfg, 2, S, torch.Generator().manual_seed(1),
                           "cpu")
        max_len = zoo_max_len(cfg, S, 4)
        want_t, want = zoo_greedy(api, params, batch, max_len, 4, True)
        got_t, got = zoo_greedy(
            api, copy.deepcopy(params).to("cuda"),
            {k: v.to("cuda") for k, v in batch.items()}, max_len, 4, True)
        got, got_t = got.cpu(), got_t.cpu()
        syncs = ""
        if impl == "dropless":
            # the grouped prefill reads the group sizes back once a MoE
            # layer: its syncs less those of the same prefill with the
            # dense form
            card = {k: v.to("cuda") for k, v in batch.items()}
            p_card = copy.deepcopy(params).to("cuda")
            prefill = lambda: api.prefill_step(p_card, card, max_len,
                                               use_kernel=True)
            dense_tokens = moe.DENSE_TOKENS
            with torch.inference_mode():
                n = host_syncs(prefill)
                moe.DENSE_TOKENS = 2 * S
                try:
                    n_dense = host_syncs(prefill)
                finally:
                    moe.DENSE_TOKENS = dense_tokens
            moe_layers = sum(cfg.ffn_kind(i) == "moe"
                             for i in range(cfg.num_layers))
            if n - n_dense != moe_layers:
                fail(f"12a {cfg.name} (dropless): a prefill of {2 * S} "
                     f"tokens syncs {n} times grouped, {n_dense} dense; "
                     f"expected {moe_layers} more grouped")
            syncs = (f"; a prefill of {2 * S} tokens syncs {n} times in the "
                     f"grouped form, {n_dense} in the dense ({moe_layers} "
                     f"MoE layers)")
            del p_card
        err = float((got - want).abs().max())
        scale = max(float(want.abs().max()), 1.0)
        if not torch.equal(got_t, want_t):
            fail(f"12a {cfg.name}: greedy tokens differ card vs cpu "
                 f"({int((got_t != want_t).sum())} of {got_t.numel()})")
        if not bool(torch.isfinite(got).all()) or err > ZOO_F32_BAR * scale:
            fail(f"12a {cfg.name}: logits max |diff| {err:g} above "
                 f"{ZOO_F32_BAR} x {scale:g} (or non-finite)")
        print(f"  [{smi}] 12a {cfg.name}{f' ({impl})' if impl else ''}: "
              f"{cfg.family}, {cfg.num_layers} layers; {got_t.numel()} "
              f"greedy tokens equal, logits max |diff| {err:.3g} = "
              f"{err / scale:.3g} of max(|logit|, 1) (bar {ZOO_F32_BAR})"
              f"{syncs}")
    reduced_serving_matches_cpu("olmoe-1b-7b")


def zoo_on_card(arch, layers, smi):
    """Phase 12c: ``arch`` at its published widths in bf16 on the card
    (depth cut to ``layers`` where given), weights from a seed: one
    prefill of ZOO_B prompts and ZOO_STEPS decode steps on the same
    tokens through ModelAPI, once with the kernels (after a warm-up run)
    and once plain; logits within BF16_PATH_BAR; launch counts of the
    kernel run; times and peak."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.api import ModelAPI
    full = get_config(arch)
    cfg = full if layers is None else dataclasses.replace(full,
                                                          num_layers=layers)
    cut = ("published depth" if layers is None else
           f"reduced: num_layers {full.num_layers} → {layers}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    api = ModelAPI(cfg)
    params, _ = api.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t
    n_params = sum(p.numel() for p in params.parameters())
    B, S, steps = ZOO_B, ZOO_PROMPT, ZOO_STEPS
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = zoo_inputs(cfg, B, S, gen, "cuda")
    feed = torch.randint(0, cfg.vocab_size, (B, steps), generator=gen,
                         device="cuda", dtype=torch.int32)
    max_len = zoo_max_len(cfg, S, steps)

    gap = zoo_route_gap(api, params, batch, feed, max_len, warm_up=True)
    counts, pf_k, dec_k = gap["kernel"]
    _, pf_p, dec_p = gap["plain"]
    got, want, held = gap["got"], gap["want"], gap["held"]
    err, scale, flips = gap["err"], gap["scale"], gap["flips"]
    peak = torch.cuda.max_memory_allocated() / 2**20
    # at least half of the (row, step) logits must be held
    if int(held.sum()) < held.numel() / 2:
        fail(f"12c {cfg.name}: {int(held.sum())} of {held.numel()} (row, "
             f"step) logits left to hold after {flips} routing flips")
    if not bool(torch.isfinite(got).all()) or err > BF16_PATH_BAR * scale:
        fail(f"12c {cfg.name}: kernel and plain routes' logits differ by "
             f"{err:g}, above {BF16_PATH_BAR} x {scale:g} (or non-finite)")
    attn = sum(cfg.block_kind(i) == "attn" for i in range(cfg.num_layers))
    if cfg.family == "encdec":
        # encoder self-attention and the cross-attention at prefill on K5;
        # a step's self- and cross-attention on K6
        expect = {"flash_attention": cfg.enc_layers + cfg.num_layers,
                  "decode_attention": 2 * steps * cfg.num_layers}
        route = (f"cross-attention: K5 at prefill ({S} query rows against "
                 f"{cfg.frontend_tokens} memory rows, non-causal), K6 at "
                 f"a step (one row, cache_len {cfg.frontend_tokens})")
    else:
        expect = {"flash_attention": 0, "decode_attention": steps * attn}
        route = f"K6 at G={cfg.num_heads // cfg.num_kv_heads}"
    for name, n in expect.items():
        if counts[name] != n:
            fail(f"12c {cfg.name}: {name} launched {counts[name]} times, "
                 f"expected {n}")
    extra = ""
    if cfg.num_experts:
        from repro_torch.models.moe import capacity
        C = capacity(cfg, S)
        extra = (f"; MoE {cfg.num_experts} experts top-{cfg.top_k} "
                 f"({cfg.moe_impl}): {flips} token routings of "
                 f"{gap['n']} differ "
                 f"between the routes, {int(held.sum())} of {held.numel()} "
                 f"(row, step) logits held; prefill C={C}, dispatch and combine "
                 f"({B}, {S}, {cfg.num_experts}, {C}) "
                 f"{2 * B * S * cfg.num_experts * C * 2} bytes in bf16 "
                 f"(float32 slot tensor {B * S * cfg.top_k * cfg.num_experts * C * 4}"
                 f" bytes)")
    print(f"  [{smi}] 12c {cfg.name} ({cut}): d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads x "
          f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size}; {n_params} "
          f"parameters (analytic {cfg.param_count()}), drawn in "
          f"{draw_s:.2f} s; max_len {max_len}; prefill {pf_k:.3f} ms "
          f"(plain {pf_p:.3f}), decode step {dec_k:.3f} ms (plain "
          f"{dec_p:.3f}) = {B / dec_k * 1e3:.1f} tokens/s; logits max "
          f"|diff| {err:.4g} = {err / scale:.4g} of max(|logit|, 1) (bar "
          f"{BF16_PATH_BAR}); launches K5 {counts['flash_attention']} K6 "
          f"{counts['decode_attention']} ({route}); peak {peak:.1f} MiB"
          f"{extra}")
    del got, want, gap
    if cfg.num_experts:
        zoo_dropless_prefill(cfg, params, smi)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def zoo_dropless_prefill(cfg, params, smi, S=256):
    """Phase 12c, for an MoE configuration at its widths: one prefill of
    ZOO_B prompts of S tokens in the capacity form and in the dropless
    form, grouped (the routed FLOPs, a sync a MoE layer) and, forced,
    dense (every expert over every token): time, peak and host syncs of
    each; the dropless forms' last logits against each other, printed."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.api import ModelAPI
    gen = torch.Generator(device="cuda").manual_seed(2)
    batch = zoo_inputs(cfg, ZOO_B, S, gen, "cuda")
    dense_tokens, rows, out = moe.DENSE_TOKENS, [], {}
    for name, impl, dense in (("capacity", "capacity", False),
                              ("dropless grouped", "dropless", False),
                              ("dropless dense", "dropless", True)):
        api = ModelAPI(dataclasses.replace(cfg, moe_impl=impl))
        fn = lambda: api.prefill_step(params, batch, S, use_kernel=True)[0]
        moe.DENSE_TOKENS = ZOO_B * S if dense else dense_tokens
        try:
            with torch.inference_mode():
                fn()  # warm-up
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t = time.perf_counter()
                logits = fn()
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t)
                peak = (torch.cuda.max_memory_allocated() - base) / 2**20
                syncs = host_syncs(fn)
        finally:
            moe.DENSE_TOKENS = dense_tokens
        out[name] = logits[:, -1].float()
        rows.append(f"{name} {ms:.3f} ms, {peak:.1f} MiB above the weights,"
                    f" {syncs} host syncs")
        del logits
    d = float((out["dropless grouped"] - out["dropless dense"]).abs().max())
    scale = max(float(out["dropless dense"].abs().max()), 1.0)
    print(f"  [{smi}] 12c {cfg.name}: a prefill of {ZOO_B} x {S} tokens: "
          f"{'; '.join(rows)}; dropless grouped against dense: last logits "
          f"max |diff| {d:.4g} = {d / scale:.4g} of max(|logit|, 1)")


def model_zoo(smi):
    """Phase 12: the rest of the model zoo (12a reduced, card == CPU;
    12b the serving entry point at full width for olmoe-1b-7b and Jamba;
    12c ModelAPI for the six other configurations).  Returns the launch
    counts of 12b's runs."""
    import torch
    phase("phase 12a: every architecture reduced, card against cpu")
    zoo_reduced_card_matches_cpu(smi)
    phase("phase 12b: the serving entry point at full width")
    counts = {}
    for arch, layers in (("olmoe-1b-7b", None), ("jamba-v0.1-52b", 16)):
        print(f"  [{smi}]")
        _, params, c = full_width_serving(arch, layers)
        counts[arch] = c
        del params
        gc.collect()
        torch.cuda.empty_cache()
    phase("phase 12c: the other configurations through ModelAPI")
    for arch, layers in ZOO_ON_CARD:
        zoo_on_card(arch, layers, smi)
    return counts

# ---------------------------------------------------------------------------
# Phase 13: training and data


TRAIN_ARCHS = ("olmo-1b", "mamba2-370m", "olmoe-1b-7b", "jamba-v0.1-52b",
               "seamless-m4t-medium")
TRAIN_BAR = 1e-4  # card against cpu: loss rtol; gradients of max |leaf|
# Parameters after AdamW steps, as a share of the summed learning rates
# (an element moves by about lr a step): Adam divides each gradient
# element by its own RMS, so where an element's gradient is near 0 (sums
# that cancel) rounding-level differences move its update by a visible
# part of lr, and a leaf that starts at 0 (A_log, dt_bias, norm scales)
# is itself only that large, so a bar relative to max |leaf| does not
# hold (Jamba: 1.25e-3 of one).  3 steps, card against cpu, worst element
# over the summed lr (an H100 80GB HBM3 at 700 W): olmo 0.0064, mamba2
# 0.0147, olmoe 0.0173, Jamba 0.0396, seamless 0.0114.  A wrong gradient
# flips updates: about 2 lr an element a step.
TRAIN_PARAM_BAR = 0.05
# the reference's build_scenario over seeds 0-4 (local, cloud, gap),
# widened by 0.01 (tests/test_torch_synthetic.py's bands)
SCENARIO_BANDS = {"easy": ((0.9065, 0.971), (0.9625, 0.9885),
                           (0.0175, 0.056)),
                  "hard": ((0.5115, 0.6485), (0.71, 0.809),
                           (0.136, 0.1995))}


def train_batch(cfg, rng, B=2, S=32):
    """numpy inputs of a reduced training step: tokens (B, S + 1), an
    encoder-decoder's source frames (B, 16, D)."""
    import numpy as np
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S + 1)
                                    ).astype(np.int32)}
    if cfg.family == "encdec":
        batch["src_embeds"] = (0.1 * rng.standard_normal(
            (B, 16, cfg.d_model))).astype(np.float32)
    return batch


def routed_steps(step, state, batches):
    """Run ``step`` over ``batches`` recording each MoE call's top-k sets
    (sorted): (losses, CPU copies of the parameters after each step, the
    routes of each step)."""
    import torch
    from repro_torch.models import moe
    routed, real_route = [], moe.route

    def recording_route(*a):
        out = real_route(*a)
        routed[-1].append(torch.sort(out[2], dim=-1).values.cpu())
        return out

    losses, params = [], []
    moe.route = recording_route
    try:
        for batch in batches:
            routed.append([])
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            params.append({k: v.detach().cpu().clone()
                           for k, v in state.params.named_parameters()})
    finally:
        moe.route = real_route
    return losses, params, routed


def first_flip(a, b):
    """The first step whose MoE routing differs between two runs (and the
    number of top-k entries that differ there), or (len(a), 0)."""
    for i, (x, y) in enumerate(zip(a, b)):
        n = sum(int((u != v).sum()) for u, v in zip(x, y))
        if n:
            return i, n
    return len(a), 0


def first_grads(api, params, batch, dev):
    """{name: CPU copy of the gradient} of the loss at ``params``."""
    import torch
    from repro_torch.train.trainer import to_device
    leaves = dict(params.named_parameters())
    loss, _ = api.loss(params, to_device(batch, dev))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return {k: g.cpu() for k, g in zip(leaves, grads)}


def max_frac(got, want):
    """The largest |got - want| of a leaf over that leaf's max |want|."""
    return max(float((got[k] - w).abs().max())
               / max(float(w.abs().max()), 1e-30) for k, w in want.items())


def reduced_training_matches_cpu():
    """13a: three AdamW steps of each reduced family on the card and on
    the CPU from the same weights (drawn on the CPU) and tokens: the
    step-1 gradients at TRAIN_BAR, the losses at TRAIN_BAR, the params
    after the steps within TRAIN_PARAM_BAR of the summed lr.  An MoE router near a tie may
    pick another expert on the card (as in phase 12c): the steps are held up
    to the first step whose routing differs (its loss included), the
    parameters after the step before it."""
    import copy
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.api import ModelAPI
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import TrainState, make_train_step
    for arch in TRAIN_ARCHS:
        cfg = get_config(arch).reduced()
        api = ModelAPI(cfg)
        params, _ = api.init(torch.Generator().manual_seed(0))
        spec = opt.OptimizerSpec(name="adamw", lr=1e-3)
        lr_fn = opt.cosine_schedule(1e-3, 5, 100)
        runs, grads = {}, {}
        rng = np.random.default_rng(1)
        batches = [train_batch(cfg, rng) for _ in range(3)]
        for dev in ("cpu", "cuda"):
            # a copy each: the steps write the parameters in place
            state = TrainState.create(copy.deepcopy(params).to(dev), spec)
            grads[dev] = first_grads(api, state.params, batches[0], dev)
            step = make_train_step(api.loss, spec, lr_fn)
            ops.reset_launch_counts()
            runs[dev] = routed_steps(step, state, batches)
            launched = {k: v for k, v in ops.launch_counts().items() if v}
            if launched:
                fail(f"13a {arch} on {dev}: kernels launched in train "
                     f"steps: {launched}")
        (l_cpu, p_cpu, r_cpu), (l_card, p_card, r_card) = (runs["cpu"],
                                                          runs["cuda"])
        flip, n_flip = first_flip(r_card, r_cpu)
        upto = min(flip + 1, 3)
        if not np.allclose(l_card[:upto], l_cpu[:upto], rtol=TRAIN_BAR,
                           atol=0):
            fail(f"13a {arch}: losses card {l_card} cpu {l_cpu}")
        g_worst = max_frac(grads["cuda"], grads["cpu"])
        if flip and g_worst > TRAIN_BAR:
            fail(f"13a {arch}: step-1 gradients differ by {g_worst:.3g} of "
                 f"max |leaf|")
        lr_sum = sum(float(lr_fn(torch.tensor(i))) for i in range(flip))
        worst = max(float((p_card[flip - 1][k] - w).abs().max())
                    for k, w in p_cpu[flip - 1].items()) if flip else 0.0
        if worst > TRAIN_PARAM_BAR * lr_sum:
            fail(f"13a {arch}: params after step {flip} differ by "
                 f"{worst:.3g}, {worst / lr_sum:.3g} of the summed lr")
        held = (f"step-1 gradients within {g_worst:.3g} of max |leaf|, "
                f"params after step {flip} within {worst:.3g} = "
                f"{worst / lr_sum:.3g} of the summed lr {lr_sum:.3g}"
                if flip else "no step before it")
        if flip < 3:
            held += (f"; routing first differs in step {flip + 1} "
                     f"({n_flip} top-k entries)")
        print(f"  {cfg.name}: 3 AdamW steps, losses card "
              f"{[round(x, 6) for x in l_card]} cpu "
              f"{[round(x, 6) for x in l_cpu]}; {held}; 0 kernel launches")
        # the kernel route refuses parameters that need a gradient
        if arch in ("olmo-1b", "mamba2-370m"):
            batch = {k: torch.as_tensor(v, device="cuda")
                     for k, v in train_batch(cfg, np.random.default_rng(0),
                                             S=128).items()}
            p = TrainState.create(copy.deepcopy(params).to("cuda"),
                                  spec).params
            try:
                api.loss(p, batch, use_kernel=True)
            except RuntimeError as e:
                print(f"  {cfg.name}: loss with use_kernel=True under "
                      f"autograd raises: {str(e)[:90]}...")
            else:
                fail(f"13a {arch}: a kernel route took trainable params")


def train_steps_timed(arch, steps, accum=1, smi=""):
    """13b: ``steps`` steps of ``arch`` at full width (bf16, its remat,
    AdamW, launch.train's schedule) on token_stream(batch=8,
    seq_len=128): step ms (median of steps 2..), tokens/s, busy share of
    a profiled extra step, peak memory, the losses."""
    import statistics
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import LMStreamSpec, token_stream
    from repro_torch.kernels import ops
    from repro_torch.models.api import ModelAPI
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import (TrainState, make_train_step,
                                           to_device)
    cfg = get_config(arch)
    api = ModelAPI(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    params, _ = api.init(torch.Generator(device="cuda").manual_seed(0))
    spec = opt.OptimizerSpec(name=cfg.optimizer, lr=1e-3)
    state = TrainState.create(params, spec)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    init_s = time.perf_counter() - t
    step = make_train_step(api.loss, spec,
                           opt.cosine_schedule(1e-3, warmup=15, total=300),
                           accum_steps=accum)
    stream = token_stream(LMStreamSpec(vocab_size=cfg.vocab_size, batch=8,
                                       seq_len=128, seed=0))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, ms = [], []
    first = next(stream)
    batch = first
    for i in range(steps):
        if i:
            batch = next(stream)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
        losses.append(loss)
    peak = torch.cuda.max_memory_allocated() / 2**20
    launched = {k: v for k, v in ops.launch_counts().items() if v}
    if launched:
        fail(f"13b {arch}: kernels launched in train steps: {launched}")
    batch = next(stream)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        time.sleep(0.1)
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    med = statistics.median(ms[1:])
    busy = (f"device busy {dev_ms:.3f} ms = share {dev_ms / med:.3f} "
            f"of the median step ({sum(e.count for e in kern)} kernels)"
            if dev_ms > 0 else "busy share not measured (no kernels seen)")
    # the random head's logits have variance d_model * 0.02^2 over a
    # unit-RMS hidden state: the first loss sits near ln V + that / 2,
    # above ln V (scripts/train_loss_rehearsal_cpu.py); the first batch,
    # seen once, has a lower loss after the steps
    lnv = math.log(cfg.vocab_size)
    start = lnv + cfg.d_model * 0.02 ** 2 / 2
    with torch.no_grad():
        seen, _ = api.loss(state.params, to_device(first, "cuda"))
    seen = float(seen)
    if not all(np.isfinite(losses)) or abs(losses[0] - start) > 0.15 or \
            not seen < losses[0] - 0.05:
        fail(f"13b {arch}: losses {losses}, the first batch after the "
             f"steps {seen} (finite; the first within 0.15 of "
             f"{start:.3f}; the first batch 0.05 below its first loss)")
    print(f"  [{smi}]")
    print(f"  {cfg.name} full width: {n} parameters ({cfg.dtype}, remat "
          f"{cfg.remat}, {cfg.optimizer}, accum_steps {accum}; drawn and "
          f"state made in {init_s:.2f} s); 8 x 128 tokens a step: step ms "
          f"{[round(x, 3) for x in ms]}, median of steps 2-{steps} "
          f"{med:.3f} ms = {8 * 128 / med * 1e3:.1f} tokens/s; {busy}; "
          f"peak {peak:.1f} MiB; losses {[round(x, 4) for x in losses]} "
          f"(expected first {start:.3f}, ln V = {lnv:.3f}); the first "
          f"batch after the steps {seen:.4f}")
    for e in sorted(kern, key=lambda e: e.self_device_time_total,
                    reverse=True)[:4]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} "
              f"{e.key[:70]}")
    del state, params, m
    gc.collect()
    torch.cuda.empty_cache()


def launch_train_on_card(tmp):
    """13c: launch.train --reduced on the card: a run, a resumed run, a
    SIGTERM mid-run, and checkpoints across card and cpu."""
    import contextlib
    import io
    import os
    import signal
    import numpy as np
    import torch
    from repro_torch.launch import train
    from repro_torch.train import checkpoint as ckpt
    argv = ["--arch", "olmo-1b", "--reduced", "--batch", "4",
            "--seq-len", "64", "--ckpt-every", "10"]
    d_card, d_cpu, d_term = (os.path.join(tmp, x) for x in
                             ("card", "cpu", "term"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _, h1 = train.main(argv + ["--steps", "20", "--ckpt-dir", d_card])
        st2, h2 = train.main(argv + ["--steps", "40", "--ckpt-dir", d_card])
    text = out.getvalue()
    if "[trainer] resumed from step 20" not in text or \
            [h["step"] for h in h1] != [10, 20] or \
            [h["step"] for h in h2] != [30, 40] or int(st2.step) != 40:
        fail(f"13c: resume: {text}")
    print("  " + "\n  ".join(text.strip().splitlines()))
    # SIGTERM: a child process, stopped once it has logged step 10
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *argv,
         "--steps", "100000", "--ckpt-every", "100000", "--ckpt-dir",
         d_term], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines = []
    try:
        t = time.perf_counter()
        for line in proc.stdout:
            lines.append(line.rstrip())
            if line.startswith("[trainer] step 10 "):
                proc.send_signal(signal.SIGTERM)
            if time.perf_counter() - t > 300:
                break
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    saved = [ln for ln in lines if "preempted at step" in ln]
    last = ckpt.latest_step(d_term)
    if rc != 0 or not saved or last is None or \
            f"preempted at step {last};" not in saved[0]:
        fail(f"13c: SIGTERM: rc {rc}, latest {last}, output {lines[-6:]}")
    print(f"  SIGTERM after step 10: exit {rc}; {saved[0]}; latest "
          f"checkpoint step {last}")
    # card -> cpu and cpu -> card
    with contextlib.redirect_stdout(io.StringIO()):
        cpu_st, _ = train.main(argv + ["--steps", "3", "--ckpt-dir", d_cpu,
                                       "--device", "cpu"])
    on_cpu = ckpt.restore(d_card, 40, cpu_st)
    on_card = ckpt.restore(d_cpu, 3, st2)
    for label, got, want in (("card -> cpu", on_cpu, st2),
                             ("cpu -> card", on_card, cpu_st)):
        g, w = ckpt.host_leaves(got), ckpt.host_leaves(want)
        if sorted(g) != sorted(w) or any(
                not np.array_equal(g[k][0], w[k][0]) for k in w):
            fail(f"13c: checkpoint {label} differs")
    dev = next(on_card.params.parameters()).device.type
    print(f"  checkpoint card -> cpu (step 40) and cpu -> card (step 3): "
          f"{len(w)} leaves equal; restored on {dev} and cpu")


def scenario_pool_on_card(smi, T=240, N=4096):
    """13d: make_scenario on the card, its pool through the engines."""
    import torch
    from repro_torch.core.fleet import simulate, simulate_chunked
    from repro_torch.kernels import ops
    from repro_torch.serve.compile import compile_service
    from repro_torch.serve.simulator import SimConfig, make_scenario
    pools = {}
    for kind in ("easy", "hard"):
        (_, pair, _, pool), s = timed_s(lambda: make_scenario(kind, seed=0))
        got = (pair.local_acc, pair.cloud_acc,
               pair.cloud_acc - pair.local_acc)
        for v, (lo, hi), name in zip(got, SCENARIO_BANDS[kind],
                                     ("local", "cloud", "gap")):
            if not lo - 0.01 <= v <= hi + 0.01:
                fail(f"13d {kind}: {name} accuracy {v} outside "
                     f"[{lo}, {hi}] +- 0.01")
        print(f"  make_scenario({kind!r}) on the card in {s:.2f} s: local "
              f"acc {got[0]:.4f}, cloudlet {got[1]:.4f}, gap {got[2]:+.4f}")
        pools[kind] = pool
    sim = SimConfig(num_devices=N, T=T, B_n=0.06,
                    H=CHECK_H * 0.5 * N * 441e6, seed=0)
    pool = pools["hard"]
    runs = {}
    for dev in ("cuda", "cpu"):
        cs = compile_service(sim, pool, device=dev)
        args = (*cs.simulate_args(), cs.rule)
        kw = dict(overlay=cs.overlay, enforce_slot_capacity=True, device=dev)
        for eng, fn in (
                ("scan+K3", lambda: simulate(*args, use_kernel=True,
                                             collect_decisions=True, **kw)),
                ("K1", lambda: simulate_chunked(*args, chunk=16, **kw)),
                ("K2", lambda: simulate_chunked(*args, chunk=16,
                                                block_n=256, **kw))):
            ops.reset_launch_counts()
            (series, fin), wall = timed_s(fn)
            runs[dev, eng] = (series, fin, wall, {
                k: v for k, v in ops.launch_counts().items() if v})
    for eng in ("scan+K3", "K1", "K2"):
        series_agree(f"13d {eng} card vs cpu", runs["cuda", eng][0],
                     runs["cpu", eng][0])
    exact = lambda dev, eng: {k: runs[dev, eng][0][k] for k in EXACT_SERIES}
    series_agree("13d K2 vs K1", exact("cuda", "K2"), exact("cuda", "K1"))
    # the slot loop and the fused rollout sum g_pow in other orders, and
    # over long horizons their duals part (ROADMAP C9, shared with the
    # reference): count the slots where they part, on the card and cpu
    parted = {dev: (exact(dev, "K1")["offloads"].cpu()
                    != exact(dev, "scan+K3")["offloads"].cpu())
              for dev in ("cuda", "cpu")}
    if not torch.equal(parted["cuda"], parted["cpu"]):
        fail("13d: scan and K1 part in other slots on the card than on "
             "the cpu")
    for key in ("offload_mask", "admit_mask"):
        if not torch.equal(runs["cuda", "scan+K3"][0][key].cpu(),
                           runs["cpu", "scan+K3"][0][key]):
            fail(f"13d scan: {key} card != cpu")
    counts = {eng: runs["cuda", eng][3] for eng in ("scan+K3", "K1", "K2")}
    if counts["scan+K3"].get("onalgo_duals") != T or \
            counts["K1"].get("onalgo_chunked") != 1 or \
            counts["K2"].get("onalgo_tiled") != 1:
        fail(f"13d launches {counts}")
    acc = scenario_metrics(runs["cuda", "K1"][0])
    walls = ", ".join(f"{e} {runs['cuda', e][2]:.3f} s" for e in counts)
    print(f"  [{smi}]")
    slots = torch.nonzero(parted["cuda"]).flatten().tolist()
    print(f"  hard pool (S={len(pool.phi_hat)}) at N={N}, T={T}, "
          f"{CHECK_H} of the capacity: each engine on the card equals the "
          f"cpu's same engine (offloads / admits / tasks a slot; scan: the "
          f"(T, N) masks); K1 == K2; scan+K3 and K1 part in "
          f"{len(slots)} of {T} slots {slots[:8]} (C9), the same on the "
          f"card and the cpu; offload share {acc['offload_frac']:.4f}, "
          f"mu_final {acc['mu_final']:.4g}; walls {walls}; launches "
          f"{counts}")
    return {"onalgo_duals": T, "onalgo_chunked": 1, "onalgo_tiled": 1}


def seq_head_on_card(smi):
    """13e: default_sources(with_seq=True) on the card."""
    from repro_torch.gain import default_sources, scenario_regret
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    (sources, pool), s = timed_s(lambda: default_sources(
        S=512, with_seq=True, device="cuda"))
    trained = ops.launch_counts()["ssd_chunk"]
    if trained != 1:
        fail(f"13e: K4 launched {trained} times in training (expected 1: "
             "the sigma pass; the training steps take the plain route)")
    ops.reset_launch_counts()
    rows, wall = timed_s(lambda: scenario_regret(
        sources, pool, scenario="stationary", max_T=600, engine="scan",
        device="cuda"))
    k4 = ops.launch_counts()["ssd_chunk"]
    if k4 < 1:
        fail("13e: K4 never launched in the seq head's resolution")
    print(f"  [{smi}]")
    print(f"  default_sources(with_seq=True): trained in {s:.2f} s (60 "
          f"AdamW steps, K4 once: the sigma pass); scenario_regret "
          f"stationary max_T=600 on the scan engine in {wall:.2f} s, K4 "
          f"{k4} (the seq head's resolution): " + "; ".join(
              f"{k} acc {r['accuracy']:.4f} regret {r['regret']:+.4f}"
              for k, r in rows.items()))
    return k4


def training_and_data(smi):
    """Phase 13: 13a-13e.  Returns 13d's and 13e's launch counts."""
    import tempfile
    phase("phase 13a: reduced training, card against cpu")
    reduced_training_matches_cpu()
    phase("phase 13b: full-width training steps")
    train_steps_timed("olmo-1b", 6, smi=smi)
    train_steps_timed("olmo-1b", 6, accum=2, smi=smi)
    train_steps_timed("mamba2-370m", 4, smi=smi)
    phase("phase 13c: launch.train on the card")
    with tempfile.TemporaryDirectory() as tmp:
        launch_train_on_card(tmp)
    phase("phase 13d: make_scenario's pool on the card")
    counts = scenario_pool_on_card(smi)
    phase("phase 13e: the trained SSD gain head")
    counts["ssd_chunk"] = seq_head_on_card(smi)
    return counts


# ---------------------------------------------------------------------------
# Phase 14: the dry run, the sharding rules and the roofline

# 14a: the cells traced on a fake 16x16 cuda mesh, one process each
# (the fake world cannot live beside this process's real one);
# yi-9b x long_500k must come out skipped (full attention); mamba2-370m x
# train_4k sums its tied table's two gradients, which its 50280 rows leave
# whole over the model axis (layers.lm_head)
DRYRUN_CELLS = (("olmo-1b", "train_4k"), ("olmo-1b", "prefill_32k"),
                ("olmo-1b", "decode_32k"), ("mamba2-370m", "long_500k"),
                ("mamba2-370m", "train_4k"), ("olmoe-1b-7b", "decode_32k"),
                ("yi-9b", "long_500k"))
DRYRUN_TIMEOUT_S = 120
# 14b: the predicted peak (the record's arguments + temporaries) within
# this share of torch.cuda.max_memory_allocated.  The trace sees every
# op's results and when each dies; it cannot see what one op takes inside
# its own kernels (a composite op's scratch, cuBLAS workspaces) or the
# caching allocator's rounding (at most 511 B a block).
PEAK_BAR = 0.05
PHASE14_LIMIT_S = 150.0


def dryrun_start(tmp):
    """14a: one ``python -m repro_torch.launch.dryrun`` process a cell,
    started together, writing records to ``tmp``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for arch, shape in DRYRUN_CELLS:
        log = open(Path(tmp) / f"{arch}_{shape}.log", "w+")
        procs.append((arch, shape, log, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--device", "cuda", "--out", tmp],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT)))
    return procs


def fmt_bytes(n):
    return f"{n / 1e9:.3f} GB"


def dryrun_finish(procs, tmp, started, smi):
    """14a: wait for the cells, print each record against the card's HBM
    and the roofline table; fail on an error, on yi-9b x long_500k not
    skipped, on an olmoe cell without all-to-alls."""
    from repro_torch.analysis import roofline
    from repro_torch.launch.dryrun import HW
    try:
        for _, _, _, p in procs:
            p.wait(timeout=max(1.0, started + DRYRUN_TIMEOUT_S
                               - time.perf_counter()))
    except subprocess.TimeoutExpired:
        fail(f"14a: a dry-run cell ran past {DRYRUN_TIMEOUT_S} s")
    finally:
        for _, _, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.seek(0)
            p.text = log.read()
            log.close()
    cells = []
    print(f"  [{smi}]; HW: {HW}")
    for arch, shape, _, p in procs:
        path = Path(tmp) / f"{arch}_{shape}_single.json".replace("-", "_")
        if p.returncode != 0 or not path.exists():
            fail(f"14a {arch} x {shape}: exit {p.returncode}\n"
                 f"{p.text[-3000:]}")
        rec = json.loads(path.read_text())
        cells.append(rec)
        if rec["status"] == "skipped":
            print(f"  {arch} x {shape}: skipped ({rec['reason']})")
            continue
        r = rec["roofline"]
        arg, temp = rec["argument_size_in_bytes"], rec["temp_size_in_bytes"]
        cols = {k: (v["count"], fmt_bytes(v["bytes"]))
                for k, v in rec["collectives"].items()
                if k != "total_wire_bytes"}
        print(f"  {arch} x {shape} ({rec['mesh']}, {rec['n_chips']} fake "
              f"ranks): {rec['status']}, traced in {rec['compile_s']} s; "
              f"per chip arguments {fmt_bytes(arg)} + temporaries "
              f"{fmt_bytes(temp)} = {(arg + temp) / HW['hbm_bytes']:.3f} of "
              f"HW hbm_bytes; flops {rec['flops']:.4e}, bytes accessed "
              f"{rec['bytes_accessed']:.4e}; roofline compute "
              f"{r['compute_s'] * 1e3:.3f} ms, memory "
              f"{r['memory_s'] * 1e3:.3f} ms, collective "
              f"{r['collective_s'] * 1e3:.3f} ms -> {r['dominant']}; "
              f"collectives (count, bytes) {cols}, wire "
              f"{fmt_bytes(rec['collectives']['total_wire_bytes'])}")
    print(roofline.markdown_table(cells))
    status = {(c["arch"], c["shape"]): c["status"] for c in cells}
    bad = {k: v for k, v in status.items()
           if v != ("skipped" if k == ("yi-9b", "long_500k") else "ok")}
    if bad:
        fail(f"14a: cells {bad} (every cell ok, yi-9b x long_500k skipped)")
    moe = next(c for c in cells if c["arch"] == "olmoe-1b-7b")
    if moe["collectives"].get("all-to-all", {}).get("count", 0) < 1:
        fail(f"14a: the olmoe cell shows no all-to-all: "
             f"{moe['collectives']}")


def roofline_records(mesh):
    """14b: the dry run's records of olmo-1b at the three single-card
    shapes, traced on ``mesh`` (1, 1)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    recs = {}
    for shape in (ShapeConfig("train_8x128", 128, 8, "train"),
                  ShapeConfig("prefill_4x2048", 2048, 4, "prefill"),
                  ShapeConfig("decode_16x2048", 2048, 16, "decode")):
        rec = dryrun.run_cell("olmo-1b", shape, mesh=mesh, verbose=False)
        if rec["status"] != "ok":
            fail(f"14b: the record of olmo-1b x {shape.name} on (1, 1): "
                 f"{rec.get('error')}\n{rec.get('traceback', '')}")
        recs[shape.mode] = rec
    return recs


def timed_calls(call, reps):
    """Host ms of each of ``reps`` calls, each ended by a synchronize."""
    import torch
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        call()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
    return ms


def roofline_on_card(recs, smi):
    """14b: olmo-1b at full width on one card, each step against its
    record: the record's flops == FlopCounterMode's count of the real
    step, argument bytes == the real arguments', the predicted peak within
    PEAK_BAR of max_memory_allocated, the roofline's largest term no
    larger than the measured step; the kernel route's time and launches
    beside it."""
    import statistics
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.analysis.hlo_stats import CostTrace, cost_summary
    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import LMStreamSpec, token_stream
    from repro_torch.kernels import ops
    from repro_torch.models import lm as LM
    from repro_torch.models.api import ModelAPI
    from repro_torch.parallel.compile_mode import compile_options
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import TrainState, make_train_step
    cfg = get_config("olmo-1b")
    api = ModelAPI(cfg)
    dev = torch.device("cuda")
    print(f"  [{smi}]")
    for mode, rec in recs.items():
        gc.collect()
        torch.cuda.empty_cache()
        gen = torch.Generator(device=dev).manual_seed(0)
        params, _ = api.init(gen)
        B, S = (8, 128) if mode == "train" else (4, 2048) \
            if mode == "prefill" else (16, 2048)
        if mode == "train":
            spec = opt.OptimizerSpec(name=cfg.optimizer)
            state = TrainState.create(params, spec)
            step = make_train_step(api.loss, spec,
                                   opt.cosine_schedule(3e-4, 100, 10000))
            tokens = next(token_stream(LMStreamSpec(
                vocab_size=cfg.vocab_size, batch=B, seq_len=S,
                seed=0)))["tokens"]
            batch = {"tokens": torch.from_numpy(tokens).to(dev)}
            args = (state, batch)
            call = lambda uk=False: step(state, batch)
            reps = 4
        elif mode == "prefill":
            batch = {"tokens": torch.randint(
                0, cfg.vocab_size, (B, S), generator=gen, device=dev,
                dtype=torch.int32)}
            args = (params, batch)
            call = lambda uk=False: api.prefill_step(params, batch, S,
                                                     use_kernel=uk)
            reps = 4
        else:
            token = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                                  device=dev, dtype=torch.int32)
            dstate = {"cache": LM.init_cache(cfg, B, S, device=dev),
                      "length": S - 1}
            args = (params, token, dstate)
            call = lambda uk=False: api.decode_step(params, token, dstate,
                                                    use_kernel=uk)
            reps = 10
        arg_bytes = cost_summary(CostTrace(), args, ())[
            "argument_size_in_bytes"]
        grad = torch.enable_grad() if mode == "train" else torch.no_grad()
        with grad, compile_options(flash_block=2048):
            call()  # warm: cuBLAS handles and workspaces
            with FlopCounterMode(display=False) as fc:
                call()
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            call()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            ms = timed_calls(call, reps)
            kernel = ""
            if mode != "train":
                name = "flash_attention" if mode == "prefill" \
                    else "decode_attention"
                call(True)
                ops.reset_launch_counts()
                call(True)
                torch.cuda.synchronize()
                n = ops.launch_counts()[name]
                kms = statistics.median(timed_calls(lambda: call(True), reps))
                kernel = (f"; kernel route {kms:.3f} ms, {name} {n} "
                          f"launches a step")
                if n != cfg.num_layers:
                    fail(f"14b {mode}: {name} launched {n} times a step "
                         f"(expected {cfg.num_layers}, one a layer)")
        flops = fc.get_total_flops()
        pred = rec["argument_size_in_bytes"] + rec["temp_size_in_bytes"]
        med = statistics.median(ms)
        r = rec["roofline"]
        top = max(r["compute_s"], r["memory_s"], r["collective_s"]) * 1e3
        print(f"  olmo-1b {rec['shape']} ({B} x {S}) on (1, 1): flops "
              f"record {rec['flops']:.6e} / FlopCounterMode {flops:.6e}; "
              f"argument bytes record {rec['argument_size_in_bytes']} / "
              f"real {arg_bytes}; peak predicted {fmt_bytes(pred)} "
              f"(arguments + temporaries {fmt_bytes(rec['temp_size_in_bytes'])})"
              f" / max_memory_allocated {fmt_bytes(peak)} "
              f"({(pred - peak) / peak:+.4f}; before the step "
              f"{fmt_bytes(base)}, {fmt_bytes(base - arg_bytes)} beside the "
              f"arguments); roofline compute {r['compute_s'] * 1e3:.3f} ms, "
              f"memory {r['memory_s'] * 1e3:.3f} ms -> largest {top:.3f} ms; "
              f"measured {med:.3f} ms (median of {[round(x, 3) for x in ms]})"
              f" = {top / med:.4f} of the roofline bound{kernel}")
        if rec["flops"] != flops:
            fail(f"14b {mode}: the record's flops {rec['flops']} != "
                 f"FlopCounterMode's {flops}")
        if rec["argument_size_in_bytes"] != arg_bytes:
            fail(f"14b {mode}: argument bytes {rec['argument_size_in_bytes']}"
                 f" != the real {arg_bytes}")
        if abs(pred - peak) > PEAK_BAR * peak:
            fail(f"14b {mode}: predicted peak {pred} not within {PEAK_BAR} "
                 f"of max_memory_allocated {peak}")
        if top > med:
            fail(f"14b {mode}: the roofline's largest term {top:.3f} ms "
                 f"exceeds the measured step {med:.3f} ms")
        del params, args
        if mode == "train":
            del state, step
    gc.collect()
    torch.cuda.empty_cache()


def pipeline_on_card(mesh):
    """14c: pipeline_apply over a world of one (S = 1, 8 microbatches)
    equals the stage function applied in sequence."""
    import torch
    from repro_torch.parallel.pipeline import bubble_fraction, pipeline_apply
    gen = torch.Generator(device="cuda").manual_seed(3)
    Ws = torch.randn((1, 256, 256), generator=gen, device="cuda") * 0.05
    xs = torch.randn((8, 64, 256), generator=gen, device="cuda")
    stage = lambda w, h: torch.relu(h @ w)
    got = pipeline_apply(stage, Ws, xs, mesh, axis="pod")
    want = torch.stack([stage(Ws[0], x) for x in xs])
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"14c: pipeline_apply != the stages in sequence "
             f"(max |d| {(got - want).abs().max().item()})")
    print(f"  pipeline_apply on a (1,) pod mesh over NCCL: 8 microbatches x "
          f"(64, 256), S = 1: equal to the stage in sequence, bit for bit; "
          f"bubble fraction {bubble_fraction(8, 1)}")


def dry_run_phase(smi):
    """Phase 14: 14a's cells start in their own processes, 14b's records
    are traced here meanwhile; then 14a's records, 14b's real steps, 14c.
    HW's HBM size is held against the card's."""
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch.dryrun import HW
    t0 = time.perf_counter()
    total = torch.cuda.get_device_properties(0).total_memory
    if not HW["hbm_bytes"] <= total <= 1.1 * HW["hbm_bytes"]:
        fail(f"14: HW hbm_bytes {HW['hbm_bytes']} against the card's "
             f"{total} bytes")
    print(f"  HW hbm_bytes {HW['hbm_bytes']:.4e} <= the card's "
          f"total_memory {total} (within 10%)")
    with tempfile.TemporaryDirectory() as tmp:
        procs = dryrun_start(tmp)
        try:
            if not lmesh.world_of_one("cuda"):
                fail("phase 14: a process group already existed")
            try:
                mesh = lmesh.make_test_mesh((1, 1), device="cuda")
                recs = roofline_records(mesh)
                phase("phase 14a: the cells on a fake 16x16 mesh")
                dryrun_finish(procs, tmp, t0, smi)
                phase("phase 14b: the roofline against the card")
                roofline_on_card(recs, smi)
                phase("phase 14c: pipeline_apply over a world of one")
                pipeline_on_card(lmesh.make_test_mesh((1,), ("pod",),
                                                      device="cuda"))
            finally:
                dist.destroy_process_group()
        finally:
            for _, _, _, p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    took = time.perf_counter() - t0
    print(f"  phase 14 took {took:.1f} s")
    if took > PHASE14_LIMIT_S:
        fail(f"phase 14 took {took:.1f} s (limit {PHASE14_LIMIT_S} s)")


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 is float32
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.serve.compile import compile_service
    from repro_torch.serve.simulator import SimConfig, synthetic_pool

    phase("phase 0: card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    import torch.distributed as dist
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}; torch.distributed nccl "
          f"available: {dist.is_nccl_available()}")

    phase("phase 1: build")
    t = time.perf_counter()
    libs = build.build_all(LIBRARIES)
    print(f"  built {', '.join(str(p.relative_to(ROOT)) for p in libs.values())}"
          f" in {time.perf_counter() - t:.1f} s")
    for name in libs:
        print(build.PTXAS_LOG.get(name, f"  ({name}: library already built)"))
    onalgo_build_clean()
    ssd_build_clean()
    threefry_slots = draws_build_clean()

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
    reduced_serving_matches_cpu("olmo-1b")
    cfg, params, counts = full_width_serving("olmo-1b")
    launches["decode_attention"] = counts["decode_attention"]
    launches["flash_attention"] = full_width_forward(
        cfg, params)["flash_attention"]
    del params

    phase("phase 6: the multi-cloudlet topology tier")
    topo_rows, topo_launches = topology_tier(pool, device)
    kernels += topo_rows
    launches.update(topo_launches)

    phase("phase 7: the Mamba2 path (mamba2-370m)")
    kernels.append(check_ssd_kernel())
    reduced_serving_matches_cpu("mamba2-370m")
    cfg, params, counts = full_width_serving("mamba2-370m")
    launches["ssd_chunk"] = counts["ssd_chunk"]
    full_width_forward(cfg, params)
    del params

    phase("phase 8: the streaming engine")
    row, counts = streaming_engine(pool, device, threefry_slots)
    kernels.append(row)
    launches["draws"] = counts["draws"]

    phase("phase 9: the scenario engine and the sweeps")
    rows, counts = scenario_engine(device)
    kernels += rows
    launches.update(counts)

    kernels += gain_and_gateway(device, smi)

    phase("phase 11: the sharded engines (a world of one, NCCL)")
    sharded_engines(device, smi)

    phase("phase 12: the model zoo")
    model_zoo(smi)

    phase("phase 13: training and data")
    training_and_data(smi)

    phase("phase 14: the dry run, the sharding rules and the roofline")
    dry_run_phase(smi)

    line = {"kernels": [dict(
        name=r["name"], route="cuda", source=SOURCES[r["name"]],
        replaces=REPLACES[r["name"]],
        launches=r.get("launches", launches[r["name"]]),
        max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
        library_ms=r.get("library_ms")) for r in kernels]}
    phase("phase 15: kernels line, then the ok line")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
