"""The port's sharded engines on torch.distributed against the JAX
package's, on the CPU.

One world of four gloo ranks (a ``FileStore`` in a temporary directory:
no TCP rendezvous) runs every case of the port: each rank, one process,
calls the same entry points with the same global inputs and writes what
it got.  One JAX subprocess with four forced host devices (as
tests/test_distributed.py) computes the reference's sharded runs on the
same inputs, at the same time.  The tests then hold:

- every rank's result to rank 0's, bit for bit (the replicated outputs of
  an SPMD run);
- rank 0's to the reference's ``simulate_sharded`` on a (2, 2) mesh (the
  data axis a sub-group of two) and on a (4,) mesh, with an overlay and
  under a 4-cloudlet mobility walk, the sequential
  ``simulate_sharded_stream``, ``GatewayCore(mesh=...)``'s tick and its
  pipelined loop at depth 2, a shard_map'd ``ext_step(axis_name=...)``
  and ``simulate_service(engine="sharded")``: offloads, admits, tasks and
  visit counts exactly, lam, mu, mu_k and lam_norm (and the other
  series) at rtol=1e-5, atol=1e-6, service metrics at 2e-5 / 1e-5;
- the port's sharded runs to the port's scan engine at the reference's
  own bar (rtol=1e-4, atol=1e-5);
- the shard-local ``source_cols`` stream to the full-width ``source``
  stream bit for bit (the reference's shard-local stream is red, ROADMAP
  C1, so the port's full-width run is its oracle);
- ``parallel.pipeline_apply`` (a (4,) "pod" mesh, one stage a rank) to
  the reference's and to the stages applied in sequence (rtol=1e-4,
  atol=1e-5);
- that ``_validate_shards`` and a mesh on another device type raise.

Run as a script (``--worker``), this file is one rank of the world.
"""

import inspect
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
RTOL, ATOL = 1e-5, 1e-6  # duals: the reference's kernel-vs-oracle bar
SCAN_RTOL, SCAN_ATOL = 1e-4, 1e-5  # tests/test_distributed.py's bar
REL, ABS = 2e-5, 1e-5  # service metrics, tests/test_serve.py's bar
EXACT = ("offloads", "admits", "tasks")
TIMEOUT = 240

# The cases' sizes (tests/test_distributed.py's)
PLAIN = dict(N=16, T=200, seed=2)
OVERLAY = dict(N=16, T=150, seed=4)
GATEWAY = dict(num_devices=32, T=96, seed=4)
SERVICE = dict(num_devices=16, T=150, B_n=0.06, H=4 * 441e6, seed=4)
EXT = dict(N=16, T=120, seed=5)


def pipeline_inputs():
    """(stage weights (4, 16, 16), microbatches (8, 4, 16)), float32 from a
    seed: tests/test_distributed.py's toy four-stage MLP."""
    rng = np.random.default_rng(11)
    return (rng.normal(0.0, 0.3, (4, 16, 16)).astype(np.float32),
            rng.normal(0.0, 1.0, (8, 4, 16)).astype(np.float32))


def compression_inputs():
    """(grads w (4, 16), grads b (4, 8), residuals of each), one row a
    rank, float32 from a seed."""
    rng = np.random.default_rng(9)
    return tuple(rng.normal(0, s, shape).astype(np.float32) for s, shape in
                 ((2.0, (4, 16)), (0.5, (4, 8)), (0.01, (4, 16)),
                  (0.01, (4, 8))))

REFERENCE = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from functools import partial
from jax.sharding import PartitionSpec as P
from repro.core import (OnAlgoParams, StepRule, default_paper_space,
                        simulate_sharded, simulate_sharded_stream)
from repro.core import extensions as ext
from repro.core.fleet import RawOverlay
from repro.core.onalgo import OnAlgoState
from repro.core.state_space import RhoEstimator
from repro.data.traces import TraceSpec, iid_trace
from repro.launch.mesh import make_test_mesh
from repro.parallel.compat import shard_map
from repro.serve.compile import compile_service_streaming
from repro.serve.gateway import GatewayCore, run_pipelined_loop
from repro.serve.simulator import SimConfig, simulate_service, synthetic_pool
from repro.topology import Topology

cfg = json.loads(sys.argv[1])
out = {}
assert jax.device_count() == 4

def keep(case, series, fin):
    for k, v in series.items():
        out[f"{case}/{k}"] = np.asarray(v)
    out[f"{case}/lam"] = np.asarray(fin.lam)
    out[f"{case}/mu"] = np.asarray(fin.mu)
    out[f"{case}/counts"] = np.asarray(fin.rho.counts)

space = default_paper_space(num_w=4)
tables = space.tables()
rule = StepRule.inv_sqrt(0.5)
mesh22 = make_test_mesh((2, 2), ("data", "model"))
mesh4 = make_test_mesh((4,), ("data",))

c = cfg["plain"]
N, T = c["N"], c["T"]
trace, _ = iid_trace(space, TraceSpec(T=T, N=N, seed=c["seed"]))
out["inputs/plain"] = np.asarray(trace.j_idx)
params = OnAlgoParams(B=jnp.full((N,), 0.08), H=jnp.float32(7e8))
keep("plain22", *simulate_sharded(trace, tables, params, rule, mesh22,
                                  device_axis="data"))
keep("plain4", *simulate_sharded(trace, tables, params, rule, mesh4))

c = cfg["overlay"]
N, T = c["N"], c["T"]
trace, _ = iid_trace(space, TraceSpec(T=T, N=N, seed=c["seed"]))
out["inputs/overlay"] = np.asarray(trace.j_idx)
params = OnAlgoParams(B=jnp.full((N,), 0.08), H=jnp.float32(7e8))
rng = np.random.default_rng(1)
ov = RawOverlay(
    o=jnp.asarray(rng.uniform(0.05, 0.12, (T, N)), jnp.float32),
    h=jnp.asarray(rng.uniform(3e8, 6e8, (T, N)), jnp.float32),
    w=jnp.asarray(rng.uniform(0.0, 0.3, (T, N)), jnp.float32),
    correct_local=jnp.asarray(rng.random((T, N)) < 0.6, jnp.float32),
    correct_cloud=jnp.asarray(rng.random((T, N)) < 0.85, jnp.float32))
keep("overlay", *simulate_sharded(trace, tables, params, rule, mesh4,
                                  overlay=ov, enforce_slot_capacity=True))
topo = Topology.mobility_walk(4, N, T, H=params.H, p_handover=0.1, seed=2)
out["inputs/assoc"] = np.asarray(topo.assoc)
keep("topo", *simulate_sharded(trace, tables, params, rule, mesh4,
                               topology=topo, enforce_slot_capacity=True))
trace2, _ = iid_trace(space, TraceSpec(T=T, N=N, seed=2))
keep("stream", *simulate_sharded_stream(
    lambda t0, L: (trace2.j_idx[t0:t0 + L], None), T, N, tables, params,
    rule, mesh4, slab=64))

pool = synthetic_pool()
ss = compile_service_streaming(SimConfig(**cfg["gateway"]), pool)
waves = np.load(cfg["waves"])

class Wave:
    def __init__(self, t):
        self.t = t
        self.idx, self.o, self.h, self.w = (waves[f"{k}{t}"]
                                            for k in "idx o h w".split())

class Waves:
    def waves(self, t0=0, slots=None):
        for t in range(t0, t0 + slots):
            yield Wave(t)

T, N = cfg["gateway"]["T"], cfg["gateway"]["num_devices"]
for case in ("gw", "pipe"):
    core = GatewayCore.for_service(ss, mesh=mesh4)
    off = np.zeros((T, N), bool)
    adm = np.zeros((T, N), bool)
    if case == "gw":
        for wv in Waves().waves(0, T):
            off[wv.t, wv.idx], adm[wv.t, wv.idx] = core.tick(
                wv.idx, wv.o, wv.h, wv.w)
    else:
        core.warmup()
        replies, stats = run_pipelined_loop(core, Waves(), 0, T,
                                            max_in_flight=2,
                                            slo_ms=60_000.0)
        assert stats.waves == T and stats.fallback_waves == 0
        for t, r in enumerate(replies):
            idx = waves[f"idx{t}"]
            off[t, idx], adm[t, idx] = r.offload, r.admitted
    out[f"{case}/off"], out[f"{case}/adm"] = off, adm
    out[f"{case}/lam"] = np.asarray(core.state.lam)
    out[f"{case}/mu"] = np.asarray(core.state.mu)

c = cfg["ext"]
N, T = c["N"], c["T"]
trace, _ = iid_trace(space, TraceSpec(T=T, N=N, seed=c["seed"]))
out["inputs/ext"] = np.asarray(trace.j_idx)
M = space.M
params = OnAlgoParams(B=jnp.full((N,), 0.08), H=jnp.float32(8e8))
delay = ext.DelayModel(d_tr=jnp.full((M,), 0.05, jnp.float32),
                       d_pr_cloud=jnp.full((M,), 0.05, jnp.float32))
ro, rh, rw = tables

@partial(shard_map, mesh=mesh4,
         in_specs=(P(None, "data"), P("data"), P("data", None), P("data"),
                   P()),
         out_specs=(P(None, "data"), P(), P(), P("data")), check_vma=False)
def ext_run(j_seq, lam0, counts0, B, H):
    st = ext.ExtState(base=OnAlgoState(
        lam=lam0, mu=jnp.float32(0.0),
        rho=RhoEstimator(counts=counts0, t=jnp.int32(0))),
        nu=jnp.float32(0.0))
    p = OnAlgoParams(B=B, H=H)

    def slot(st, j):
        st, off, _ = ext.ext_step(st, j, ro[j], rh[j], rw[j], j > 0, tables,
                                  p, rule, zeta=1.0, delay=delay,
                                  l_tab=jnp.ones((M,), jnp.float32), W=0.5,
                                  axis_name="data")
        return st, (off, st.base.mu, st.nu)

    st, (off, mu, nu) = jax.lax.scan(slot, st, j_seq)
    return off, mu, nu, st.base.lam

off, mu, nu, lam = ext_run(trace.j_idx, jnp.zeros((N,), jnp.float32),
                           jnp.zeros((N, M), jnp.float32), params.B,
                           params.H)
out["ext/off"], out["ext/mu"] = np.asarray(off), np.asarray(mu)
out["ext/nu"], out["ext/lam"] = np.asarray(nu), np.asarray(lam)

from repro.train.compression import compressed_psum
g_w, g_b, r_w, r_b = compression_inputs()

@partial(shard_map, mesh=mesh4, in_specs=(P("data"),) * 4,
         out_specs=(P("data"),) * 4, check_vma=False)
def cpsum(gw, gb, rw, rb):
    mean, res = compressed_psum(
        {"w": gw[0], "b": gb[0].astype(jnp.bfloat16)},
        {"w": rw[0], "b": rb[0]}, "data")
    return (mean["w"][None], mean["b"].astype(jnp.float32)[None],
            res["w"][None], res["b"][None])

for k, v in zip(("mean_w", "mean_b", "res_w", "res_b"),
                cpsum(g_w, g_b, r_w, r_b)):
    out[f"cpsum/{k}"] = np.asarray(v)

from repro.parallel.pipeline import pipeline_apply
Ws, xs = pipeline_inputs()
out["gpipe/out"] = np.asarray(pipeline_apply(
    lambda w, h: jax.nn.relu(h @ w), jnp.asarray(Ws), jnp.asarray(xs),
    make_test_mesh((4,), ("pod",)), axis="pod"))

sim = SimConfig(**cfg["service"])
for k, v in simulate_service(sim, pool, engine="sharded").items():
    out[f"svc/{k}"] = np.float64(v)
np.savez(cfg["out"], **out)
print("OK")
"""


def _worker(rank: int, store_path: str, out_path: str):
    """One rank of the gloo world: run every case, write rank-local
    results to ``out_path``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core import (OnAlgoParams, RawOverlay, StepRule, Trace,
                                  default_paper_space, extensions, simulate,
                                  simulate_sharded, simulate_sharded_stream)
    from repro_torch.core.collectives import (collective_counts, gather_cols,
                                              reset_collective_counts,
                                              shards_of)
    from repro_torch.data.traces import TraceSpec, iid_trace
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    from repro_torch.serve.compile import compile_service_streaming
    from repro_torch.serve.gateway import GatewayCore, run_pipelined_loop
    from repro_torch.serve.simulator import (SimConfig, simulate_service,
                                             synthetic_pool)
    from repro_torch.topology import Topology
    from repro_torch.workload import ServiceLoadGen

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    cpu = "cpu"
    out, counts = {}, {}

    def keep(case, series, fin):
        for k, v in series.items():
            out[f"{case}/{k}"] = v.numpy()
        out[f"{case}/lam"] = fin.lam.numpy()
        out[f"{case}/mu"] = fin.mu.numpy()
        out[f"{case}/counts"] = fin.rho.counts.numpy()

    def counted(case, fn):
        reset_collective_counts()
        keep(case, *fn())
        counts[case] = collective_counts()

    space = default_paper_space(num_w=4)
    tables = space.tables(cpu)
    rule = StepRule.inv_sqrt(0.5)
    mesh22 = make_test_mesh((2, 2), ("data", "model"), device=cpu)
    mesh4 = make_test_mesh((4,), ("data",), device=cpu)

    N, T = PLAIN["N"], PLAIN["T"]
    trace, _ = iid_trace(space, TraceSpec(T=T, N=N, seed=PLAIN["seed"]),
                         device=cpu)
    out["inputs/plain"] = trace.j_idx.numpy()
    params = OnAlgoParams(B=torch.full((N,), 0.08), H=torch.tensor(7e8))
    counted("plain22", lambda: simulate_sharded(
        trace, tables, params, rule, mesh22, device_axis="data",
        device=cpu))
    counted("plain4", lambda: simulate_sharded(trace, tables, params, rule,
                                               mesh4, device=cpu))
    keep("plain_scan", *simulate(trace, tables, params, rule, device=cpu))

    N, T = OVERLAY["N"], OVERLAY["T"]
    trace, _ = iid_trace(space, TraceSpec(T=T, N=N, seed=OVERLAY["seed"]),
                         device=cpu)
    out["inputs/overlay"] = trace.j_idx.numpy()
    params = OnAlgoParams(B=torch.full((N,), 0.08), H=torch.tensor(7e8))
    rng = np.random.default_rng(1)
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    ov = RawOverlay(o=f32(rng.uniform(0.05, 0.12, (T, N))),
                    h=f32(rng.uniform(3e8, 6e8, (T, N))),
                    w=f32(rng.uniform(0.0, 0.3, (T, N))),
                    correct_local=f32(rng.random((T, N)) < 0.6),
                    correct_cloud=f32(rng.random((T, N)) < 0.85))
    counted("overlay", lambda: simulate_sharded(
        trace, tables, params, rule, mesh4, overlay=ov,
        enforce_slot_capacity=True, device=cpu))
    keep("overlay_scan", *simulate(trace, tables, params, rule, overlay=ov,
                                   enforce_slot_capacity=True, device=cpu))
    topo = Topology.mobility_walk(4, N, T, H=params.H, p_handover=0.1,
                                  seed=2, device=cpu)
    out["inputs/assoc"] = topo.assoc.numpy()
    counted("topo", lambda: simulate_sharded(
        trace, tables, params, rule, mesh4, topology=topo,
        enforce_slot_capacity=True, device=cpu))
    keep("topo_scan", *simulate(trace, tables, params, rule, topology=topo,
                                enforce_slot_capacity=True, device=cpu))
    trace2, _ = iid_trace(space, TraceSpec(T=T, N=N, seed=2), device=cpu)
    counted("stream", lambda: simulate_sharded_stream(
        lambda t0, L: (trace2.j_idx[t0:t0 + L], None), T, N, tables,
        params, rule, mesh4, slab=64, device=cpu))
    keep("stream_scan", *simulate(trace2, tables, params, rule, device=cpu))

    # the service stream: full-width source against shard-local columns
    pool = synthetic_pool()
    sim = SimConfig(**SERVICE)
    cs = compile_service_streaming(sim, pool, device=cpu)
    for case, cols in (("src", None), ("cols", cs.slab_cols)):
        counted(case, lambda: simulate_sharded_stream(
            cs.slab, sim.T, sim.num_devices, cs.tables, cs.params, cs.rule,
            mesh4, slab=64, enforce_slot_capacity=True, source_cols=cols,
            device=cpu))

    # the gateway on the (4,) mesh, and the unsharded core beside it
    ss = compile_service_streaming(SimConfig(**GATEWAY), pool, device=cpu)
    T, N = GATEWAY["T"], GATEWAY["num_devices"]
    shards = shards_of(mesh4, "data", torch.device(cpu))
    for case in ("gw", "pipe", "gw_single"):
        core = GatewayCore.for_service(
            ss, **({} if case == "gw_single" else dict(mesh=mesh4)))
        off = np.zeros((T, N), bool)
        adm = np.zeros((T, N), bool)
        reset_collective_counts()
        if case == "pipe":
            core.warmup()
            replies, stats = run_pipelined_loop(
                core, ServiceLoadGen(ss), 0, T, max_in_flight=2,
                slo_ms=60_000.0)
            out["pipe/overlapped"] = np.int64(stats.overlapped_waves)
            out["pipe/fallbacks"] = np.int64(stats.fallback_waves)
            waves = list(ServiceLoadGen(ss).waves(0, T))
            for r, wv in zip(replies, waves):
                off[wv.t, wv.idx], adm[wv.t, wv.idx] = r.offload, r.admitted
        else:
            for wv in ServiceLoadGen(ss).waves(0, T):
                off[wv.t, wv.idx], adm[wv.t, wv.idx] = core.tick(
                    wv.idx, wv.o, wv.h, wv.w)
        counts[case] = collective_counts()
        lam = core.state.lam
        if case != "gw_single":
            lam = gather_cols(lam, shards)
        out[f"{case}/off"], out[f"{case}/adm"] = off, adm
        out[f"{case}/lam"], out[f"{case}/mu"] = lam.numpy(), core.mu

    # ext_step on the (4,) mesh, each rank its columns
    N, T = EXT["N"], EXT["T"]
    trace, _ = iid_trace(space, TraceSpec(T=T, N=N, seed=EXT["seed"]),
                         device=cpu)
    out["inputs/ext"] = trace.j_idx.numpy()
    M = space.M
    cols = shards.cols(N)
    params = OnAlgoParams(B=torch.full((N,), 0.08)[cols],
                          H=torch.tensor(8e8))
    delay = extensions.DelayModel(d_tr=torch.full((M,), 0.05),
                                  d_pr_cloud=torch.full((M,), 0.05))
    state = extensions.init_ext_state(N // WORLD, M, device=cpu)
    o_tab, h_tab, w_tab = tables
    offs, mus, nus = [], [], []
    reset_collective_counts()
    for t in range(T):
        j = trace.j_idx[t, cols].long()
        state, off, _ = extensions.ext_step(
            state, j, o_tab[j], h_tab[j], w_tab[j], j > 0, tables, params,
            rule, zeta=1.0, delay=delay, l_tab=torch.ones((M,)), W=0.5,
            axis_name=shards.group)
        offs.append(off)
        mus.append(state.base.mu)
        nus.append(state.nu)
    counts["ext"] = collective_counts()
    out["ext/off"] = gather_cols(torch.stack(offs), shards).numpy()
    out["ext/mu"] = torch.stack(mus).numpy()
    out["ext/nu"] = torch.stack(nus).numpy()
    out["ext/lam"] = gather_cols(state.base.lam, shards).numpy()

    # the int8 compressed all-reduce: each rank its row of the gradients
    # and residuals (a float32 and a bf16 leaf); the residuals gathered
    from repro_torch.train.compression import compressed_psum
    g_w, g_b, r_w, r_b = (torch.from_numpy(x[shards.index])
                          for x in compression_inputs())
    reset_collective_counts()
    mean, res = compressed_psum({"w": g_w, "b": g_b.to(torch.bfloat16)},
                                {"w": r_w, "b": r_b}, shards.group)
    counts["cpsum"] = collective_counts()
    assert mean["b"].dtype == torch.bfloat16
    out["cpsum/mean_w"] = mean["w"][None].expand(WORLD, -1).numpy()
    out["cpsum/mean_b"] = mean["b"].float()[None].expand(WORLD, -1).numpy()
    for k in ("w", "b"):
        out[f"cpsum/res_{k}"] = gather_cols(res[k][None], shards,
                                            dim=0).numpy()

    # the GPipe schedule over a (4,) "pod" mesh: one stage a rank
    from repro_torch.parallel.pipeline import pipeline_apply
    Ws, xs = (torch.from_numpy(a) for a in pipeline_inputs())
    reset_collective_counts()
    out["gpipe/out"] = pipeline_apply(
        lambda w, h: torch.relu(h @ w), Ws, xs,
        make_test_mesh((4,), ("pod",), device=cpu), axis="pod").numpy()
    counts["gpipe"] = collective_counts()

    # simulate_service(engine="sharded"): mesh=None is the world's 1-D mesh
    for case, kw in (("svc", {}), ("svc_stream", dict(materialize=False,
                                                       slab=64)),
                     ("svc_scan", dict(engine="scan"))):
        kw.setdefault("engine", "sharded")
        for k, v in simulate_service(sim, pool, device=cpu, **kw).items():
            out[f"{case}/{k}"] = np.float64(v)

    # rejections (raised before any collective, so every rank raises)
    errors = {}
    for case, fn in (
            ("shards", lambda: simulate_sharded(
                Trace(j_idx=torch.zeros((4, 18), dtype=torch.int32),
                      d_local=torch.zeros((4, 18))),
                tables, OnAlgoParams(B=torch.full((18,), 0.08),
                                     H=torch.tensor(7e8)),
                rule, mesh4, device=cpu)),
            ("device", lambda: simulate_sharded(
                trace, tables, OnAlgoParams(B=torch.full((N,), 0.08),
                                            H=torch.tensor(8e8)),
                rule, DeviceMesh("cuda", torch.arange(WORLD),
                                 mesh_dim_names=("data",),
                                 _init_backend=False), device=cpu)),
            ("pod", lambda: make_production_mesh(device=cpu)),
            ("multi_pod", lambda: make_production_mesh(multi_pod=True,
                                                       device=cpu)),
            ("test_mesh", lambda: make_test_mesh((2, 3), device=cpu))):
        try:
            fn()
            errors[case] = "no error"
        except ValueError as e:
            errors[case] = str(e)
    out["errors"] = np.array(json.dumps(errors))
    out["counts"] = np.array(json.dumps(counts))
    np.savez(out_path, **out)
    dist.barrier()
    dist.destroy_process_group()


def _spawn(args, env, log):
    return subprocess.Popen(args, env=env, stdout=log,
                            stderr=subprocess.STDOUT, cwd=ROOT)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference npz, [rank npz, ...]): the JAX subprocess and the port's
    four ranks, run side by side."""

    from repro_torch.serve.compile import compile_service_streaming
    from repro_torch.serve.simulator import SimConfig, synthetic_pool
    from repro_torch.workload import ServiceLoadGen

    d = tmp_path_factory.mktemp("world")
    ss = compile_service_streaming(SimConfig(**GATEWAY), synthetic_pool(),
                                   device="cpu")
    waves = {}
    for wv in ServiceLoadGen(ss).waves(0, GATEWAY["T"]):
        for k in ("idx", "o", "h", "w"):
            waves[f"{k}{wv.t}"] = np.asarray(getattr(wv, k))
    np.savez(d / "waves.npz", **waves)

    src = str(ROOT / "src")
    base = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    ref_env = dict(base, XLA_FLAGS=(base.get("XLA_FLAGS", "") +
                                    f" --xla_force_host_platform_device_count"
                                    f"={WORLD}"))
    cfg = dict(plain=PLAIN, overlay=OVERLAY, gateway=GATEWAY, ext=EXT,
               service=SERVICE, waves=str(d / "waves.npz"),
               out=str(d / "ref.npz"))
    rank_env = dict(base, GLOO_SOCKET_IFNAME="lo")
    logs = [open(d / f"log{i}.txt", "w+") for i in range(WORLD + 1)]
    # the reference script gets compression_inputs' source (the same draws)
    script = ("import numpy as np\n" + inspect.getsource(compression_inputs)
              + inspect.getsource(pipeline_inputs)
              + textwrap.dedent(REFERENCE))
    procs = [_spawn([sys.executable, "-c", script,
                     json.dumps(cfg)], ref_env, logs[0])]
    procs += [_spawn([sys.executable, __file__, "--worker", str(r),
                      str(d / "store"), str(d / f"port{r}.npz")], rank_env,
                     logs[r + 1]) for r in range(WORLD)]
    try:
        for p in procs:
            p.wait(timeout=TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log, name in zip(procs, logs,
                            ["reference"] + [f"rank {r}"
                                             for r in range(WORLD)]):
        log.seek(0)
        text = log.read()
        log.close()
        assert p.returncode == 0, f"{name} failed:\n{text[-4000:]}"
    ref = dict(np.load(d / "ref.npz"))
    ranks = [dict(np.load(d / f"port{r}.npz")) for r in range(WORLD)]
    return ref, ranks


def _series_match(got, want, case, keys=None):
    keys = keys or sorted(k.split("/", 1)[1] for k in want
                          if k.startswith(case + "/"))
    assert keys
    for k in keys:
        g, w = got[f"{case}/{k}"], want[f"{case}/{k}"]
        assert g.shape == w.shape, (case, k, g.shape, w.shape)
        if k in EXACT or k == "counts":
            np.testing.assert_array_equal(g, w, err_msg=f"{case}/{k}")
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{case}/{k}")


def _scan_match(port, case, scan=None):
    scan = scan or f"{case}_scan"
    for k in ("reward", "power", "load", "offloads", "tasks", "mu",
              "lam_norm", "lam"):
        np.testing.assert_allclose(port[f"{case}/{k}"],
                                   port[f"{scan}/{k}"], rtol=SCAN_RTOL,
                                   atol=SCAN_ATOL, err_msg=f"{case}/{k}")


def test_ranks_return_the_same_bits(runs):
    """An SPMD run's outputs are replicated: every rank's equal rank 0's."""
    _, ranks = runs
    for r, got in enumerate(ranks[1:], 1):
        assert set(got) == set(ranks[0])
        for k, v in ranks[0].items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"rank {r} {k}")


def test_inputs_are_the_reference_s(runs):
    ref, ranks = runs
    for k in ("inputs/plain", "inputs/overlay", "inputs/assoc", "inputs/ext"):
        np.testing.assert_array_equal(ranks[0][k], ref[k], err_msg=k)


@pytest.mark.parametrize("case", ["plain22", "plain4"])
def test_sharded_matches_reference(runs, case):
    """simulate_sharded on a (2, 2) mesh (the data axis a sub-group of
    two ranks) and on a (4,) mesh: one all-reduce a slot, three gathers."""
    ref, ranks = runs
    _series_match(ranks[0], ref, case)
    _scan_match(ranks[0], case, "plain_scan")
    counts = json.loads(str(ranks[0]["counts"]))[case]
    assert counts == {"all_reduce": PLAIN["T"], "all_gather": 3}


@pytest.mark.parametrize("case", ["overlay", "topo", "stream"])
def test_sharded_variants_match_reference(runs, case):
    """The overlay (its correct series and the admission post-pass), a
    4-cloudlet mobility walk (the (K,) partials all-reduced) and the
    sequential sharded stream (slab 64)."""
    ref, ranks = runs
    _series_match(ranks[0], ref, case)
    _scan_match(ranks[0], case)
    if case == "topo":
        assert ranks[0]["topo/mu_k"].shape == (OVERLAY["T"], 4)
        assert ranks[0]["topo/mu_k"].max() > 0
    if case == "stream":  # slab gathers of the offloads only
        counts = json.loads(str(ranks[0]["counts"]))[case]
        assert counts == {"all_reduce": OVERLAY["T"], "all_gather": 3 + 2}


def test_shard_local_columns_equal_full_width(runs):
    """source_cols (each rank draws its columns; one all-gather a slab of
    offloads, j and overlay) equals the full-width source bit for bit."""
    _, ranks = runs
    port = ranks[0]
    keys = [k for k in port if k.startswith("src/")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(port["cols/" + k[4:]], port[k],
                                      err_msg=k)
    counts = json.loads(str(port["counts"]))
    assert counts["src"] == counts["cols"]


@pytest.mark.parametrize("case", ["gw", "pipe"])
def test_gateway_on_mesh_matches_reference(runs, case):
    """GatewayCore(mesh=...) on the (4,) mesh, by tick and by the
    pipelined loop at depth 2 (warmup included), against the reference's
    mesh core on the same waves: decisions exactly, lam and mu at the
    duals' bar; and against the port's unsharded core: decisions
    exactly."""
    ref, ranks = runs
    port = ranks[0]
    for k in ("off", "adm"):
        np.testing.assert_array_equal(port[f"{case}/{k}"], ref[f"{case}/{k}"])
        np.testing.assert_array_equal(port[f"{case}/{k}"],
                                      port[f"gw_single/{k}"])
    for k in ("lam", "mu"):
        np.testing.assert_allclose(port[f"{case}/{k}"], ref[f"{case}/{k}"],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(port[f"{case}/{k}"],
                                   port[f"gw_single/{k}"], rtol=RTOL,
                                   atol=ATOL)
    counts = json.loads(str(port["counts"]))
    T = GATEWAY["T"]
    assert counts["gw_single"] == {"all_reduce": 0, "all_gather": 0}
    if case == "gw":  # one all-reduce (the load), one all-gather a tick
        assert counts[case] == {"all_reduce": T, "all_gather": T}
    else:
        assert port["pipe/fallbacks"] == 0 and port["pipe/overlapped"] > 0


def test_ext_step_on_mesh_matches_reference(runs):
    """ext_step(axis_name=...) with the delay term and the bandwidth dual:
    two all-reduces a slot (the load, the bandwidth use), as the
    reference psums them."""
    ref, ranks = runs
    port = ranks[0]
    np.testing.assert_array_equal(port["ext/off"], ref["ext/off"])
    for k in ("mu", "nu", "lam"):
        np.testing.assert_allclose(port[f"ext/{k}"], ref[f"ext/{k}"],
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert port["ext/nu"][-1] > 0
    counts = json.loads(str(port["counts"]))["ext"]
    assert counts["all_reduce"] == 2 * EXT["T"]


@pytest.mark.parametrize("case", ["svc", "svc_stream"])
def test_service_sharded_matches_reference(runs, case):
    """simulate_service(engine="sharded") at both materialize values
    against the reference's materialized sharded service (its shard-local
    stream is red, C1) and the port's scan engine."""
    ref, ranks = runs
    port = ranks[0]
    keys = [k.split("/", 1)[1] for k in ref if k.startswith("svc/")]
    assert keys
    for k in keys:
        for want in (ref[f"svc/{k}"], port[f"svc_scan/{k}"]):
            got = port[f"{case}/{k}"]
            assert abs(got - want) <= REL * abs(want) + ABS, (k, got, want)


def test_compressed_psum_matches_reference(runs):
    """compressed_psum on the four gloo ranks (a MAX all-reduce of the
    scale, a SUM all-reduce of the int32 payload, per leaf) equals the
    reference's shard_map'd compressed_psum bit for bit: the mean (float32
    and bf16 leaves) and every rank's residual; the mean is within half a
    quantum of the true mean."""
    ref, ranks = runs
    port = ranks[0]
    for k in ("mean_w", "mean_b", "res_w", "res_b"):
        np.testing.assert_array_equal(port[f"cpsum/{k}"], ref[f"cpsum/{k}"],
                                      err_msg=k)
    g_w = compression_inputs()[0]
    scale = np.abs(g_w + compression_inputs()[2]).max() / 127
    assert np.abs(port["cpsum/mean_w"][0] - g_w.mean(0)).max() <= scale
    counts = json.loads(str(port["counts"]))["cpsum"]
    assert counts == {"all_reduce": 4, "all_gather": 0}


def test_pipeline_apply_matches_reference(runs):
    """pipeline_apply on four gloo ranks (one stage each, activations by
    send / recv, the outputs all-reduced) against the reference's
    shard_map'd GPipe on four host devices and the stages applied in
    sequence, at the reference's bar."""
    ref, ranks = runs
    Ws, xs = pipeline_inputs()
    seq = xs
    for w in Ws:
        seq = np.maximum(seq @ w, 0.0)
    got = ranks[0]["gpipe/out"]
    assert got.shape == (8, 4, 16)
    for want in (ref["gpipe/out"], seq):
        np.testing.assert_allclose(got, want, rtol=SCAN_RTOL, atol=SCAN_ATOL)
    counts = json.loads(str(ranks[0]["counts"]))["gpipe"]
    assert counts == {"all_reduce": 1, "all_gather": 0}


def test_rejections(runs):
    """_validate_shards, a mesh on another device type, and meshes whose
    size is not the world's (four ranks) raise."""
    _, ranks = runs
    errors = json.loads(str(ranks[0]["errors"]))
    assert "multiple of the 'data' axis shard count (4)" in errors["shards"]
    assert "mesh is on 'cuda'" in errors["device"]
    assert "needs 256 ranks; the process group has 4" in errors["pod"]
    assert "needs 512 ranks; the process group has 4" in errors["multi_pod"]
    assert "needs 6 ranks; the process group has 4" in errors["test_mesh"]


def test_mesh_helpers_without_a_world():
    """No process group: the backend follows the run's device, and a mesh
    needs a process group first (none is started here)."""
    import torch.distributed as dist

    from repro_torch.launch import mesh

    assert not dist.is_initialized()
    assert mesh.backend_for("cpu") == "gloo"
    for make in (mesh.make_production_mesh,
                 lambda **kw: mesh.make_test_mesh((1,), ("data",), **kw)):
        with pytest.raises(RuntimeError, match="no process group"):
            make(device="cpu")
    assert not dist.is_initialized()


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.path.insert(0, str(ROOT / "src"))
    _worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
