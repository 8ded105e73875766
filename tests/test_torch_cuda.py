"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and is marked ``requires_cuda``; each
decides inside the ``cuda`` fixture whether a card is present and skips
otherwise.  The file imports torch and the port only (the card's machine
has no JAX).  Run on the card:

    python -m pytest -q -m requires_cuda tests/test_torch_cuda.py

Bars: decisions and visit counts exactly equal; duals within rtol=1e-5,
atol=1e-6 (the kernels reproduce the plain versions' summation order, so
they are expected to be bit-identical; the topology forms sum each
cloudlet's float64 load in another fixed order, so they may differ in
the last float32 rounding); service metrics rel=2e-5; the
attention kernels within ``flash_attention.TOLERANCE``: the reference's
kernel bar in float32, rtol = atol = 2e-5 (tests/test_kernels.py), and
two bf16 ulps in bfloat16 (rtol 1.6e-2, atol 1e-4), since kernel and plain
version both compute in float32 and round once; the SSD chunk kernel
within the reference's kernel bar, rtol = atol = 1e-4
(``ssd_chunk.TOLERANCE``); the draws kernel bit for bit; the streaming
engine's metrics equal the materialized engine's.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import draws as dr
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import onalgo_step as k
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_chunk as sc
from repro_torch.serve.simulator import (SimConfig, simulate_service,
                                         synthetic_pool)

pytestmark = pytest.mark.requires_cuda
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rollout(N, M, T, seed, device, slot_values, per_device_o, base=0):
    """Random rollout operands; counts0 holds ``base`` visits everywhere
    (near 65535 - T it sends K1 / K1-topo to the streaming route)."""
    g = np.random.default_rng(seed)
    f = lambda *shape: torch.tensor(g.random(shape, dtype=np.float32),
                                    device=device)
    j = torch.tensor(g.integers(0, M, (T, N)), dtype=torch.int32,
                     device=device)
    o = f(N, M) if per_device_o else f(M)
    fixed = (o, f(M), f(M) - 0.2, f(N) + 0.05,
             torch.tensor(0.02 * N, device=device), 0.4, 0.5)
    sv = ((f(T, N), f(T, N), f(T, N) - 0.1) if slot_values else None)
    lam0 = f(N) * 0.1

    def args():
        return (j, lam0.clone(), torch.tensor(0.05, device=device),
                torch.full((N, M), float(base), device=device), *fixed)
    return args, sv


# the service width (N=100000, M=73, overlay, o per device) resumed at t0;
# counts0 at 65535 - T + 1 leave uint16 no room: K1 streams
@pytest.mark.parametrize("N,M,T,slot_values,per_device_o,t0,base,route", [
    (20, 16, 64, False, False, 0, 0, "resident"),
    (50, 23, 40, True, True, 5, 0, "resident"),
    (1000, 97, 24, True, False, 64, 0, "resident"),
    (5000, 73, 16, False, True, 3, 0, "resident"),
    (100_000, 73, 16, True, True, 64, 0, "resident"),
    (3000, 73, 16, True, True, 64, 65_535 - 15, "streaming"),
    (777, 73, 16, True, True, 3, 0, "resident"),
])
@pytest.mark.parametrize("kernel", ["chunked", "tiled8", "tiled64",
                                    "tiled256"])
def test_rollout_kernel_matches_plain(cuda, N, M, T, slot_values,
                                      per_device_o, t0, base, route,
                                      kernel):
    args, sv = _rollout(N, M, T, N + M, cuda, slot_values, per_device_o,
                        base)
    want = k.onalgo_chunked_plain(*args(), t0=t0, slot_values=sv)
    before = k.KERNELS["onalgo_chunked" if kernel == "chunked"
                       else "onalgo_tiled"].launches
    a = args()
    if kernel == "chunked":
        got = k.onalgo_chunked_cuda(*a, t0=t0, slot_values=sv)
        after = k.onalgo_chunked_cuda.launches
    else:
        got = k.onalgo_tiled_cuda(*a, block_n=int(kernel[5:]), t0=t0,
                                  slot_values=sv)
        after = k.onalgo_tiled_cuda.launches
    torch.cuda.synchronize()
    assert after == before + 1
    if kernel == "chunked":
        assert k.onalgo_chunked_cuda.route == route
    else:  # K2 keeps counts as uint16 while they stay exact
        assert k.onalgo_tiled_cuda.plan.counts == (
            "uint16" if base + T <= k.COUNT_LIMIT else "float32")
    assert got[3] is a[1] and got[5] is a[3]  # lam / counts in place
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[5], want[5])
    for i in (1, 2, 3, 4):
        torch.testing.assert_close(got[i], want[i], rtol=RTOL, atol=ATOL)


def _topo(N, T, K, seed, device, static):
    """Cloudlet ids, numpy-made: a static (N,) map, or a (T, N) walk from
    the round-robin placement handing over w.p. 0.1 per slot; capacities
    tight enough that the per-cloudlet duals engage."""
    g = np.random.default_rng(seed + 1)
    if static:
        assoc = g.integers(0, K, N)
    else:
        assoc = np.empty((T, N), np.int64)
        cur = np.arange(N) % K
        for t in range(T):
            move = g.random(N) < 0.1
            cur = np.where(move, g.integers(0, K, N), cur)
            assoc[t] = cur
    H_k = (0.05 * N / K) * g.uniform(0.5, 1.5, K)
    return (torch.tensor(assoc, dtype=torch.int32, device=device),
            torch.tensor(H_k, dtype=torch.float32, device=device))


@pytest.mark.parametrize("N,M,T,K,static,slot_values,t0,base,route", [
    (20, 16, 64, 1, False, False, 0, 0, "resident"),
    (50, 23, 40, 3, True, True, 5, 0, "resident"),
    (1000, 73, 24, 130, False, True, 64, 0, "resident"),
    (3000, 37, 16, 600, False, False, 3, 0, "resident"),
    (500, 16, 16, 600, True, False, 0, 0, "resident"),
    (100_000, 73, 16, 1024, False, True, 64, 0, "resident"),
    (3000, 37, 16, 600, False, True, 3, 65_535 - 15, "streaming"),
    (20_000, 73, 24, 4, True, True, 64, 0, "resident"),
])
@pytest.mark.parametrize("kernel", ["chunked", "tiled8", "tiled64",
                                    "tiled256"])
def test_topo_rollout_kernel_matches_plain(cuda, N, M, T, K, static,
                                           slot_values, t0, base, route,
                                           kernel):
    """K1-topo / K2-topo against the plain K-vector rollout: static and
    time-varying maps, K from 1 to 1024, resumed at t0, every topo_binned
    value (one kernel serves both layouts: identical bits); K1-topo on
    the route the plan gives (the service width resident, counts near
    65535 - T streaming)."""
    args, sv = _rollout(N, M, T, N + M + K, cuda, slot_values, False, base)
    assoc, H_k = _topo(N, T, K, N + K, cuda, static)
    mu0 = torch.full((K,), 0.02, device=cuda)

    def topo_args():
        a = list(args())
        a[2] = mu0
        return a
    want = k.onalgo_chunked_plain(*topo_args(), t0=t0, slot_values=sv,
                                  assoc=assoc, H_k=H_k)
    name = "onalgo_chunked_topo" if kernel == "chunked" else \
        "onalgo_tiled_topo"
    runs = []
    for binned in (None, True, False):
        before = ops.launch_counts()
        a = topo_args()
        kw = dict(chunk=T, t0=t0, slot_values=sv, assoc=assoc, H_k=H_k,
                  topo_binned=binned)
        got = (ops.onalgo_chunked(*a, **kw) if kernel == "chunked" else
               ops.onalgo_tiled(*a, block_n=int(kernel[5:]), **kw))
        torch.cuda.synchronize()
        after = ops.launch_counts()
        assert after[name] == before[name] + 1
        assert all(after[n] == before[n] for n in after if n != name)
        if kernel == "chunked":
            assert k.onalgo_chunked_topo_cuda.route == route
        assert got[3] is a[1] and got[5] is a[3]  # lam / counts in place
        assert got[1].shape == (T, K) and got[4].shape == (K,)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[5], want[5])
        for i in (1, 2, 3, 4):
            torch.testing.assert_close(got[i], want[i], rtol=RTOL, atol=ATOL)
        runs.append(got)
    for other in runs[1:]:
        for x, y in zip(runs[0], other):
            assert torch.equal(x, y)
    assert float(want[1].max()) > 0.02  # the per-cloudlet duals moved


@pytest.mark.parametrize("K", [None, 4, 4096])
@pytest.mark.parametrize("route", ["resident", "streaming"])
def test_rollout_kernel_repeats_bit_identical(cuda, K, route):
    """Two launches of K1 / K1-topo on the same inputs give the same bits
    on either route (no float atomics; every order fixed), K=4096
    included, and agree with the plain version.  The route is reached by
    size: counts0 at 65535 - 15 leave uint16 no room for T=32 slots."""
    N, M, T = 20_000, 73, 32
    base = 0 if route == "resident" else 65_535 - 15
    args, sv = _rollout(N, M, T, 11, cuda, True, True, base)
    kw = dict(t0=7, slot_values=sv)
    if K is not None:
        assoc, H_k = _topo(N, T, K, 5, cuda, False)
        kw.update(assoc=assoc, H_k=H_k)
    wrapper = k.onalgo_chunked_cuda if K is None else \
        k.onalgo_chunked_topo_cuda

    def fresh():
        a = list(args())
        if K is not None:
            a[2] = torch.full((K,), 0.02, device=cuda)
        return a
    got = wrapper(*fresh(), **kw)
    again = wrapper(*fresh(), **kw)
    torch.cuda.synchronize()
    assert wrapper.route == route
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    want = k.onalgo_chunked_plain(*fresh(), **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[5], want[5])
    for i in (1, 2, 3, 4):
        torch.testing.assert_close(got[i], want[i], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("K", [None, 1, 4, 1024])
@pytest.mark.parametrize("base", [0, 65_535 - 15])
def test_tiled_repeats_bit_identical(cuda, K, base):
    """Two calls of K2 / K2-topo on the same inputs give the same bits, on
    the uint16 and the float32 count route (base 65535 - 15 leaves uint16
    no room for T=32), and agree with the plain version; one wrapper call
    counts as one launch."""
    N, M, T = 20_000, 73, 32
    args, sv = _rollout(N, M, T, 13, cuda, True, True, base)
    kw = dict(t0=7, slot_values=sv, block_n=256)
    if K is not None:
        assoc, H_k = _topo(N, T, K, 5, cuda, False)
        kw.update(assoc=assoc, H_k=H_k)
    wrapper = k.onalgo_tiled_cuda if K is None else k.onalgo_tiled_topo_cuda

    def fresh():
        a = list(args())
        if K is not None:
            a[2] = torch.full((K,), 0.02, device=cuda)
        return a
    before = wrapper.launches
    got = wrapper(*fresh(), **kw)
    again = wrapper(*fresh(), **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert wrapper.plan.counts == ("uint16" if base == 0 else "float32")
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    kw.pop("block_n")
    want = k.onalgo_chunked_plain(*fresh(), **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[5], want[5])
    for i in (1, 2, 3, 4):
        torch.testing.assert_close(got[i], want[i], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["passes", "o shared", "h w per device",
                                  "side stream", "T=1"])
@pytest.mark.parametrize("topo", [False, True])
def test_tiled_variants_match_plain(cuda, case, topo):
    """K2 / K2-topo off the service path: a tile wider than the block
    (block_n=1000, taken in passes), o shared (M,), per-device h and w,
    the slots enqueued on a stream other than the default, and a single
    slot (the first slot is the last)."""
    N, M, T = 3001, 37, 1 if case == "T=1" else 12
    args, sv = _rollout(N, M, T, 21, cuda, True, case != "o shared", 0)
    kw = dict(t0=5, slot_values=sv)
    if topo:
        assoc, H_k = _topo(N, T, 130, 9, cuda, False)
        kw.update(assoc=assoc, H_k=H_k)

    def fresh():
        a = list(args())
        if topo:
            a[2] = torch.full((130,), 0.02, device=cuda)
        if case == "h w per device":
            g = np.random.default_rng(3)
            a[5] = torch.tensor(g.random((N, M), dtype=np.float32),
                                device=cuda)
            a[6] = torch.tensor(g.random((N, M), dtype=np.float32) - 0.2,
                                device=cuda)
        return a
    want = k.onalgo_chunked_plain(*fresh(), **kw)
    a = fresh()
    wrapper = k.onalgo_tiled_topo_cuda if topo else k.onalgo_tiled_cuda
    stream = torch.cuda.Stream() if case == "side stream" else \
        torch.cuda.current_stream()
    with torch.cuda.stream(stream):
        got = wrapper(*a, block_n=1000 if case == "passes" else 64, **kw)
    torch.cuda.synchronize()
    if case == "passes":
        assert wrapper.plan.passes > 1
    assert got[3] is a[1] and got[5] is a[3]
    assert torch.equal(got[0], want[0]) and torch.equal(got[5], want[5])
    for i in (1, 2, 3, 4):
        torch.testing.assert_close(got[i], want[i], rtol=RTOL, atol=ATOL)


def test_tiled_plan_matches_the_card(cuda):
    """The plan's shared-memory sum is the kernel's own layout, and on the
    card the service width keeps uint16 counts in 256-thread blocks, one
    per SM."""
    lib = k._lib()
    for threads, M, S, esize, o_dev in ((256, 73, 74, 2, True),
                                        (192, 73, 73, 4, True),
                                        (256, 16, 18, 2, False),
                                        (96, 97, 98, 2, True)):
        for cells in (1, 3, 64):
            assert lib.onalgo_tiled_smem(threads, M, S, esize, int(o_dev),
                                         cells) == \
                k.tiled_smem(threads, M, S, esize, o_dev, cells)
    sms, optin = k._device_limits(torch.cuda.current_device())
    plan = k.tiled_plan(100_000, 73, 512, 0, 256, True, sms, optin)
    assert (plan.counts, plan.threads, plan.grid) == ("uint16", 256, sms)


def test_chunked_plan_matches_the_card(cuda):
    """The plan's shared-memory sum is the kernel's own layout, and on the
    card the service width runs resident, K up to 4096 included."""
    lib = k._lib()
    for per, M, K, warps, o_dev in ((768, 73, 0, 4, True),
                                    (768, 73, 4096, 4, True),
                                    (32, 16, 600, 2, False),
                                    (96, 97, 3, 1, True)):
        assert lib.onalgo_resident_smem(per, M, K, warps, int(o_dev)) == \
            k.resident_smem(per, M, K, warps, o_dev)
    sms, optin = k._device_limits(torch.cuda.current_device())
    warps = lib.onalgo_threads_per_block() // 32
    for K in (0, 4, 1024, 4096):
        plan = k.chunked_plan(100_000, 73, 512, 0, K, optin, sms,
                              k._max_blocks(cuda, K or None), warps)
        assert plan.route == "resident" and plan.grid <= sms


def test_topo_wrappers_reject_bad_operands(cuda):
    args, _ = _rollout(8, 5, 8, 0, cuda, False, False)
    assoc, H_k = _topo(8, 8, 3, 0, cuda, True)
    a = list(args())
    a[2] = torch.zeros(3, device=cuda)
    with pytest.raises(ValueError, match="together"):
        ops.onalgo_chunked(*a, assoc=assoc)
    with pytest.raises(ValueError, match="together"):
        k.onalgo_tiled_topo_cuda(*a, H_k=H_k)
    bad = assoc.clone()
    bad[2] = 3
    with pytest.raises(ValueError, match="outside"):
        k.onalgo_chunked_topo_cuda(*a, assoc=bad, H_k=H_k)
    with pytest.raises(TypeError, match="int32"):
        k.onalgo_chunked_topo_cuda(*a, assoc=assoc.long(), H_k=H_k)
    with pytest.raises(ValueError, match="mu0"):
        k.onalgo_tiled_topo_cuda(*args(), assoc=assoc, H_k=H_k)


def test_topology_service_engines_match_cpu(cuda):
    from repro_torch.topology import Topology
    sim = SimConfig(num_devices=300, T=100, B_n=0.06, H=0.1 * 300 * 441e6,
                    seed=3)
    pool = synthetic_pool()
    for K in (1, 4):
        topo = Topology.mobility_walk(K, 300, 100, H=sim.H, p_handover=0.05,
                                      seed=2, device="cpu")
        want = simulate_service(sim, pool, topology=topo, device="cpu")
        assert want["mu_final"] > 0
        for kw in ({}, dict(engine="chunked", chunk=16),
                   dict(engine="chunked", chunk=16, block_n=64)):
            got = simulate_service(sim, pool, topology=topo, device=cuda,
                                   **kw)
            for key, v in want.items():
                assert got[key] == pytest.approx(v, rel=2e-5, abs=1e-5), \
                    (K, kw, key)


def _duals_args(N, M, per_device_o, device):
    g = np.random.default_rng(N)
    f = lambda *shape: torch.tensor(g.random(shape, dtype=np.float32),
                                    device=device)
    rho = f(N, M)
    rho = rho / rho.sum(dim=1, keepdim=True)
    return (f(N), torch.tensor(0.3, device=device), rho,
            f(N, M) if per_device_o else f(M), f(M), f(M) - 0.2,
            f(N) + 0.05)


@pytest.mark.parametrize("N,M,per_device_o", [
    (4, 7, False), (1000, 97, False), (100_000, 73, True),
    (256 * 1000 + 1, 73, True),   # a ragged last block
    (5000, 72, True),             # even M: rows two to a bank
    (3000, 40, False),
    (500, 880, True),             # the widest whole rows with o per device
    (700, 881, True),             # rows in chunks of columns
    (1000, 1661, False),          # chunks with shared tables
    (300, 5003, False)])          # five chunks, the last ragged
def test_duals_kernel_matches_plain(cuda, N, M, per_device_o):
    """K3: g_pow bit for bit (row_sum's order, one multiply and one add a
    state); the load within rtol 1e-5 (summed over blocks in another
    fixed order) and the same bits from two calls."""
    args = _duals_args(N, M, per_device_o, cuda)
    g_want, l_want = k.onalgo_duals_plain(*args)
    g_got, l_got = ops.onalgo_duals(*args)
    g_two, l_two = ops.onalgo_duals(*args)
    assert torch.equal(g_got, g_want)
    torch.testing.assert_close(l_got, l_want, rtol=RTOL, atol=0.0)
    assert torch.equal(g_two, g_got) and torch.equal(l_two, l_got)


def test_duals_kernel_is_one_launch(cuda):
    """K3's wrapper enqueues one kernel a call (the load is reduced in
    it, no torch reduction follows), with mu the float32 device scalar
    the slot loop passes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    args = _duals_args(1000, 73, True, cuda)
    k.onalgo_duals_cuda(*args)
    torch.cuda.synchronize()
    before = k.onalgo_duals_cuda.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        g_pow, load = k.onalgo_duals_cuda(*args)
        torch.cuda.synchronize()
    assert k.onalgo_duals_cuda.launches == before + 1
    names = [e.key for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA]
    assert len(names) == 1 and "onalgo_duals_kernel" in names[0], names
    assert torch.equal(g_pow, k.onalgo_duals_plain(*args)[0])


def test_duals_kernel_on_two_streams(cuda):
    """K3 calls enqueued on two streams at once keep their own done
    counters: every load is the one a call alone gives."""
    calls = [_duals_args(N, 73, True, cuda) for N in (100_000, 30_000)]
    want = [k.onalgo_duals_cuda(*a)[1] for a in calls]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(20):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[i].append(k.onalgo_duals_cuda(*calls[i])[1])
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(load, want[i]) for load in got[i])


def test_wrappers_reject_bad_operands(cuda):
    args, _ = _rollout(8, 5, 8, 0, cuda, False, False)
    a = list(args())
    a[0] = a[0].long()
    with pytest.raises(TypeError, match="int32"):
        k.onalgo_chunked_cuda(*a)
    a = list(args())
    a[3] = torch.zeros((5, 8), device=cuda).T  # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        k.onalgo_tiled_cuda(*a)
    a = list(args())
    a[0] = a[0].clone()
    a[0][3, 2] = 5  # M = 5 states: index 5 is out of range
    with pytest.raises(ValueError, match="outside"):
        k.onalgo_chunked_cuda(*a)


def test_service_engines_match_cpu(cuda):
    sim = SimConfig(num_devices=300, T=100, B_n=0.06, H=0.1 * 300 * 441e6,
                    seed=3)
    pool = synthetic_pool()
    want = simulate_service(sim, pool, device="cpu")
    assert want["mu_final"] > 0  # the capacity binds
    for kw in ({}, dict(engine="chunked", chunk=16),
               dict(engine="chunked", chunk=16, block_n=64)):
        got = simulate_service(sim, pool, device=cuda, **kw)
        for key, v in want.items():
            assert got[key] == pytest.approx(v, rel=2e-5, abs=1e-5), (kw,
                                                                     key)


def _attn_tol(dtype):
    return fa.TOLERANCE[dtype]


def _randn(shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype)


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D", [
    (1, 128, 128, 4, 4, 64), (2, 256, 256, 8, 2, 64),
    (1, 512, 512, 4, 1, 128), (2, 128, 128, 2, 2, 32),
    (3, 25, 25, 4, 2, 128),       # ragged against the 64 x 32 tiles
    (1, 128, 384, 4, 4, 128),     # Skv > Sq
    # the tensor-core route (bf16): 128-row query and 128-key KV tiles by
    # TMA, ragged Sq / Skv zero-filled, G = 1, 4, 7 at D = 32, 64, 128
    (1, 1, 16, 14, 2, 128), (2, 16, 16, 7, 1, 32), (3, 25, 25, 4, 1, 64),
    (2, 384, 384, 14, 2, 64), (1, 128, 256, 4, 4, 32),
    # the model zoo at D = 64: seamless's encoder (512 frames) and its
    # prefill cross-attention (16 prompt rows against 512 memory rows)
    (4, 512, 512, 16, 16, 64), (4, 16, 512, 16, 16, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, B, Sq, Skv, Hq, Hkv, D, causal,
                                    dtype):
    q = _randn((B, Sq, Hq, D), dtype, cuda, 1)
    kk = _randn((B, Skv, Hkv, D), dtype, cuda, 2)
    v = _randn((B, Skv, Hkv, D), dtype, cuda, 3)
    want = fa.flash_attention_plain(q, kk, v, causal=causal)
    before = fa.flash_attention_cuda.launches
    got = ops.flash_attention(q, kk, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **_attn_tol(dtype))


@pytest.mark.parametrize("B,S,Hq,Hkv,D", [
    (2, 256, 8, 2, 64), (1, 512, 4, 4, 128), (4, 128, 2, 1, 32),
    (16, 25, 16, 16, 128),
    # G = 7 and 8 with several splits (split_plan: B * Hkv blocks a split)
    (2, 2048, 14, 2, 64), (1, 2048, 8, 1, 128),
    # the model zoo at D = 64: internvl2's cache (G = 7, 256 prefix rows
    # and the prompt in 384), seamless's cross-attention memory
    (4, 384, 14, 2, 64), (4, 512, 16, 16, 64)])
@pytest.mark.parametrize("n", [1, 0.25, 0.8, 1.0, 10_000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain(cuda, B, S, Hq, Hkv, D, n, dtype):
    n = n if isinstance(n, int) else max(1, int(S * n))
    q = _randn((B, 1, Hq, D), dtype, cuda, 4)
    kc = _randn((B, S, Hkv, D), dtype, cuda, 5)
    vc = _randn((B, S, Hkv, D), dtype, cuda, 6)
    want = da.decode_attention_plain(q, kc, vc, n)
    before = da.decode_attention_cuda.launches
    got = ops.decode_attention(q, kc, vc, n)
    torch.cuda.synchronize()
    assert da.decode_attention_cuda.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), **_attn_tol(dtype))


@pytest.mark.parametrize("G", [1, 7, 8])
@pytest.mark.parametrize("n", [1023, 1024, 1025, 1281])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_split_boundaries(cuda, G, n, dtype):
    """cache_len one key either side of split and tile boundaries (1024 is
    four splits of 256 keys; 1023, 1025 and 1281 move every boundary), the
    splits merged in a second launch, still one counted call."""
    q = _randn((1, 1, 2 * G, 128), dtype, cuda, 10)
    kc = _randn((1, 1280 + 128, 2, 128), dtype, cuda, 11)
    vc = _randn((1, 1280 + 128, 2, 128), dtype, cuda, 12)
    assert len(da.split_plan(1, 2, n)) > 1
    want = da.decode_attention_plain(q, kc, vc, n)
    before = da.decode_attention_cuda.launches
    got = da.decode_attention_cuda(q, kc, vc, n)
    torch.cuda.synchronize()
    assert da.decode_attention_cuda.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), **_attn_tol(dtype))


def test_attention_wrappers_reject_bad_operands(cuda):
    q = _randn((1, 128, 4, 64), torch.float32, cuda, 7)
    kv = _randn((1, 128, 2, 64), torch.float32, cuda, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention_cuda(q.cpu(), kv.cpu(), kv.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_cuda(q, kv.transpose(1, 2).contiguous()
                                .transpose(1, 2), kv)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention_cuda(q.half(), kv.half(), kv.half())
    with pytest.raises(TypeError, match="like q"):
        fa.flash_attention_cuda(q, kv.to(torch.bfloat16), kv)
    long_ = _randn((1, 192, 2, 64), torch.float32, cuda, 9)
    with pytest.raises(ValueError, match="multiple of its block"):
        fa.flash_attention_cuda(q, long_, long_)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_cuda(q[..., :48].contiguous(),
                                kv[..., :48].contiguous(),
                                kv[..., :48].contiguous())
    q1 = q[:, :1].contiguous()
    with pytest.raises(ValueError, match="CUDA tensor"):
        da.decode_attention_cuda(q1.cpu(), kv.cpu(), kv.cpu(), 5)
    with pytest.raises(ValueError, match="multiple of its block"):
        da.decode_attention_cuda(q1, long_, long_, 5)
    with pytest.raises(ValueError, match=">= 1"):
        da.decode_attention_cuda(q1, kv, kv, 0)
    with pytest.raises(ValueError, match="host int"):
        da.decode_attention_cuda(q1, kv, kv, torch.tensor(5, device=cuda))


def _ssd_inputs(shape, g, device, seed):
    """x, dt, A, B, C (B and C with g groups) as the reference's kernel test
    draws them, numpy-made, float32 on ``device``."""
    b, nc, Q, h, p, n = shape
    r = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a.astype(np.float32), device=device)
    return (t(r.standard_normal((b, nc, Q, h, p))),
            t(np.log1p(np.exp(r.standard_normal((b, nc, Q, h)))) * 0.5),
            t(-np.exp(r.standard_normal(h) * 0.3)),
            t(r.standard_normal((b, nc, Q, g, n)) * 0.5),
            t(r.standard_normal((b, nc, Q, g, n)) * 0.5))


@pytest.mark.parametrize("b,nc,Q,h,p,n,g", [
    (1, 2, 128, 2, 64, 32, 2), (2, 1, 64, 4, 32, 128, 4),
    (1, 4, 128, 8, 64, 16, 8),    # the reference's kernel-test shapes
    (2, 2, 33, 4, 32, 16, 4),     # a ragged chunk
    (16, 1, 16, 32, 64, 128, 1),  # mamba2-370m's serving wave, per group
    (2, 3, 128, 32, 64, 128, 1),  # its long forward, fewer chunks
    (1, 1, 1, 2, 16, 8, 1), (3, 1, 100, 4, 128, 128, 2),
    (1, 2, 128, 4, 128, 128, 1),  # the widest: p = n = Q = 128, one group
    (2, 4, 64, 16, 32, 64, 4),    # 1 < g < h
    (4, 8, 64, 10, 32, 64, 1),    # 10 heads a group, 4 a block (4, 4, 2)
    # Jamba's Mamba layers (128 heads, p = 64, n = 16, one group): the
    # serving wave and a long forward
    (16, 1, 16, 128, 64, 16, 1), (4, 16, 128, 128, 64, 16, 1)])
def test_ssd_chunk_kernel_matches_plain(cuda, b, nc, Q, h, p, n, g):
    x, dt, A, B, C = _ssd_inputs((b, nc, Q, h, p, n), g, cuda, Q + n)
    want = sc.ssd_chunk_plain(x, dt, A, B, C)
    before = sc.ssd_chunk_cuda.launches
    got = ops.ssd_chunk(x, dt, A, B, C)
    again = ops.ssd_chunk(x, dt, A, B, C)
    torch.cuda.synchronize()
    assert sc.ssd_chunk_cuda.launches == before + 2
    assert all(torch.equal(a, r) for a, r in zip(got, again))
    assert got[0].shape == (b, nc, Q, h, p) and got[1].shape == (b, nc, h,
                                                                  p, n)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **sc.TOLERANCE)
    if g < h:  # the head-expanded form gives the group form's result
        rep = lambda t: t.repeat_interleave(h // g, dim=3).contiguous()
        expanded = ops.ssd_chunk(x, dt, A, rep(B), rep(C))
        assert all(torch.equal(a, e) for a, e in zip(got, expanded))


@pytest.mark.parametrize("Q", [1, 16, 64, 65, 127])
def test_ssd_chunk_kernel_chunk_lengths(cuda, Q):
    """K4 pads Q to a multiple of 16 rows (the height of its products'
    tiles) with zeros and writes back only Q rows."""
    b, nc, h, p, n, g = 2, 2, 8, 64, 128, 2
    args = _ssd_inputs((b, nc, Q, h, p, n), g, cuda, 100 + Q)
    want = sc.ssd_chunk_plain(*args)
    got = sc.ssd_chunk_cuda(*args)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **sc.TOLERANCE)


def test_ssd_chunk_heads_per_block_keep_the_bits(cuda, monkeypatch):
    """However many heads of a group a block takes (and so shares C B^T
    over), every head's y_diag and states are the same bits."""
    shape, g = (2, 3, 128, 10, 64, 128), 1
    args = _ssd_inputs(shape, g, cuda, 5)
    results = []
    for heads in (1, 3, 4, 8, 16):
        monkeypatch.setattr(sc, "ssd_plan",
                            lambda *a, heads=heads: sc.SSDPlan(heads, 0, 0))
        results.append(sc.ssd_chunk_cuda(*args))
        assert sc.ssd_chunk_cuda.plan.heads == heads
    for r in results[1:]:
        assert all(torch.equal(a, w) for a, w in zip(r, results[0]))
    for a, w in zip(results[0], sc.ssd_chunk_plain(*args)):
        torch.testing.assert_close(a, w, **sc.TOLERANCE)


def test_ssd_wrapper_rejects_bad_operands(cuda):
    args = _ssd_inputs((1, 2, 16, 4, 32, 16), 2, cuda, 0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sc.ssd_chunk_cuda(*(a.cpu() for a in args))
    with pytest.raises(TypeError, match="float32"):
        sc.ssd_chunk_cuda(args[0].double(), *args[1:])
    with pytest.raises(TypeError, match="float32"):
        sc.ssd_chunk_cuda(*(a.bfloat16() for a in args))
    long_ = _ssd_inputs((1, 1, 129, 4, 32, 16), 2, cuda, 1)
    with pytest.raises(ValueError, match="chunk length"):
        sc.ssd_chunk_cuda(*long_)
    with pytest.raises(ValueError, match="head dim"):
        sc.ssd_chunk_cuda(*_ssd_inputs((1, 1, 16, 4, 48, 16), 2, cuda, 2))
    with pytest.raises(ValueError, match="multiple of 4"):
        sc.ssd_chunk_cuda(*_ssd_inputs((1, 1, 16, 4, 32, 6), 2, cuda, 3))
    with pytest.raises(ValueError, match="divide"):
        sc.ssd_chunk_cuda(*_ssd_inputs((1, 1, 16, 4, 32, 16), 3, cuda, 4))
    x = args[0].transpose(3, 4).contiguous().transpose(3, 4)
    with pytest.raises(ValueError, match="contiguous"):
        sc.ssd_chunk_cuda(x, *args[1:])
    before = sc.ssd_chunk_cuda.launches
    with pytest.raises(ValueError):
        ops.ssd_chunk(*long_)
    assert sc.ssd_chunk_cuda.launches == before


def test_mamba_kernel_route_matches_cpu(cuda):
    """Reduced mamba2-370m in float32: the forward with K4 in every layer
    on the card against the plain route on the CPU, same weights, over a
    ragged 33-token chunk."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.api import ModelAPI
    cfg = get_config("mamba2-370m").reduced()
    params, _ = ModelAPI(cfg).init(torch.Generator().manual_seed(0))
    toks = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 33)), dtype=torch.int32)
    want, _, _ = lm.forward(cfg, params, toks)
    before = sc.ssd_chunk_cuda.launches
    got, _, _ = lm.forward(cfg, copy.deepcopy(params).to(cuda),
                           toks.to(cuda), use_kernel=True)
    torch.cuda.synchronize()
    assert sc.ssd_chunk_cuda.launches == before + cfg.num_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# the draws kernel (the workload and mobility-walk draws) and the
# streaming engine

def _draws_entry(proc, n, device, seed):
    """A random state entering a block: (on, rate) / (assoc,)."""
    g = torch.Generator(device=device).manual_seed(seed)
    if isinstance(proc, dr.ServiceProcess):
        return (torch.rand(n, device=device, generator=g) < 0.5,
                torch.randint(0, proc.num_rates, (n,), device=device,
                              generator=g, dtype=torch.int32))
    return (torch.randint(0, proc.K, (n,), device=device, generator=g,
                          dtype=torch.int32),)


def _draws_match(proc, b0, nb, device, resumed, **kw):
    n = kw.get("n_cols") or proc.N - kw.get("n0", 0)
    entry = _draws_entry(proc, n, device, b0) if resumed else None
    got = dr.draws_cuda(proc, b0, nb, entry, device=device, **kw)
    want = dr.draws_plain(proc, b0, nb, entry, device=device, **kw)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)
    return got, entry


# N = 1000 and 777: not a multiple of the kernel's 128-thread block
@pytest.mark.parametrize("N", [1000, 777])
@pytest.mark.parametrize("case", [
    dict(b0=0, nb=3, resumed=False, length=150),  # fresh, unaligned T
    dict(b0=0, nb=2, resumed=False, length=128),  # fresh, aligned
    dict(b0=4, nb=1, resumed=True, off=0, length=64),  # aligned slab
    dict(b0=4, nb=2, resumed=True, off=17, length=64),  # unaligned slab
    dict(b0=0, nb=4, resumed=False, boundary=True),
    dict(b0=3, nb=3, resumed=True, boundary=True),
    dict(b0=2, nb=3, resumed=True, off=10, length=100, n0=100,
         n_cols=333)])
@pytest.mark.parametrize("process", ["service", "walk"])
def test_draws_kernel_matches_plain(cuda, N, case, process):
    proc = (dr.ServiceProcess(seed=3, N=N, pool_size=64, num_rates=3,
                              p_on=0.125, p_stay=0.875, p_init=0.4375,
                              p_change=0.09375)
            if process == "service" else
            dr.WalkProcess(seed=3, N=N, K=7, p_handover=0.046875))
    case = dict(case)
    _draws_match(proc, case.pop("b0"), case.pop("nb"), cuda,
                 case.pop("resumed"), **case)


@pytest.mark.parametrize("boundary", [False, True])
def test_draws_kernel_column_form_past_two_to_the_32(cuda, boundary):
    """N = 2^25: the flat counter passes 2^32 from row 32 on (its hi word
    is nonzero); the last 1000 columns equal the plain version."""
    proc = dr.ServiceProcess(seed=1, N=2 ** 25, pool_size=64, num_rates=3,
                             p_on=0.125, p_stay=0.875, p_init=0.4375,
                             p_change=0.09375)
    kw = dict(boundary=True) if boundary else dict(length=128)
    _draws_match(proc, 0, 2, cuda, False, n0=2 ** 25 - 1000, n_cols=1000,
                 **kw)


def test_draws_kernel_repeats_bit_identical(cuda):
    proc = dr.WalkProcess(seed=5, N=4099, K=1024, p_handover=0.015625)
    first, entry = _draws_match(proc, 1, 3, cuda, True, off=30, length=150)
    again = dr.draws_cuda(proc, 1, 3, entry, off=30, length=150,
                          device=cuda)
    assert torch.equal(first[0], again[0])


def test_draws_kernel_is_one_launch_and_the_lowering_route(cuda):
    """The materialized lowering, the streaming slab, the boundary pass
    and the walk each go through the kernel, once a call."""
    from repro_torch.serve.compile import (compile_service,
                                           compile_service_streaming)
    from repro_torch.topology import Topology
    sim = SimConfig(num_devices=500, T=150, B_n=0.06, H=50 * 441e6, seed=2)
    for fn, want in (
            (lambda: compile_service(sim, synthetic_pool(), device=cuda), 1),
            (lambda: compile_service_streaming(sim, synthetic_pool(),
                                               device=cuda).slab(3, 64), 2),
            (lambda: Topology.mobility_walk(8, 500, 150, 1.0, device=cuda),
             1),
            (lambda: Topology.mobility_walk(8, 500, 150, 1.0, device=cuda,
                                            streaming=True).assoc_at(5, 9),
             2)):
        dr.draws_cuda.launches = 0
        fn()
        assert dr.draws_cuda.launches == want


@pytest.mark.parametrize("kw", [dict(block_n=None), dict(block_n=64),
                                dict(block_n=64, topology="walk")])
def test_streaming_engine_matches_materialized(cuda, kw):
    """materialize=False (slab 64, chunk 16) against the materialized
    chunked run at the same chunk, on the card: the same metrics bit for
    bit, with the slab loop run under set_sync_debug_mode("error"), so
    nothing in it waits for the card."""
    from repro_torch.core import fleet
    from repro_torch.topology import Topology
    N, T = 3000, 203
    sim = SimConfig(num_devices=N, T=T, B_n=0.06, H=0.1 * N * 441e6, seed=3)
    kw = dict(kw)
    if kw.pop("topology", None):
        kw["topology"] = Topology.mobility_walk(
            16, N, T, sim.H, p_handover=0.05, seed=3, streaming=True,
            device=cuda)
    pool = synthetic_pool()
    want = simulate_service(sim, pool, engine="chunked", chunk=16,
                            device=cuda, **kw)
    fleet.SLAB_LOOP_SYNC_DEBUG = "error"
    try:
        got = simulate_service(sim, pool, engine="chunked", chunk=16,
                               materialize=False, slab=64, device=cuda,
                               **kw)
    finally:
        fleet.SLAB_LOOP_SYNC_DEBUG = None
    assert got == want
    assert want["mu_final"] > 0  # the capacity binds


@pytest.mark.parametrize("N,T,kw", [
    (100_000, 512, dict(chunk=16)),  # the fig5 cell's call
    (1_000_000, 256, dict(chunk=16, block_n=256, materialize=False,
                          slab=64)),  # the fleet cell's
])
def test_obs_counts_every_host_sync_of_a_call(cuda, N, T, kw):
    """A warmed service call under torch.profiler and
    set_sync_debug_mode("warn"), its slab loop under SLAB_LOOP_SYNC_DEBUG
    = "error" (so no span waits for the card): as many sync warnings as
    ``obs`` counts host syncs, the leaf spans' device ms at least 90% of
    the service span's, and the metrics of the untraced call."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.core import fleet
    sim = SimConfig(num_devices=N, T=T, B_n=0.06, H=0.5 * N * 441e6, seed=3)
    pool = synthetic_pool()
    want = simulate_service(sim, pool, engine="chunked", device=cuda, **kw)
    obs.reset()
    fleet.SLAB_LOOP_SYNC_DEBUG = "error"
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]), \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                got = simulate_service(sim, pool, engine="chunked",
                                       device=cuda, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        fleet.SLAB_LOOP_SYNC_DEBUG = None
    recs, rep = obs.records(), obs.report()
    obs.reset()
    assert got == want
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert len(syncs) == rep["host_syncs"] > 0
    parents = {r["parent"] for r in recs}
    (svc,) = [r for r in recs if r["parent"] is None]
    leaves = sum(r["device_ms"] for r in recs if r["id"] not in parents)
    assert leaves >= 0.9 * svc["device_ms"]


@pytest.mark.parametrize("block_n", [None, 64])
def test_streamed_run_raises_on_a_state_index_out_of_range(cuda, block_n):
    """A j out of range in the second slab of a streamed run: the kernel
    holds it to the tables and flags it, the run raises after its slab
    loop, and the card works on (no illegal access, no sticky error)."""
    from repro_torch.core import fleet
    from repro_torch.serve.compile import compile_service
    N, T = 700, 150
    sim = SimConfig(num_devices=N, T=T, B_n=0.06, H=0.1 * N * 441e6, seed=2)
    cs = compile_service(sim, synthetic_pool(), device=cuda)
    M = cs.tables[0].shape[-1]
    for bad in (M, -1):
        j = cs.trace.j_idx.clone()
        j[70, 123] = bad
        with pytest.raises(ValueError, match=rf"j_seq holds state indices "
                                             rf"outside \[0, {M}\)"):
            fleet.simulate_chunked_stream(
                lambda t0, L: (j[t0:t0 + L], None), T, N, cs.tables,
                cs.params, cs.rule, chunk=16, slab=64, block_n=block_n,
                device=cuda)
        torch.cuda.synchronize()
    series, _ = fleet.simulate_chunked_stream(
        lambda t0, L: (cs.trace.j_idx[t0:t0 + L], None), T, N, cs.tables,
        cs.params, cs.rule, chunk=16, slab=64, block_n=block_n, device=cuda)
    assert torch.isfinite(series["lam_norm"]).all()


@pytest.mark.parametrize("route", ["chunked", "tiled"])
def test_run_flags_an_association_out_of_range(cuda, route):
    """K1-topo / K2-topo under a RolloutRun: an assoc id out of range is
    held to [0, K) and flagged; the call returns, finish() raises, and a
    good call on the same run's operands still matches the plain
    version."""
    N, M, T, K = 500, 6, 16, 4
    g = np.random.default_rng(1)
    f = lambda *shape: torch.tensor(g.random(shape, dtype=np.float32),
                                    device=cuda)
    j = torch.tensor(g.integers(0, M, (T, N)), dtype=torch.int32,
                     device=cuda)
    assoc = torch.tensor(g.integers(0, K, (T, N)), dtype=torch.int32,
                         device=cuda)
    args = lambda: (j, f(N) * 0.1, torch.zeros(K, device=cuda),
                    torch.zeros(N, M, device=cuda), f(M), f(M), f(M) - 0.2,
                    f(N) + 0.05, torch.tensor(1.0, device=cuda), 0.4, 0.5)
    kern = ops.onalgo_chunked if route == "chunked" else ops.onalgo_tiled
    H_k = torch.full((K,), 0.02 * N / K, device=cuda)
    bad = assoc.clone()
    bad[9, 17] = K
    run = k.RolloutRun(torch.zeros(N, M, device=cuda), 0.4, 0.5, 0, T)
    kern(*args(), chunk=8, assoc=bad, H_k=H_k, run=run)
    with pytest.raises(ValueError, match=rf"assoc holds cloudlet ids "
                                         rf"outside \[0, {K}\)"):
        run.finish()
    torch.cuda.synchronize()
    run = k.RolloutRun(torch.zeros(N, M, device=cuda), 0.4, 0.5, 0, T)
    a = args()
    want = k.onalgo_chunked_plain(*a, assoc=assoc, H_k=H_k)
    got = kern(*a, chunk=8, assoc=assoc, H_k=H_k, run=run)
    run.finish()
    assert torch.equal(got[0], want[0])


# --------------------------------------------------------------------------
# the cell axis of K1 and K2 (the chunked sweep)

def _cells(G, N, M, T, seed, device, base=0, tables="cells"):
    """Random cell-axis operands over one shared trace.  ``tables``:
    "cells" — o' (G, N, M) and h' (G, 1, M) per cell, w (M,), what a
    preconditioned sweep passes; "shared" — (N, M) o and (M,) h shared by
    the cells (no preconditioner); "per device" — o' and h' (G, N, M), w
    (N, M).  counts0 holds ``base`` visits everywhere."""
    g = np.random.default_rng(seed)
    f = lambda *shape: torch.tensor(g.random(shape, dtype=np.float32),
                                    device=device)
    j = torch.tensor(g.integers(0, M, (T, N)), dtype=torch.int32,
                     device=device)
    if tables == "cells":
        o, h, w = f(G, N, M), f(G, 1, M), f(M) - 0.2
    elif tables == "shared":
        o, h, w = f(N, M), f(M), f(M) - 0.2
    else:
        o, h, w = f(G, N, M), f(G, N, M), f(N, M) - 0.2
    B = f(G, N) + 0.05
    H = torch.tensor(0.02 * N * (1 + g.random(G)), dtype=torch.float32,
                     device=device)
    a = (0.2 + g.random(G)).astype(np.float32)
    beta = g.choice([0.0, 0.5], G).astype(np.float32)
    lam0, mu0 = f(G, N) * 0.1, torch.full((G,), 0.05, device=device)

    def args():
        return (j, lam0.clone(), mu0.clone(),
                torch.full((G, N, M), float(base), device=device), o, h, w,
                B, H, a, beta)
    return args


def _single(kernel, a, g, M):
    """Cell g of cell-axis operands ``a`` through the single-cell wrapper."""
    j, lam0, mu0, counts0, o, h, w, B, H, ra, rb = a
    cell = lambda x: x[g] if x.ndim == 3 else x
    hg = cell(h).reshape(M) if h.ndim == 3 and h.shape[1] == 1 else cell(h)
    args = (j, lam0[g].clone(), mu0[g], counts0[g].clone(), cell(o), hg,
            cell(w), B[g], H[g], float(ra[g]), float(rb[g]))
    if kernel == "chunked":
        return k.onalgo_chunked_cuda(*args)
    return k.onalgo_tiled_cuda(*args, block_n=int(kernel[5:]))


def _cells_call(kernel, a):
    if kernel == "chunked":
        return ops.onalgo_chunked_cells(*a, chunk=a[0].shape[0])
    return ops.onalgo_tiled_cells(*a, chunk=a[0].shape[0],
                                  block_n=int(kernel[5:]))


@pytest.mark.parametrize("G,N,M,T,base,tables,route", [
    (1, 8, 37, 64, 0, "cells", "cells"),
    (3, 8, 37, 64, 0, "cells", "cells"),
    (64, 8, 37, 40, 0, "cells", "cells"),
    (3, 1, 37, 40, 0, "cells", "cells"),
    (3, 300, 41, 24, 0, "cells", "cells"),
    (3, 5000, 37, 16, 0, "cells", "cells"),
    (64, 5000, 37, 8, 0, "cells", "cells"),  # the plan splits the grid
    # per > the single call's block: lane groups of 128, two tiles a
    # virtual block (one o' ring where a group's tiles outnumber its stages)
    (3, 20_000, 37, 16, 0, "cells", "cells"),
    (5, 20_000, 37, 16, 0, "cells", "cells"),   # V = 5 on 4 lane groups
    (3, 8190, 37, 16, 0, "cells", "cells"),     # a ragged last virtual block
    (12, 1000, 37, 16, 0, "cells", "cells"),    # two cells in one pass
    # every cell whole in one block: a block barrier for the grid sync
    (140, 8, 37, 24, 0, "cells", "cells"),      # two cells a block
    (132, 40, 37, 24, 0, "cells", "cells"),     # a cell two virtual blocks
    (3, 300, 37, 24, 0, "shared", "cells"),
    (3, 300, 37, 24, 0, "per device", "per-cell"),
    (3, 300, 37, 16, 65_535 - 15, "cells", "per-cell"),  # past uint16
])
@pytest.mark.parametrize("kernel", ["chunked", "tiled8", "tiled256"])
def test_cells_kernel_matches_single_calls(cuda, G, N, M, T, base, tables,
                                           route, kernel):
    """The cell-axis K1 / K2 against G single-cell calls of K1 / K2, bit for
    bit in every output, twice bit for bit, and its first and last cells
    against the plain version (decisions and counts exactly, duals within
    rtol=1e-5, atol=1e-6).  Launch counts: each launch of a cell-axis
    kernel counts one (K1: one a group of the plan; K2: one a call), and
    where a cell goes alone to K1's / K2's own route (per-device h / w,
    counts past the uint16 limit) each cell counts one onalgo_chunked /
    onalgo_tiled call; no other count moves.  K1's plan: the cell-axis
    kernel, in groups where the grid does not fit one launch, or one cell
    a launch on K1's own route."""
    args = _cells(G, N, M, T, G * N + M + base, cuda, base, tables)
    runs = []
    for _ in range(2):
        before = ops.launch_counts()
        a = args()
        got = _cells_call(kernel, a)
        torch.cuda.synchronize()
        after = ops.launch_counts()
        if kernel == "chunked":
            plan = k.onalgo_chunked_cells_cuda.plan
            want = ({"onalgo_chunked_cells": len(plan.groups)}
                    if route == "cells" else {"onalgo_chunked": G})
        else:
            want = ({"onalgo_tiled": G} if tables == "per device"
                    else {"onalgo_tiled_cells": 1})
        assert {n: after[n] - before[n] for n in after
                if after[n] != before[n]} == want
        assert got[3] is a[1] and got[5] is a[3]  # lam / counts in place
        runs.append(got)
    for x, y in zip(*runs):
        assert torch.equal(x, y)
    if kernel == "chunked":
        assert plan.route == route
        if (G, N) == (64, 5000):
            assert len(plan.groups) > 1
        elif route == "cells":
            assert len(plan.groups) == 1
    a = args()
    for g in range(G):
        single = _single(kernel, a, g, M)
        for x, y in zip(runs[0], single):
            assert torch.equal(x[g], y), g
    for g in {0, G - 1}:
        a = args()
        cell = lambda x: x[g:g + 1]
        want = k.onalgo_cells_plain(
            a[0], cell(a[1]), cell(a[2]), cell(a[3]),
            *(cell(x) if x.ndim == 3 else x for x in a[4:7]), cell(a[7]),
            cell(a[8]), a[9][g:g + 1], a[10][g:g + 1])
        assert torch.equal(runs[0][0][g], want[0][0])
        assert torch.equal(runs[0][5][g], want[5][0])
        for i in (1, 2, 3, 4):
            torch.testing.assert_close(runs[0][i][g], want[i][0], rtol=RTOL,
                                       atol=ATOL)


def test_cells_plan_matches_the_card(cuda):
    """cells_plan's shared-memory model is the kernel's layout
    (``onalgo_cells_smem``) for every (width, lane groups, stages), and
    the grid of phase 9c (ii) (16 cells of N=8192, M=37) is one launch of
    8 lane groups of 64 threads, two passes a slot."""
    for per, M, gw, P, S, V, o_dev in (
            (32, 37, 32, 1, 1, 1, True), (64, 37, 64, 8, 1, 16, True),
            (64, 37, 64, 4, 3, 16, True), (160, 37, 128, 4, 2, 5, True),
            (64, 41, 64, 2, 1, 7, False), (96, 73, 96, 5, 2, 13, True)):
        assert k.cells_smem(per, M, gw, P, S, V, o_dev) == \
            k._lib().onalgo_cells_smem(per, M, gw, P, S, V, int(o_dev))
    sms, optin = k._device_limits(torch.cuda.current_device())
    plan = k.cells_plan(16, 8192, 37, 512, 0, optin, sms, 1, 16)
    assert plan.route == "cells" and len(plan.groups) == 1, plan
    assert (plan.group_width, plan.lane_groups, plan.passes) == (64, 8, 2), \
        plan


def test_chunked_sweep_on_the_card_matches_cpu(cuda):
    """sweep_simulate(engine="chunked") on the card: one call of the
    cell-axis K1 (K2 with block_n) for the whole grid, series equal to the
    CPU sweep's at the cross-engine bar (decisions and counts exactly)."""
    from repro_torch.scenarios import (Scenario, compile_scenario,
                                       product_grid, sweep_simulate)
    sc = Scenario("stationary", T=120, N=8, seed=11)
    c = compile_scenario(sc, device="cpu")
    for block_n, name in ((None, "onalgo_chunked_cells"),
                          (4, "onalgo_tiled_cells")):
        grids = [product_grid(8, a_values=(0.2, 0.5), beta_values=(0.5,),
                              B_values=(0.04, 0.08), H_values=(sc.H,),
                              device=d) for d in ("cpu", cuda)]
        want, wf = sweep_simulate(c.trace, c.tables, grids[0],
                                  engine="chunked", chunk=8, block_n=block_n,
                                  enforce_slot_capacity=True, device="cpu")
        before = ops.launch_counts()
        got, gf = sweep_simulate(c.trace, c.tables, grids[1],
                                 engine="chunked", chunk=8, block_n=block_n,
                                 enforce_slot_capacity=True, device=cuda)
        after = ops.launch_counts()
        assert after[name] == before[name] + 1
        assert sum(after.values()) == sum(before.values()) + 1
        for key in want:
            if key in ("offloads", "admits", "tasks"):
                assert torch.equal(got[key].cpu(), want[key]), key
            else:
                torch.testing.assert_close(got[key].cpu(), want[key],
                                           rtol=2e-5, atol=1e-5)
        assert torch.equal(gf.rho.counts.cpu(), wf.rho.counts)


def test_rho_divides_like_the_cpu(cuda):
    """The empirical rho on the card equals the CPU's bit for bit: counts
    over t by a true division (CUDA divides by a host scalar as a product
    with its reciprocal, 1 ulp off in places, which the slot loop's
    thresholds turn into flipped decisions over a long horizon)."""
    from repro_torch.core.state_space import RhoEstimator
    g = np.random.default_rng(0)
    counts = torch.tensor(g.integers(0, 4000, (64, 73)), dtype=torch.float32)
    for t in (3, 7, 49, 1999, 4000):
        want = RhoEstimator(counts=counts, t=t).rho
        got = RhoEstimator(counts=counts.to(cuda), t=t).rho
        assert torch.equal(got.cpu(), want), t


def test_scenario_scan_on_the_card_matches_cpu(cuda):
    """run_scenario's scan engine on the card (K3 once a slot) against the
    CPU's scan with K3's plain version over 2000 slots: decisions, admits
    and task counts exactly, the rest at the cross-engine bar."""
    from repro_torch.core.onalgo import StepRule
    from repro_torch.scenarios import Scenario, compile_scenario, run_scenario
    sc = Scenario("stationary", T=2000, N=8, seed=0)
    rule = StepRule.inv_sqrt(0.5)
    want, _, _ = run_scenario(compile_scenario(sc, device="cpu"), rule=rule,
                              engine="scan", use_kernel=True, device="cpu")
    got, _, _ = run_scenario(compile_scenario(sc, device=cuda), rule=rule,
                             engine="scan", device=cuda)
    for key in want:
        if key in ("offloads", "admits", "tasks"):
            assert torch.equal(got[key].cpu(), want[key]), key
        else:
            torch.testing.assert_close(got[key].cpu(), want[key], rtol=2e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("S", [256, 16384])
def test_ssd_chunk_kernel_at_the_gain_head_shape(cuda, S):
    """K4 at the SSD gain head's shape: one sequence of the pool's S
    images in chunks of 128, 2 heads of 16 channels, 1 group of 8 states
    (gain/model.py::SeqGainConfig)."""
    args = _ssd_inputs((1, S // 128, 128, 2, 16, 8), 1, cuda, S)
    want = sc.ssd_chunk_plain(*args)
    before = sc.ssd_chunk_cuda.launches
    got = ops.ssd_chunk(*args)
    torch.cuda.synchronize()
    assert sc.ssd_chunk_cuda.launches == before + 1
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **sc.TOLERANCE)


def _gain_problem(S):
    from repro_torch.gain import oracle_pool, synthetic_gain_problem
    probs, gains = synthetic_gain_problem(S=S, seed=0)
    return probs, gains, oracle_pool(probs, gains)


def test_ridge_gain_tables_on_the_card_match_cpu(cuda):
    """ModelGain(ridge) resolves on the card to the CPU's tables, snapped
    and not: the features and the dot are elementwise ops in one order."""
    from repro_torch.gain import ModelGain, fit_ridge_gain
    probs, gains, pool = _gain_problem(16384)
    sim = SimConfig(num_devices=8, T=16)
    for quantize in (True, False):
        cpu = ModelGain(fit_ridge_gain(probs, gains, device="cpu"), probs,
                        quantize=quantize).tables(pool, sim, device="cpu")
        card = ModelGain(fit_ridge_gain(probs, gains, device=cuda), probs,
                         quantize=quantize).tables(pool, sim, device=cuda)
        assert torch.equal(card.phi_hat.cpu(), cpu.phi_hat), quantize
        assert torch.equal(card.sigma.cpu(), cpu.sigma)


def _gateway_pair(cuda, N=4096, T=8):
    from repro_torch.serve.compile import compile_service_streaming
    from repro_torch.serve.gateway import GatewayCore
    from repro_torch.workload import ServiceLoadGen
    sim = SimConfig(num_devices=N, T=T, B_n=0.06, H=0.5 * N * 441e6, seed=0)
    out = []
    for dev in ("cpu", cuda):
        st = compile_service_streaming(sim, synthetic_pool(), device=dev)
        out.append((GatewayCore.for_service(st), ServiceLoadGen(st)))
    return out


def test_gateway_tick_on_the_card_matches_cpu(cuda):
    """Gateway ticks on the card (K3 once a tick) against the CPU's
    (plain route): the waves equal, decisions exactly, duals at the
    kernels' bar."""
    (cpu, lg_cpu), (card, lg_card) = _gateway_pair(cuda)
    card.warmup()
    for t in range(8):
        a, b = lg_cpu.wave(t), lg_card.wave(t)
        for key in ("idx", "o", "h", "w"):
            assert np.array_equal(getattr(a, key), getattr(b, key))
        want = cpu.tick(a.idx, a.o, a.h, a.w)
        before = k.onalgo_duals_cuda.launches
        got = card.tick(b.idx, b.o, b.h, b.w)
        assert k.onalgo_duals_cuda.launches == before + 1
        assert all(np.array_equal(x, y) for x, y in zip(got, want)), t
    torch.testing.assert_close(card.state.lam.cpu(), cpu.state.lam,
                               rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(card.state.mu.cpu(), cpu.state.mu,
                               rtol=RTOL, atol=ATOL)


def test_tick_async_returns_before_the_decisions(cuda):
    """tick_async enqueues and returns: behind a long sleep kernel its
    decisions' event has not fired; resolve waits on that event only."""
    (_, _), (card, lg) = _gateway_pair(cuda)
    card.warmup()
    wv = lg.wave(0)
    torch.cuda._sleep(int(2e8))  # a few hundred ms of device time
    pending = card.tick_async(wv.idx, wv.o, wv.h, wv.w)
    assert not pending.done()
    off, adm = pending.resolve()
    assert pending.done() and off.shape == adm.shape == wv.idx.shape


def test_gain_sources_on_every_engine_of_the_card(cuda):
    """simulate_service takes every gain source on the card's engines:
    scan, K1, K2, K1-topo and K2-topo (a hotspot of 4 cloudlets) and
    streamed; None, the names, TableGain and OverlayGain give the same
    metrics exactly, ModelGain(ridge) and ModelGain(seq) (the SSD head, K4
    in its resolution) run."""
    from repro_torch.gain import (ModelGain, OverlayGain, SeqGainConfig,
                                  SeqGainModel, TableGain, fit_ridge_gain)
    from repro_torch.gain.model import init_seq_params
    from repro_torch.topology import Topology
    probs, gains, pool = _gain_problem(1024)
    N = 256
    sim = SimConfig(num_devices=N, T=64, B_n=0.06, H=0.25 * N * 441e6,
                    seed=2)
    cfg = SeqGainConfig(feat_dim=probs.shape[1] + 4)
    seq = SeqGainModel(cfg, init_seq_params(torch.Generator().manual_seed(0),
                                            cfg, device=cuda),
                       torch.full((probs.shape[1],), 0.02, device=cuda))
    trivial = ["table", "overlay", TableGain(), OverlayGain()]
    models = [ModelGain(fit_ridge_gain(probs, gains, device=cuda), probs),
              ModelGain(seq, probs)]
    topo = Topology.hotspot(4, N, sim.H, device=cuda)
    engines = [dict(engine="scan"), dict(engine="scan", topology=topo),
               dict(engine="chunked", chunk=16),
               dict(engine="chunked", chunk=16, block_n=64),
               dict(engine="chunked", chunk=16, topology=topo),
               dict(engine="chunked", chunk=16, block_n=64, topology=topo),
               dict(engine="chunked", chunk=16, materialize=False, slab=32)]
    for kw in engines:
        base = simulate_service(sim, pool, device=cuda, **kw)
        for src in trivial:
            assert simulate_service(sim, pool, gain_source=src, device=cuda,
                                    **kw) == base, (kw, src)
        before = sc.ssd_chunk_cuda.launches
        for src in models:
            m = simulate_service(sim, pool, gain_source=src, device=cuda,
                                 **kw)
            assert 0.0 < m["accuracy"] <= 1.0 and m["tasks"] > 0
        assert sc.ssd_chunk_cuda.launches == before + 1


def test_capacity_loads_repeat_on_the_card(cuda):
    """The slot loop's per-cloudlet loads on the card are the same bits
    every call (ROADMAP C10: ``index_add_`` summed them with float
    atomics), and agree with the CPU's at the duals' bar."""
    from repro_torch.core.onalgo import capacity_loads
    N, M, K = 100000, 73, 1024
    g = torch.Generator().manual_seed(0)
    y = (torch.rand(N, M, generator=g) < 0.5).float()
    rho = torch.rand(N, M, generator=g)
    h = torch.rand(M, generator=g)
    assoc = torch.randint(0, K, (N,), generator=g)
    want = capacity_loads(y, rho, h, assoc, K)
    args = [x.to(cuda) for x in (y, rho, h, assoc)]
    outs = [capacity_loads(*args, K) for _ in range(20)]
    assert all(torch.equal(o, outs[0]) for o in outs)
    torch.testing.assert_close(outs[0].cpu(), want, rtol=RTOL, atol=ATOL)


@pytest.fixture
def nccl_world(cuda):
    """A world of one over NCCL and its 1-D mesh over "data"; the process
    group is destroyed after the test."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import default_mesh, world_of_one
    if not world_of_one(cuda):
        pytest.fail("a process group already existed")
    try:
        yield default_mesh("data", cuda)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("materialize", [True, False])
def test_sharded_service_on_the_card_matches_scan(nccl_world, materialize):
    """simulate_service(engine="sharded") on a world of one over NCCL: the
    metrics of the scan engine at the cross-engine bar, one all-reduce a
    slot (issued and counted though the world is one), the slot / slab
    loop under sync debug mode "error"."""
    from repro_torch.core import collectives, fleet
    sim = SimConfig(num_devices=2000, T=96, B_n=0.06,
                    H=0.1 * 2000 * 441e6, seed=3)
    pool = synthetic_pool()
    want = simulate_service(sim, pool, device="cuda")
    collectives.reset_collective_counts()
    fleet.SLAB_LOOP_SYNC_DEBUG = "error"
    try:
        got = simulate_service(sim, pool, engine="sharded", mesh=nccl_world,
                               materialize=materialize, slab=32,
                               device="cuda")
    finally:
        fleet.SLAB_LOOP_SYNC_DEBUG = None
    assert collectives.collective_counts()["all_reduce"] == sim.T
    assert want["mu_final"] > 0
    for key, w in want.items():
        assert abs(got[key] - w) <= 2e-5 * abs(w) + 1e-5, (key, got[key], w)


def test_mesh_gateway_on_the_card_matches_unsharded(nccl_world):
    """GatewayCore(mesh=...) on a world of one: the unsharded core's
    decisions and lam bit for bit, K3 once a tick, one all-reduce and one
    all-gather a tick."""
    from repro_torch.core import collectives
    from repro_torch.serve.compile import compile_service_streaming
    from repro_torch.serve.gateway import GatewayCore
    from repro_torch.workload import ServiceLoadGen
    sim = SimConfig(num_devices=300, T=64, B_n=0.06, H=0.1 * 300 * 441e6,
                    seed=3)
    st = compile_service_streaming(sim, synthetic_pool(), device="cuda")
    ref = GatewayCore.for_service(st)
    core = GatewayCore.for_service(st, mesh=nccl_world)
    for wv in ServiceLoadGen(st).waves():
        want = ref.tick(wv.idx, wv.o, wv.h, wv.w)
        before = k.onalgo_duals_cuda.launches
        collectives.reset_collective_counts()
        got = core.tick(wv.idx, wv.o, wv.h, wv.w)
        assert k.onalgo_duals_cuda.launches == before + 1
        assert collectives.collective_counts() == {"all_reduce": 1,
                                                   "all_gather": 1}
        assert all(np.array_equal(a, b) for a, b in zip(got, want)), wv.t
    assert torch.equal(core.state.lam, ref.state.lam)
    assert torch.equal(core.state.mu, ref.state.mu)


def test_mesh_on_another_device_type_raises(nccl_world):
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.core import fleet
    from repro_torch.serve.compile import compile_service
    cpu_mesh = DeviceMesh("cpu", torch.arange(1), mesh_dim_names=("data",),
                          _init_backend=False)
    cs = compile_service(SimConfig(num_devices=8, T=16), synthetic_pool(),
                         device="cuda")
    with pytest.raises(ValueError, match="mesh is on 'cpu'"):
        fleet.simulate_sharded(*cs.simulate_args(), cs.rule, cpu_mesh,
                               device="cuda")


# --------------------------------------------------------------------------
# the model zoo: K5 / K6 inside reduced models at each configuration's own
# head grouping and head size (G = 8, 7, 4, 2, 1; D = 128, 64), K4 in
# Jamba's Mamba layers, the MoE forms on the card

ZOO = ["yi-9b", "command-r-35b", "deepseek-67b", "internvl2-1b",
       "olmoe-1b-7b", "jamba-v0.1-52b", "arctic-480b", "seamless-m4t-medium"]


def _zoo_cfg(arch):
    """reduced() with the published heads, KV heads and head size (Jamba
    at one pattern instance)."""
    import dataclasses
    from repro_torch.configs import get_config
    full = get_config(arch)
    cfg = dataclasses.replace(full.reduced(), num_heads=full.num_heads,
                              num_kv_heads=full.num_kv_heads,
                              head_dim=full.head_dim)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, num_layers=cfg.pattern_period)
    return cfg


def _zoo_batch(cfg, device, src=40):
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 20),
                                     generator=g, dtype=torch.int32)}
    if cfg.family == "vlm":
        batch["prefix_embeds"] = 0.02 * torch.randn(
            (2, cfg.frontend_tokens, cfg.d_model), generator=g)
    if cfg.family == "encdec":
        batch["src_embeds"] = 0.1 * torch.randn((2, src, cfg.d_model),
                                                generator=g)
    return {k: v.to(device) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ZOO)
def test_zoo_kernel_routes_match_cpu(cuda, arch):
    """Each new architecture reduced, float32, with its own head layout:
    prefill + three decode steps on the card with use_kernel (K6 in every
    attention layer's step and an enc-dec's cross-attention step, K5 in
    its encoder and prefill cross-attention, K4 in Jamba's Mamba layers
    at prefill) against the CPU's plain versions, same weights and
    tokens; launch counts as the routes say."""
    import copy
    from repro_torch.models.api import ModelAPI
    cfg = _zoo_cfg(arch)
    api = ModelAPI(cfg)
    params, _ = api.init(torch.Generator().manual_seed(0))

    def run(p, batch):
        prompt = {k: (v[:, :16] if k == "tokens" else v)
                  for k, v in batch.items()}
        logits, state = api.prefill_step(p, prompt, 32, use_kernel=True)
        outs = [logits]
        for i in range(16, 19):
            logits, state = api.decode_step(
                p, batch["tokens"][:, i:i + 1], state, use_kernel=True)
            outs.append(logits)
        return torch.cat(outs, 1)

    want = run(params, _zoo_batch(cfg, "cpu"))
    ops.reset_launch_counts()
    got = run(copy.deepcopy(params).to(cuda), _zoo_batch(cfg, cuda))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    attn = sum(cfg.block_kind(i) == "attn" for i in range(cfg.num_layers))
    ssm = cfg.num_layers - attn
    if cfg.family == "encdec":
        expect = (cfg.enc_layers + cfg.num_layers, 2 * 3 * cfg.num_layers, 0)
    else:
        expect = (0, 3 * attn, ssm)
    assert (counts["flash_attention"], counts["decode_attention"],
            counts["ssd_chunk"]) == expect
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl", ["capacity", "dropless"])
def test_moe_decode_step_waits_for_nothing(cuda, impl):
    """A reduced olmoe decode step on the card (either MoE form, K6 in its
    attention) makes no host sync that torch's sync debug mode sees: the
    dropless form reads no group size back."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.api import ModelAPI
    cfg = dataclasses.replace(get_config("olmoe-1b-7b").reduced(),
                              moe_impl=impl)
    api = ModelAPI(cfg)
    params, _ = api.init(torch.Generator(device=cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (3, 9), device=cuda,
                         dtype=torch.int32)
    _, state = api.prefill_step(params, {"tokens": toks[:, :8]}, 16,
                                use_kernel=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, _ = api.decode_step(params, toks[:, 8:], state,
                                    use_kernel=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(logits).all())


def test_dropless_grouped_prefill_matches_cpu(cuda):
    """A reduced olmoe in the dropless form, prefill of 2 x 80 tokens (more
    than DENSE_TOKENS: the grouped form) and two steps (the dense form)
    on the card against the CPU, same weights and tokens."""
    import copy
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.api import ModelAPI
    cfg = dataclasses.replace(get_config("olmoe-1b-7b").reduced(),
                              moe_impl="dropless")
    assert 2 * 80 > moe.DENSE_TOKENS
    api = ModelAPI(cfg)
    params, _ = api.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 82),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)

    def run(p, t):
        logits, state = api.prefill_step(p, {"tokens": t[:, :80]}, 96,
                                         use_kernel=True)
        outs = [logits]
        for i in (80, 81):
            logits, state = api.decode_step(p, t[:, i:i + 1], state,
                                            use_kernel=True)
            outs.append(logits)
        return torch.cat(outs, 1)

    want = run(params, toks)
    got = run(copy.deepcopy(params).to(cuda), toks.to(cuda))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# training on the card: the kernel route's grad guard, a train step against
# the CPU's, a checkpoint from the card restored on the CPU

def test_kernel_routes_refuse_inputs_that_need_grad(cuda):
    """No hand-written kernel has a backward: with grad mode on, a CUDA
    input that requires grad raises (no fallback to the plain version);
    under no_grad, or with inputs that need none, the kernel runs."""
    g = torch.Generator(device=cuda).manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g, device=cuda)
    q, kk, v = r(1, 128, 2, 64), r(1, 128, 2, 64), r(1, 128, 2, 64)
    x, dt = r(1, 2, 64, 2, 16), r(1, 2, 64, 2).abs() * 0.1
    A, Bm, Cm = -r(2).abs(), r(1, 2, 64, 1, 8), r(1, 2, 64, 1, 8)
    calls = {
        "flash_attention": lambda t: ops.flash_attention(t, kk, v),
        "decode_attention": lambda t: ops.decode_attention(
            t[:, :1], kk, v, 100),
        "ssd_chunk": lambda t: ops.ssd_chunk(t, dt, A, Bm, Cm)}
    for name, call in calls.items():
        t = (x if name == "ssd_chunk" else q).clone().requires_grad_(True)
        ops.reset_launch_counts()
        with pytest.raises(RuntimeError, match="no backward"):
            call(t)
        assert ops.launch_counts()[name] == 0, name
        with torch.no_grad():
            call(t)
        call(t.detach())
        assert ops.launch_counts()[name] == 2, name


def _train_case(arch, device, steps=3):
    """``steps`` AdamW steps of a reduced config from the same CPU-drawn
    weights and numpy tokens on ``device``: (losses, state, CPU copies of
    the parameters after each step, each step's MoE top-k sets)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.api import ModelAPI
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import TrainState, make_train_step
    cfg = get_config(arch).reduced()
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, num_layers=cfg.pattern_period)
    api = ModelAPI(cfg)
    params, _ = api.init(torch.Generator().manual_seed(0))
    spec = opt.OptimizerSpec(name="adamw", lr=1e-3)
    state = TrainState.create(params.to(device), spec)
    step = make_train_step(api.loss, spec,
                           opt.cosine_schedule(1e-3, 5, 100))
    rng = np.random.default_rng(0)
    losses, snaps, routed, real_route = [], [], [], moe.route

    def recording_route(*a):
        out = real_route(*a)
        routed[-1].append(torch.sort(out[2], dim=-1).values.cpu())
        return out

    moe.route = recording_route
    try:
        for _ in range(steps):
            batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 33)
                                            ).astype(np.int32)}
            if cfg.family == "encdec":
                batch["src_embeds"] = (0.1 * rng.standard_normal(
                    (2, 16, cfg.d_model))).astype(np.float32)
            routed.append([])
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            snaps.append({k: v.detach().cpu().clone()
                          for k, v in state.params.named_parameters()})
    finally:
        moe.route = real_route
    return losses, state, snaps, routed


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-370m", "olmoe-1b-7b",
                                  "jamba-v0.1-52b", "seamless-m4t-medium"])
def test_train_steps_on_the_card_match_cpu(cuda, arch):
    """Three AdamW steps of the reduced config on the card and on the CPU
    from the same weights and tokens: losses at rtol 1e-4, every
    parameter within 0.05 of the summed learning rates (an element moves
    by about lr a step, and Adam's per-element normalization turns
    rounding in near-zero gradients into a visible part of it: chip_smoke
    13a's TRAIN_PARAM_BAR); no kernel launched (the loss takes the plain
    routes).  An MoE router near a tie may pick another expert on the
    card: the losses are held up to the first step whose routing differs,
    the parameters up to the step before it."""
    want, _, cpu_snaps, cpu_routes = _train_case(arch, "cpu")
    ops.reset_launch_counts()
    got, _, card_snaps, card_routes = _train_case(arch, cuda)
    assert sum(ops.launch_counts().values()) == 0
    flip = next((i for i, (a, b) in enumerate(zip(card_routes, cpu_routes))
                 if any(not torch.equal(u, v) for u, v in zip(a, b))),
                len(want))
    np.testing.assert_allclose(got[:flip + 1], want[:flip + 1], rtol=1e-4)
    # cosine_schedule(1e-3, 5, 100) over the steps before the flip
    lr_sum = sum((2e-4, 4e-4, 6e-4)[:flip])
    if flip:
        for name, p in cpu_snaps[flip - 1].items():
            torch.testing.assert_close(card_snaps[flip - 1][name], p,
                                       rtol=0, atol=0.05 * lr_sum, msg=name)


def test_checkpoint_moves_from_card_to_cpu(cuda, tmp_path):
    """A train state saved on the card restores into a CPU state of the
    same structure (and back), leaf for leaf."""
    from repro_torch.train import checkpoint as ckpt
    card_state = _train_case("olmo-1b", cuda, steps=1)[1]
    cpu_like = _train_case("olmo-1b", "cpu", steps=1)[1]
    ckpt.save(str(tmp_path), 1, card_state)
    on_cpu = ckpt.restore(str(tmp_path), 1, cpu_like)
    back = ckpt.restore(str(tmp_path), 1, card_state)
    want = ckpt.host_leaves(card_state)
    for tree in (on_cpu, back):
        got = ckpt.host_leaves(tree)
        assert sorted(got) == sorted(want)
        for k, (a, d) in want.items():
            assert got[k][1] == d
            np.testing.assert_array_equal(got[k][0], a, err_msg=k)
    assert next(on_cpu.params.parameters()).device.type == "cpu"
    assert next(back.params.parameters()).device.type == "cuda"


def _olmo_step(api, cfg, mode, B, S, device):
    """(arguments, call) of the reduced olmo-1b's real step of ``mode``
    on ``device`` (chip_smoke 14b's steps, at a reduced size)."""
    from repro_torch.data.lm_data import LMStreamSpec, token_stream
    from repro_torch.models import lm as LM
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import TrainState, make_train_step
    gen = torch.Generator(device=device).manual_seed(0)
    params, _ = api.init(gen)
    if mode == "train":
        spec = opt.OptimizerSpec(name=cfg.optimizer)
        state = TrainState.create(params, spec)
        step = make_train_step(api.loss, spec,
                               opt.cosine_schedule(3e-4, 100, 10000))
        batch = {"tokens": torch.from_numpy(next(token_stream(LMStreamSpec(
            vocab_size=cfg.vocab_size, batch=B, seq_len=S)))["tokens"]).to(
                device)}
        return (state, batch), lambda: step(state, batch)
    if mode == "prefill":
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                         generator=gen, device=device,
                                         dtype=torch.int32)}
        return (params, batch), lambda: api.prefill_step(params, batch, S)
    token = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                          device=device, dtype=torch.int32)
    st = {"cache": LM.init_cache(cfg, B, S, device=device), "length": S - 1}
    return (params, token, st), lambda: api.decode_step(params, token, st)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_dry_run_record_on_a_mesh_of_one_equals_the_card_step(nccl_world,
                                                              mode):
    """The dry run's record of the reduced olmo-1b on a (1, 1) cuda mesh
    (a world of one over NCCL; a checkpointed forward recomputed on the
    autograd engine's device thread) against the real step on the card:
    FlopCounterMode's FLOPs, the argument bytes and a CostTrace's peak
    temporaries equal; no collective."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.analysis.hlo_stats import CostTrace, cost_summary
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.api import ModelAPI
    from repro_torch.parallel.compile_mode import compile_options
    import dataclasses
    cfg = dataclasses.replace(get_config("olmo-1b").reduced(), remat="full")
    B, S = {"train": (4, 32), "prefill": (2, 64), "decode": (4, 64)}[mode]
    rec = dryrun.run_cell("olmo-1b", ShapeConfig(mode, S, B, mode),
                          mesh=make_test_mesh((1, 1), device="cuda"),
                          cfg_fn=lambda c: cfg, verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    args, call = _olmo_step(ModelAPI(cfg), cfg, mode, B, S, "cuda")
    grad = torch.enable_grad() if mode == "train" else torch.no_grad()
    with grad, compile_options(flash_block=2048):
        with FlopCounterMode(display=False) as fc:
            call()
        trace = CostTrace()
        with trace:
            out = call()
    real = cost_summary(trace, args, out)
    assert rec["flops"] == fc.get_total_flops() > 0
    for k in ("argument_size_in_bytes", "temp_size_in_bytes"):
        assert rec[k] == real[k], k
    assert rec["collectives"] == {"total_wire_bytes": 0}


def test_pipeline_apply_over_nccl_equals_the_stages(nccl_world):
    """pipeline_apply on a (1,) "pod" mesh over NCCL (S = 1): the stage
    applied to each microbatch in turn, bit for bit; one all-reduce."""
    from repro_torch.core import collectives
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel.pipeline import pipeline_apply
    gen = torch.Generator(device="cuda").manual_seed(1)
    Ws = torch.randn((1, 64, 64), generator=gen, device="cuda") * 0.1
    xs = torch.randn((8, 4, 64), generator=gen, device="cuda")
    stage = lambda w, h: torch.relu(h @ w)
    collectives.reset_collective_counts()
    got = pipeline_apply(stage, Ws, xs,
                         make_test_mesh((1,), ("pod",), device="cuda"))
    assert torch.equal(got, torch.stack([stage(Ws[0], x) for x in xs]))
    assert collectives.collective_counts()["all_reduce"] == 1


def test_dry_run_moe_cell_shows_all_to_alls_on_a_cuda_mesh(cuda, tmp_path):
    """A fake (2, 2) cuda mesh (its own process: a fake world cannot live
    beside another) traces the reduced olmoe-1b-7b's decode cell: ok, and
    the experts' redistributions are all-to-alls (a cpu mesh gathers
    instead)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    code = (
        "import json, sys\n"
        "from repro_torch.launch import dryrun\n"
        "from repro_torch.launch.mesh import fake_world, make_test_mesh\n"
        "fake_world(4, 'cuda')\n"
        "rec = dryrun.run_cell('olmoe-1b-7b', 'decode_32k', mesh="
        "make_test_mesh((2, 2), device='cuda'), cfg_fn=lambda c: "
        "c.reduced(), verbose=False)\n"
        "json.dump(rec, open(sys.argv[1], 'w'), default=str)\n")
    out = tmp_path / "rec.json"
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    done = subprocess.run([sys.executable, "-c", code, str(out)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    rec = json.loads(out.read_text())
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["collectives"].get("all-to-all", {}).get("count", 0) > 0


def test_dry_run_cli_traces_mamba2_train_4k_on_a_cuda_mesh(cuda, tmp_path):
    """python -m repro_torch.launch.dryrun --arch mamba2-370m --shape
    train_4k --device cuda: the tied 50280-row table, which the 16-way
    model axis does not split, takes its two gradients' sum in the
    backward on the fake 16x16 cuda mesh; the cell comes out ok with its
    roofline's three terms."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-370m", "--shape", "train_4k", "--device", "cuda", "--out",
         str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=300, cwd=root)
    assert done.returncode == 0, (done.stdout + done.stderr)[-3000:]
    rec = json.loads((tmp_path / "mamba2_370m_train_4k_single.json")
                     .read_text())
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == "16x16" and rec["n_chips"] == 256
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s",
                                    "dominant"}
    assert all(rec["roofline"][k] > 0
               for k in ("compute_s", "memory_s", "collective_s"))
    assert "1 ok, 0 skipped, 0 errors of 1 cells" in done.stdout
