"""The port's OnAlgo kernels' plain versions against the JAX package's
oracles (``repro.kernels.ref``) and, at a tiny size, its Pallas kernels in
interpret mode; plus the device dispatch of ``repro_torch.kernels.ops``.

Bars are the reference's own (tests/test_kernels.py::TestOnAlgoKernel):
decisions and visit counts exactly equal, duals and the mu / lam-norm
series within rtol=1e-5, atol=1e-6.  The CUDA kernels themselves are held
against these plain versions on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.onalgo_step import (onalgo_chunked_pallas,
                                       onalgo_tiled_pallas)
from repro_torch.kernels import ops
from repro_torch.kernels import onalgo_step as k
from repro_torch.kernels import ssd_chunk as sc

RTOL, ATOL = 1e-5, 1e-6


def _duals_inputs(N, M, seed, per_device_o=False):
    rng = np.random.default_rng(seed)
    rho = rng.dirichlet(np.ones(M), N).astype(np.float32)
    return dict(
        lam=rng.random(N, dtype=np.float32),
        mu=np.float32(0.3),
        rho=rho,
        o=rng.random((N, M) if per_device_o else M, dtype=np.float32),
        h=rng.random(M, dtype=np.float32),
        w=(rng.random(M, dtype=np.float32) - np.float32(0.2)),
        B=(rng.random(N, dtype=np.float32) + np.float32(0.05)))


@pytest.mark.parametrize("N,M,per_device_o", [
    (4, 7, False), (100, 37, False), (256, 37, False), (1000, 97, False),
    (100, 37, True)])
def test_duals_plain_matches_oracle(N, M, per_device_o):
    x = _duals_inputs(N, M, N + M, per_device_o)
    order = ("lam", "mu", "rho", "o", "h", "w", "B")
    g_ref, l_ref = ref.onalgo_duals_ref(*(jnp.asarray(x[n]) for n in order))
    g, l = k.onalgo_duals_plain(*(torch.as_tensor(x[n]) for n in order))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=RTOL,
                               atol=ATOL)
    assert float(l) == pytest.approx(float(l_ref), rel=RTOL)


def _rollout_inputs(N, M, T, seed, slot_values=False, per_device_o=False):
    rng = np.random.default_rng(seed)
    x = dict(
        j=rng.integers(0, M, (T, N)).astype(np.int32),
        lam0=(rng.random(N, dtype=np.float32) * np.float32(0.1)),
        mu0=np.float32(0.05),
        counts0=np.zeros((N, M), np.float32),
        o=rng.random((N, M) if per_device_o else M, dtype=np.float32),
        h=rng.random(M, dtype=np.float32),
        w=(rng.random(M, dtype=np.float32) - np.float32(0.2)),
        B=(rng.random(N, dtype=np.float32) + np.float32(0.05)),
        H=np.float32(2.0))
    if slot_values:
        x["sv"] = (rng.random((T, N), dtype=np.float32),
                   rng.random((T, N), dtype=np.float32),
                   rng.random((T, N), dtype=np.float32) - np.float32(0.1))
    return x


_ORDER = ("j", "lam0", "mu0", "counts0", "o", "h", "w", "B", "H")


def _run_ref(x, t0=0, a=0.4, beta=0.5):
    sv = None if "sv" not in x else tuple(jnp.asarray(s) for s in x["sv"])
    out = ref.onalgo_chunked_ref(*(jnp.asarray(x[n]) for n in _ORDER), a,
                                 beta, t0=t0, slot_values=sv)
    return [np.asarray(o) for o in out]


def _run_port(fn, x, t0=0, a=0.4, beta=0.5, **kw):
    sv = None if "sv" not in x else tuple(torch.as_tensor(s)
                                          for s in x["sv"])
    out = fn(*(torch.as_tensor(x[n]) for n in _ORDER), a, beta, t0=t0,
             slot_values=sv, **kw)
    return [o.numpy() for o in out]


def _assert_rollouts_equal(got, want):
    off, mu_seq, lnorm, lam, mu, counts = got
    np.testing.assert_array_equal(off, want[0])
    np.testing.assert_array_equal(counts, want[5])
    for g, w in ((mu_seq, want[1]), (lnorm, want[2]), (lam, want[3])):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    assert float(mu) == pytest.approx(float(want[4]), rel=RTOL, abs=ATOL)
    assert off.dtype == np.bool_ and counts.dtype == np.float32


@pytest.mark.parametrize("N,M,T,slot_values,t0,per_device_o", [
    (20, 16, 64, False, 0, False),
    (24, 37, 96, False, 0, False),
    (50, 23, 40, False, 0, False),
    (8, 16, 64, False, 0, False),
    (20, 16, 64, True, 0, False),
    (24, 37, 96, True, 17, False),
    (50, 23, 40, False, 5, True),
])
def test_chunked_plain_matches_oracle(N, M, T, slot_values, t0,
                                      per_device_o):
    """K1/K2's plain version == the sequential JAX oracle (TestOnAlgoKernel
    shapes), with and without the overlay streams, resuming at t0 > 0."""
    x = _rollout_inputs(N, M, T, N + M + T, slot_values, per_device_o)
    want = _run_ref(x, t0=t0)
    got = _run_port(k.onalgo_chunked_plain, x, t0=t0)
    _assert_rollouts_equal(got, want)
    if slot_values:  # null slots never offload, whatever the raw gain says
        assert not got[0][x["j"] == 0].any()


@pytest.mark.parametrize("tiled", [False, True])
def test_plain_matches_pallas_interpret(tiled):
    """Tiny case against the Pallas kernels themselves (interpret mode)."""
    N, M, T, chunk = 12, 9, 16, 8
    x = _rollout_inputs(N, M, T, 3, slot_values=True)
    sv = tuple(jnp.asarray(s) for s in x["sv"])
    args = [jnp.asarray(x[n]) for n in _ORDER]
    kw = dict(chunk=chunk, t0=8, slot_values=sv, interpret=True)
    out = (onalgo_tiled_pallas(*args, 0.4, 0.5, block_n=8, **kw) if tiled
           else onalgo_chunked_pallas(*args, 0.4, 0.5, **kw))
    want = [np.asarray(o) for o in out]
    got = _run_port(k.onalgo_chunked_plain, x, t0=8)
    _assert_rollouts_equal(got, want)


def test_row_sum_order():
    """row_sum is the kernels' lane-strided + halving order, bit for bit."""
    rng = np.random.default_rng(7)
    for M in (1, 31, 32, 73, 97):
        x = rng.random((5, M), dtype=np.float32) * 1e3
        lanes = np.zeros((5, 32), np.float32)
        for m in range(M):
            lanes[:, m % 32] += x[:, m]
        width = 32
        while width > 1:
            width //= 2
            lanes = lanes[:, :width] + lanes[:, width:2 * width]
        np.testing.assert_array_equal(k.row_sum(torch.from_numpy(x)).numpy(),
                                      lanes[:, 0])


def test_step_tables():
    a_seq, inv_t = k.step_tables(0.5, 0.5, 3, 4)
    t = np.arange(4, 8, dtype=np.float32)
    np.testing.assert_array_equal(a_seq, np.float32(0.5) / np.sqrt(t))
    np.testing.assert_array_equal(inv_t, np.float32(1) / t)
    assert a_seq.dtype == inv_t.dtype == np.float32


@pytest.fixture
def no_kernels(monkeypatch):
    """Every CUDA wrapper raises: proves the CPU route never calls one."""
    def boom(*a, **kw):
        raise AssertionError("CUDA kernel called for CPU tensors")
    for name in ("onalgo_duals_cuda", "onalgo_chunked_cuda",
                 "onalgo_tiled_cuda", "onalgo_chunked_topo_cuda",
                 "onalgo_tiled_topo_cuda"):
        monkeypatch.setattr(k, name, boom)


def test_ops_route_cpu_tensors_to_plain(no_kernels):
    x = _rollout_inputs(10, 7, 16, 1, slot_values=True)
    want = _run_port(k.onalgo_chunked_plain, x, t0=2)
    for fn, kw in ((ops.onalgo_chunked, {}), (ops.onalgo_tiled,
                                             dict(block_n=4))):
        got = _run_port(fn, x, t0=2, chunk=8, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    d = _duals_inputs(10, 7, 2)
    order = ("lam", "mu", "rho", "o", "h", "w", "B")
    g1 = ops.onalgo_duals(*(torch.as_tensor(d[n]) for n in order))
    g2 = k.onalgo_duals_plain(*(torch.as_tensor(d[n]) for n in order))
    np.testing.assert_array_equal(g1[0].numpy(), g2[0].numpy())
    assert float(g1[1]) == float(g2[1])


def test_ops_contract_errors():
    x = _rollout_inputs(6, 5, 12, 4)
    args = [torch.as_tensor(x[n]) for n in _ORDER] + [0.4, 0.5]
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.onalgo_chunked(*args, chunk=8)
    with pytest.raises(ValueError, match="assoc and H_k must be passed "
                       "together"):
        ops.onalgo_tiled(*args, chunk=4, assoc=torch.zeros(6, dtype=int))
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a
            for a in args]
    with pytest.raises(ValueError, match="no kernel route"):
        ops.onalgo_chunked(*meta, chunk=4)


def test_cuda_wrappers_reject_cpu_tensors():
    """The kernel wrappers never run CPU tensors (and need no build to
    say so)."""
    x = _rollout_inputs(6, 5, 8, 5)
    args = [torch.as_tensor(x[n]) for n in _ORDER] + [0.4, 0.5]
    for fn in (k.onalgo_chunked_cuda, k.onalgo_tiled_cuda):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(*args)
    d = _duals_inputs(6, 5, 6)
    with pytest.raises(ValueError, match="CUDA tensor"):
        k.onalgo_duals_cuda(*(torch.as_tensor(d[n]) for n in (
            "lam", "mu", "rho", "o", "h", "w", "B")))
    assert all(fn.launches == 0 for fn in k.KERNELS.values())


# An H100's limits, as the wrappers query them: SMs, opt-in shared memory
# per block, co-resident blocks of the streaming K1 kernel and its warps.
_SMS, _OPTIN, _STREAM_BLOCKS, _STREAM_WARPS = 132, 232448, 528, 16


@pytest.mark.parametrize("N,M,T,counts_max,K,kw,route,why", [
    (100_000, 73, 512, 0, 0, {}, "resident", "shared memory"),
    (100_000, 73, 16, 64, 0, {}, "resident", "shared memory"),
    (100_000, 73, 512, 0, 1024, {}, "resident", "shared memory"),
    (100_000, 73, 512, 0, 4096, {}, "resident", "shared memory"),
    (20, 16, 64, 0, 0, dict(o_per_device=False), "resident", "shared"),
    (300_000, 73, 512, 0, 0, {}, "streaming", "> 232448"),
    (100_000, 73, 512, 65_535 - 511, 0, {}, "streaming", "65535"),
    (100_000, 73, 16, 65_535 - 16, 4, {}, "resident", "shared memory"),
    (100_000, 73, 512, None, 0, {}, "streaming", "integers"),
    (100_000, 73, 512, 0, 20_000, {}, "streaming", "> 232448"),
    (100_000, 73, 512, 0, 0, dict(hw_per_device=True), "streaming",
     "per-device"),
    (100_000, 73, 16, 65_535 - 15, 0, {}, "streaming", "65536 > 65535"),
    (0, 73, 512, 0, 0, {}, "streaming", "no devices"),
])
def test_chunked_plan_routes_by_size(N, M, T, counts_max, K, kw, route, why):
    """K1 / K1-topo's route is a pure function of the call's sizes: the
    service width stays resident (K up to 4096 included); a fleet beyond
    the card's shared memory, uint16 counts that could overflow and a
    K-row too large beside the counts stream; the grid never exceeds the
    co-resident count passed in."""
    plan = k.chunked_plan(N, M, T, counts_max, K, _OPTIN, _SMS,
                          _STREAM_BLOCKS, _STREAM_WARPS, **kw)
    assert plan.route == route and why in plan.why
    if route == "resident":
        assert plan.grid <= _SMS and plan.per % 32 == 0
        assert plan.grid * plan.per >= N > (plan.grid - 1) * plan.per
        assert plan.smem == k.resident_smem(
            plan.per, M, K, plan.warps, kw.get("o_per_device", True))
        assert plan.smem <= _OPTIN and plan.warps in (1, 2, 4)
    else:
        assert plan.grid <= _STREAM_BLOCKS and plan.warps == _STREAM_WARPS


def test_resident_smem_layout():
    """At the service width (768 devices a block, M=73) the counts take
    768 rows of 74 uint16 and the two o tiles 2 x 128 rows of 73 floats;
    K1-topo adds its float64 K-row and the group sums."""
    scalar = k.resident_smem(768, 73, 0, 4, True)
    assert scalar == 16 + 768 * 74 * 2 + 2 * 768 * 4 + 3 * 76 * 4 \
        + 2 * 128 * 73 * 4 + 80
    assert k.resident_smem(768, 73, 1024, 4, True) == \
        scalar + 1024 * 8 + 2 * 128 * 12
    assert k.resident_smem(768, 73, 0, 4, False) == scalar - 2 * 128 * 73 * 4


@pytest.mark.parametrize("N,M,T,counts_max,block_n,o_dev,plan", [
    # the service width: uint16 rows of 74, 256 threads, a tile a unit,
    # one block per SM
    (100_000, 73, 512, 0, 256, True, ("uint16", 74, 256, 1, 1, 132)),
    # counts that could pass 65535 (or are not integers) stay float32 in
    # odd rows of 73: two ring stages then fit only 192 threads, so a
    # tile of 256 takes two passes
    (100_000, 73, 512, 65_535 - 511, 256, True,
     ("float32", 73, 192, 1, 2, 132)),
    (100_000, 73, 512, None, 256, True, ("float32", 73, 192, 1, 2, 132)),
    (100_000, 73, 512, 65_535 - 512, 256, True,
     ("uint16", 74, 256, 1, 1, 132)),
    # small tiles share a block: 32 of 8, 7 of 33 (threads rounded to 32)
    (100_000, 73, 512, 0, 8, True, ("uint16", 74, 256, 32, 1, 132)),
    (777, 16, 64, 0, 33, True, ("uint16", 18, 256, 7, 1, 4)),
    # a tile wider than the block: one tile a unit, in passes
    (5000, 73, 16, 0, 1000, True, ("uint16", 74, 256, 1, 4, 5)),
    (50, 23, 40, 3, 256, False, ("uint16", 26, 256, 1, 1, 1)),
    (0, 73, 5, 0, 256, True, ("uint16", 74, 256, 1, 0, 1)),
])
def test_tiled_plan_routes_by_values(N, M, T, counts_max, block_n, o_dev,
                                     plan):
    """K2's count route is uint16 exactly when max(counts0) + T <= 65535
    (else float32), its rows padded so 32 rows fall in 32 banks (Mp = 2 mod
    4 uint16, odd float32); a block is the widest 32-multiple up to 256
    threads whose two ring stages fit the card's opt-in shared memory."""
    got = k.tiled_plan(N, M, T, counts_max, block_n, o_dev, _SMS, _OPTIN)
    assert (got.counts, got.stride, got.threads, got.unit_tiles,
            got.passes, got.grid) == plan
    esize = 2 if got.counts == "uint16" else 4
    assert got.smem == k.tiled_smem(got.threads, M, got.stride, esize,
                                    o_dev) <= _OPTIN
    if got.threads < k.TILED_THREADS:
        assert k.tiled_smem(got.threads + 32, M, got.stride, esize,
                            o_dev) > _OPTIN
    assert ("<=" in got.why) == (got.counts == "uint16")


def test_tiled_smem_layout():
    """At the service width a block holds two stages of 256 o rows of 73
    floats and 256 count rows of 74 uint16 (each with 16 bytes of lead),
    four mbarriers, the (h, w') pairs and 16 bytes a thread for the
    partials' reduction; with o shared, the o stages shrink to the
    48 bytes a thread of reduction scratch and o's (M,) row is added."""
    assert k.tiled_smem(256, 73, 74, 2, True) == (
        32 + 2 * (256 * 73 * 4 + 16) + 2 * (256 * 74 * 2 + 16) + 76 * 8
        + 16 * 256) == 230080
    assert k.tiled_smem(192, 73, 73, 4, True) == (
        32 + 2 * (192 * 73 * 4 + 16) + 2 * (192 * 73 * 4 + 16) + 76 * 8
        + 16 * 192)
    assert k.tiled_smem(256, 73, 74, 2, False) == (
        32 + 2 * (48 * 256 + 16) + 2 * (256 * 74 * 2 + 16) + 76 * 8
        + 76 * 4 + 16 * 256)


def test_tiled_plan_rejects_rows_too_wide():
    with pytest.raises(ValueError, match="shared memory"):
        k.tiled_plan(100, 2000, 8, 0, 256, True, _SMS, _OPTIN)


def test_duals_smem_layout():
    """A K3 block of 128 devices at the main path's M=73 with o per
    device: the mbarrier, two tiles of whole rows (plus 16 bytes of slack
    each) and the h and w tables, each rounded up to 16 bytes: three
    blocks an SM."""
    assert k.duals_smem(128, 73, 73, True) == (
        16 + 2 * (128 * 73 * 4 + 16) + 2 * 304) == 75408
    assert k.duals_smem(32, 5000, 864, False) == (
        16 + 32 * 865 * 4 + 3 * 864 * 4)


@pytest.mark.parametrize("o_dev,last_whole", [(True, 880), (False, 1660)])
def test_duals_plan_takes_every_m(o_dev, last_whole):
    """K3 takes whole rows, as many as fit up to 128 a block, while 32 fit
    the card's opt-in (M <= 880 with o per device, 1660 with shared
    tables); beyond that 32 rows in chunks of a multiple of 32 columns, so
    no M is refused."""
    assert k.duals_plan(73, o_dev, _OPTIN) == (128, 73)
    assert k.duals_plan(last_whole, o_dev, _OPTIN) == (32, last_whole)
    for M in (1, 7, 73, 97, 300, last_whole, last_whole + 1, 5000, 10**6):
        rows, cols = k.duals_plan(M, o_dev, _OPTIN)
        assert k.duals_smem(rows, M, cols, o_dev) <= _OPTIN
        if cols == M:
            assert rows % 32 == 0 and (
                rows == k.DUALS_ROWS
                or k.duals_smem(rows + 32, M, M, o_dev) > _OPTIN)
        else:
            assert M > last_whole and rows == 32 and cols % 32 == 0
            assert k.duals_smem(32, M, cols + 32, o_dev) > _OPTIN


@pytest.mark.parametrize("BC,Q,h,g,p,n,heads,blocks", [
    (64, 128, 32, 1, 64, 128, 16, 128),    # mamba2-370m's (4, 2048) forward
    (64, 128, 32, 32, 64, 128, 1, 2048),   # the same with B/C head-expanded
    (16, 16, 32, 1, 64, 128, 4, 128),      # its serving wave
    (16, 33, 32, 1, 64, 128, 4, 128),      # a ragged 33-token prompt
    (1, 1, 2, 1, 16, 8, 1, 2),             # one position
])
def test_ssd_plan(BC, Q, h, g, p, n, heads, blocks):
    """K4's heads per block by its cost model: at the forward's shape 16
    heads share C B^T, in 128 blocks (one wave of 132 SMs, where 8 heads
    would take two); a head-expanded call has one head a group, so one a
    block."""
    plan = sc.ssd_plan(BC, Q, h, g, p, n, _SMS)
    assert (plan.heads, plan.blocks) == (heads, blocks)
    assert plan.smem == sc.ssd_smem(Q, p, n, heads) <= _OPTIN


def test_ssd_smem_layout():
    """A K4 block at the widest shape: B, C and two x slots of 64 columns
    as TMA boxes of 32 columns by 128 rows (4 + 4 + 2 * 2 boxes of 16
    KiB), dt / cs / decay of 16 heads, three mbarriers (24 bytes, rounded
    to 32) and 1024 bytes of alignment: within the card's opt-in for
    every shape K4 takes."""
    assert sc.ssd_smem(128, 64, 128, 16) == (
        12 * 128 * 128 + 3 * 16 * 128 * 4 + 32 + 1024) == 222240
    assert sc.ssd_smem(128, 128, 128, 16) == sc.ssd_smem(128, 64, 128, 16)
    assert sc.ssd_smem(16, 16, 8, 1) == 4 * 16 * 128 + 3 * 64 + 32 + 1024
    assert max(sc.ssd_smem(Q, p, n, sc.MAX_HEADS) for Q in (1, 17, 128)
               for p in sc.HEAD_DIMS for n in (4, 36, 128)) <= _OPTIN
