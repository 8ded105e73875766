"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and is marked ``requires_cuda``; each
decides inside the ``cuda`` fixture whether a card is present and skips
otherwise.  The file imports torch and the port only (the card's machine
has no JAX).  Run on the card:

    python -m pytest -q -m requires_cuda tests/test_torch_cuda.py

Bars: decisions and visit counts exactly equal; duals within rtol=1e-5,
atol=1e-6 (the kernels reproduce the plain versions' summation order, so
they are expected to be bit-identical); service metrics rel=2e-5.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import onalgo_step as k
from repro_torch.kernels import ops
from repro_torch.serve.simulator import (SimConfig, simulate_service,
                                         synthetic_pool)

pytestmark = pytest.mark.requires_cuda
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rollout(N, M, T, seed, device, slot_values, per_device_o):
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
                torch.zeros((N, M), device=device), *fixed)
    return args, sv


@pytest.mark.parametrize("N,M,T,slot_values,per_device_o,t0", [
    (20, 16, 64, False, False, 0),
    (50, 23, 40, True, True, 5),
    (1000, 97, 24, True, False, 64),
    (5000, 73, 16, False, True, 3),
])
@pytest.mark.parametrize("kernel", ["chunked", "tiled8", "tiled256"])
def test_rollout_kernel_matches_plain(cuda, N, M, T, slot_values,
                                      per_device_o, t0, kernel):
    args, sv = _rollout(N, M, T, N + M, cuda, slot_values, per_device_o)
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
    assert got[3] is a[1] and got[5] is a[3]  # lam / counts in place
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[5], want[5])
    for i in (1, 2, 3, 4):
        torch.testing.assert_close(got[i], want[i], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("N,M,per_device_o", [
    (4, 7, False), (1000, 97, False), (100_000, 73, True)])
def test_duals_kernel_matches_plain(cuda, N, M, per_device_o):
    g = np.random.default_rng(N)
    f = lambda *shape: torch.tensor(g.random(shape, dtype=np.float32),
                                    device=cuda)
    rho = f(N, M)
    rho = rho / rho.sum(dim=1, keepdim=True)
    args = (f(N), torch.tensor(0.3, device=cuda), rho,
            f(N, M) if per_device_o else f(M), f(M), f(M) - 0.2,
            f(N) + 0.05)
    g_want, l_want = k.onalgo_duals_plain(*args)
    g_got, l_got = ops.onalgo_duals(*args)
    torch.testing.assert_close(g_got, g_want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(l_got, l_want, rtol=RTOL, atol=0.0)


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
