"""The port's attention against the JAX package: K5's and K6's plain
versions against the Pallas kernels run in interpret mode (as
tests/test_kernels.py runs them), the model's plain flash / decode
attention and the attention sublayer against the reference's functions,
and the device dispatch of ``kernels.ops.flash_attention`` /
``decode_attention``.

Bars are ``flash_attention.TOLERANCE``: the reference's kernel bar in
float32 (rtol = atol = 2e-5, tests/test_kernels.py:20-22), and in bfloat16
two bf16 ulps (rtol 1.6e-2, atol 1e-4), since both sides compute in
float32 and round once; a test here shows that bar rejects a kernel that
drops one key in sixteen.  The CUDA kernels are held against these plain
versions on the card (tests/test_torch_cuda.py and chip_smoke.py).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as ref_attn
from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import attention as attn


def _tol(dtype):
    return fa.TOLERANCE[getattr(torch, dtype)]


def _inputs(seed, dtype, *shapes):
    """Normal draws from numpy, rounded to ``dtype``: (jax arrays, torch
    tensors) holding the same values."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if dtype == "bfloat16":
        xs = [x.astype(ml_dtypes.bfloat16) for x in xs]
        tx = [torch.tensor(x.astype(np.float32)).to(torch.bfloat16)
              for x in xs]
    else:
        tx = [torch.tensor(x) for x in xs]
    return [jnp.asarray(x) for x in xs], tx


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))


@pytest.mark.parametrize("B,S,Hq,Hkv,D", [
    (1, 128, 4, 4, 64),     # MHA
    (2, 256, 8, 2, 64),     # GQA 4:1
    (1, 256, 4, 1, 128),    # MQA, 128 head dim
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas(B, S, Hq, Hkv, D, causal, dtype):
    (q, k, v), (tq, tk, tv) = _inputs(B + S + Hkv, dtype, (B, S, Hq, D),
                                      (B, S, Hkv, D), (B, S, Hkv, D))
    want = flash_attention_pallas(q, k, v, causal=causal, interpret=True)
    got = fa.flash_attention_plain(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("B,S,Hq,Hkv,D", [
    (2, 256, 8, 2, 64),
    (1, 512, 4, 4, 128),
    (4, 128, 2, 1, 32),
])
@pytest.mark.parametrize("frac", [0.25, 0.8, 1.0])
def test_decode_plain_matches_pallas(B, S, Hq, Hkv, D, frac):
    n = max(1, int(S * frac))
    (q, kc, vc), (tq, tk, tv) = _inputs(S + n, "float32", (B, 1, Hq, D),
                                        (B, S, Hkv, D), (B, S, Hkv, D))
    want = decode_attention_pallas(q, kc, vc, n, interpret=True)
    _close(da.decode_attention_plain(tq, tk, tv, n), want, "float32")


def test_decode_plain_matches_pallas_bf16():
    (q, kc, vc), (tq, tk, tv) = _inputs(3, "bfloat16", (2, 1, 4, 64),
                                        (2, 128, 2, 64), (2, 128, 2, 64))
    want = decode_attention_pallas(q, kc, vc, 100, interpret=True)
    got = da.decode_attention_plain(tq, tk, tv, 100)
    assert got.dtype == torch.bfloat16
    _close(got, want, "bfloat16")


@pytest.mark.parametrize("B,Hkv,n", [
    (16, 16, 24),     # the serving loop's call: one split, one launch
    (16, 16, 4096),   # olmo-1b's heads fill the card without a split
    (16, 4, 4096),    # GQA: about one block per SM
    (1, 2, 1025), (2, 1, 100_000), (3, 7, 1)])
def test_split_plan_covers_keys(B, Hkv, n):
    plan = da.split_plan(B, Hkv, n)
    assert plan[0][0] == 0 and plan[-1][1] == n
    assert all(a < b for a, b in plan)
    assert all(b == a2 for (_, b), (a2, _) in zip(plan, plan[1:]))
    assert all((b - a) % 64 == 0 for a, b in plan[:-1])
    if len(plan) > 1:
        assert min(b - a for a, b in plan[:-1]) >= 256
        assert B * Hkv * len(plan) <= 132
    if (B, Hkv, n) == (16, 16, 24):
        assert len(plan) == 1
    if (B, Hkv, n) == (16, 4, 4096):
        assert B * Hkv * len(plan) >= 132 - B * Hkv  # every SM but < 1 split


@pytest.mark.parametrize("G", [1, 4, 7])
@pytest.mark.parametrize("n", [555, 1000])
def test_split_decode_matches_pallas(G, n):
    """K6's split form in plain torch: each of split_plan's key ranges in
    one softmax pass, merged by merge_partials_plain, against the Pallas
    kernel (interpret mode) within the float32 bar, at ragged cache_len."""
    B, S, Hkv, D = 2, 1024, 1, 32
    (q, kc, vc), (tq, tk, tv) = _inputs(G + n, "float32", (B, 1, G * Hkv, D),
                                        (B, S, Hkv, D), (B, S, Hkv, D))
    plan = da.split_plan(B, Hkv, n)
    assert len(plan) > 1
    parts = [da.decode_partials_plain(tq, tk, tv, a, b) for a, b in plan]
    m, l, acc = (torch.stack([p[i] for p in parts], dim=-1 if i < 2 else -2)
                 for i in range(3))
    got = da.merge_partials_plain(m, l, acc).reshape(tq.shape)
    want = decode_attention_pallas(q, kc, vc, n, interpret=True)
    _close(got, want, "float32")


def _attend_dropping(q, k, v, causal, n, group):
    """Attention in float32 in one dense softmax (another summation order
    than the plain versions' blocks) over the keys below n, at or before
    the query when causal, leaving out keys j with j % 16 == group (none
    when group is None); in q's dtype.  Dropping a group models a fault
    in a kernel whose 16 groups of lanes stride over the keys."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    s = torch.einsum("bqhgd,bkhd->bhgqk",
                     q.float().reshape(B, Sq, Hkv, Hq // Hkv, D),
                     k.float()) * D ** -0.5
    kp = torch.arange(Skv)
    keep = (kp < n) & (kp % 16 != (-1 if group is None else group))
    keep = keep[None, :] & (kp[None, :] <= torch.arange(Sq)[:, None]
                            if causal else True)
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


@pytest.mark.parametrize("kernel", ["flash", "decode"])
def test_bf16_bar_rejects_a_dropped_key_group(kernel):
    """The bf16 bar passes another float32 summation order rounded once
    to bf16, and rejects the same computation with one key in sixteen
    left out."""
    if kernel == "flash":
        _, (q, k, v) = _inputs(10, "bfloat16", (1, 256, 4, 64),
                               (1, 256, 4, 64), (1, 256, 4, 64))
        want, n, causal = fa.flash_attention_plain(q, k, v), 256, True
    else:
        _, (q, k, v) = _inputs(11, "bfloat16", (2, 1, 4, 128),
                               (2, 512, 4, 128), (2, 512, 4, 128))
        want, n, causal = da.decode_attention_plain(q, k, v, 500), 500, False
    tol = fa.TOLERANCE[torch.bfloat16]
    sound = _attend_dropping(q, k, v, causal, n, None)
    torch.testing.assert_close(sound.float(), want.float(), **tol)
    faulty = _attend_dropping(q, k, v, causal, n, 5)
    assert not torch.allclose(faulty.float(), want.float(), **tol)


@pytest.mark.parametrize("q_offset,Sq,Skv,block", [
    (0, 64, 64, 16), (40, 24, 64, 16), (0, 32, 96, 32), (16, 48, 64, 64)])
def test_model_flash_matches_reference(q_offset, Sq, Skv, block):
    """The plain flash the model runs for prefill with a cache (q_offset,
    fully masked rows guarded) against the reference's."""
    (q, k, v), (tq, tk, tv) = _inputs(Sq + Skv, "float32", (2, Sq, 4, 32),
                                      (2, Skv, 2, 32), (2, Skv, 2, 32))
    want = ref_attn.flash_attention(q, k, v, causal=True, q_offset=q_offset,
                                    block_kv=block)
    got = attn.flash_attention(tq, tk, tv, causal=True, q_offset=q_offset,
                               block_kv=block)
    assert np.isfinite(got.numpy()).all()
    _close(got, want, "float32")
    _close(attn.attention_ref(tq, tk, tv, causal=True, q_offset=q_offset),
           ref_attn.attention_ref(q, k, v, causal=True, q_offset=q_offset),
           "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_decode_matches_reference(dtype):
    (q, kc, vc), (tq, tk, tv) = _inputs(5, dtype, (3, 1, 4, 32),
                                        (3, 40, 2, 32), (3, 40, 2, 32))
    for n in (1, 17, 40):
        _close(attn.decode_attention(tq, tk, tv, n),
               ref_attn.decode_attention(q, kc, vc, n), dtype)


def _block_params(seed):
    cfg, rcfg = (get_config("olmo-1b").reduced(),
                 ref_get_config("olmo-1b").reduced())
    D, Hq, Hkv, Dh = 128, 4, 2, 32
    shapes = {"wq": (D, Hq, Dh), "wk": (D, Hkv, Dh), "wv": (D, Hkv, Dh),
              "wo": (Hq, Dh, D)}
    rng = np.random.default_rng(seed)
    p = {n: (rng.standard_normal(s) * 0.1).astype(np.float32)
         for n, s in shapes.items()}
    return (cfg, {n: torch.tensor(x) for n, x in p.items()},
            rcfg, {n: jnp.asarray(x) for n, x in p.items()})


@pytest.mark.parametrize("use_kernel", [False, True])
def test_attention_block_matches_reference(use_kernel):
    """No cache (the forward: K5's route with use_kernel), prefill into a
    cache, then two decode steps (K6's route), against the reference's
    sublayer (whose decode writes the cache with a one-hot mask; the
    port's in-place write gives the same caches)."""
    cfg, tp, rcfg, rp = _block_params(0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 128)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16), (2, 16))
    out, (k, v) = attn.attention_block(cfg, tp, torch.tensor(x),
                                       positions=torch.tensor(pos),
                                       use_kernel=use_kernel)
    r_out, (rk, rv) = ref_attn.attention_block(rcfg, rp, jnp.asarray(x),
                                               positions=jnp.asarray(pos))
    for g, w in ((out, r_out), (k, rk), (v, rv)):
        _close(g, w, "float32")

    S_max, P = 20, 12
    cache = (torch.zeros((2, S_max, 2, 32)), torch.zeros((2, S_max, 2, 32)))
    r_cache = (jnp.zeros((2, S_max, 2, 32)), jnp.zeros((2, S_max, 2, 32)))
    steps = [(x[:, :P], P)] + [(x[:, P + i:P + i + 1], P + i + 1)
                               for i in range(2)]
    for xs, n in steps:
        p_ = np.broadcast_to(np.arange(n - xs.shape[1], n), xs.shape[:2])
        out, cache = attn.attention_block(
            cfg, tp, torch.tensor(xs), positions=torch.tensor(p_),
            kv_cache=cache, cache_len=n, use_kernel=use_kernel)
        r_out, r_cache = ref_attn.attention_block(
            rcfg, rp, jnp.asarray(xs), positions=jnp.asarray(p_),
            kv_cache=r_cache, cache_len=jnp.int32(n))
        _close(out, r_out, "float32")
        for g, w in zip(cache, r_cache):
            _close(g, w, "float32")


@pytest.fixture
def no_kernels(monkeypatch):
    """Every CUDA wrapper raises: proves the CPU route never calls one."""
    def boom(*a, **kw):
        raise AssertionError("CUDA kernel called for CPU tensors")
    monkeypatch.setattr(fa, "flash_attention_cuda", boom)
    monkeypatch.setattr(da, "decode_attention_cuda", boom)


def test_ops_route_cpu_tensors_to_plain(no_kernels):
    _, (q, k, v) = _inputs(7, "float32", (1, 64, 4, 32), (1, 64, 2, 32),
                           (1, 64, 2, 32))
    for causal in (True, False):
        assert torch.equal(ops.flash_attention(q, k, v, causal=causal),
                           fa.flash_attention_plain(q, k, v, causal=causal))
    assert torch.equal(ops.decode_attention(q[:, :1], k, v, 30),
                       da.decode_attention_plain(q[:, :1], k, v, 30))


def test_contract_errors():
    _, (q, k, v) = _inputs(8, "float32", (1, 192, 4, 32), (1, 192, 2, 32),
                           (1, 192, 2, 32))
    with pytest.raises(ValueError, match="multiple of its block"):
        ops.flash_attention(q, k, v)  # 192 % 128
    with pytest.raises(ValueError, match="multiple of its block"):
        ops.decode_attention(q[:, :1], k, v, 10)
    with pytest.raises(ValueError, match=">= 1"):
        ops.decode_attention(q[:, :1], k[:, :128], v[:, :128], 0)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        ops.flash_attention(q[:, :128, :3], k[:, :128], v[:, :128])
    with pytest.raises(ValueError, match="no kernel route"):
        ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def test_cuda_wrappers_reject_cpu_tensors():
    """The kernel wrappers never run CPU tensors (and need no build to
    say so)."""
    _, (q, k, v) = _inputs(9, "float32", (1, 64, 4, 32), (1, 64, 2, 32),
                           (1, 64, 2, 32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensor"):
        da.decode_attention_cuda(q[:, :1], k, v, 5)
    assert fa.flash_attention_cuda.launches == 0
    assert da.decode_attention_cuda.launches == 0
