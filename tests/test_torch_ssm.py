"""The port's Mamba2 path against the JAX package: K4's plain version
against the Pallas kernel (interpret mode) and its oracle, the chunked
SSD scan in both routes, the mamba mixer with its cache, and reduced
mamba2-370m through forward / loss / prefill + decode / the serve loop,
with the reference's weights carried across by
``interop.model_params_from``.

Bars: rtol = atol = 1e-4 for the SSD functions, the reference's own
(tests/test_kernels.py:103-106, tests/test_models.py:170-184) — the two
packages compute the same float32 function in other summation orders
(the chunk recurrence is a loop here, an associative scan there); 1e-4
on the loss (tests/test_kernels.py:117); the model's hidden states and
logits at 2e-5, as ``tests/test_torch_models.py`` holds olmo-1b.
"""

import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels import ref as ref_kernels
from repro.kernels.ssd_chunk import ssd_chunk_pallas
from repro.launch import serve as ref_serve
from repro.models import lm as ref_lm
from repro.models import ssm as ref_ssm
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_chunk as sc
from repro_torch.launch import serve as port_serve
from repro_torch.models import lm, ssm
from repro_torch.models.api import ModelAPI

SSD_TOL = dict(rtol=1e-4, atol=1e-4)
MODEL_TOL = dict(rtol=2e-5, atol=2e-5)

# torch's first float32 exp over a large CPU tensor, in a process that has
# loaded JAX, is now and then off by up to 1e-4 relative; every later call
# is exact to the ulp (ROADMAP.md C7).  One call here, before any test, so
# that no comparison below depends on which test a worker runs first.
torch.exp(torch.zeros(1 << 16))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def _ssd_inputs(rng, x_shape, b_shape):
    """x, dt, A, B, C as the reference's kernel test draws them (normal x,
    softplus(normal) * 0.5 steps, A = -exp(0.3 normal), B, C 0.5 normal),
    from a numpy generator."""
    h = x_shape[-2]
    x = rng.standard_normal(x_shape).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal(x_shape[:-1]))) * 0.5
          ).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    B = (rng.standard_normal(b_shape) * 0.5).astype(np.float32)
    C = (rng.standard_normal(b_shape) * 0.5).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("b,nc,Q,h,p,n", [
    (1, 2, 128, 2, 64, 32),
    (2, 1, 64, 4, 32, 128),
    (1, 4, 128, 8, 64, 16),
    (2, 2, 33, 4, 32, 16),  # a ragged chunk: a prompt of 33 tokens
])
def test_ssd_chunk_plain_matches_pallas(b, nc, Q, h, p, n):
    args = _ssd_inputs(np.random.default_rng(Q + n), (b, nc, Q, h, p),
                       (b, nc, Q, h, n))
    y, st = sc.ssd_chunk_plain(*map(torch.tensor, args))
    assert y.shape == (b, nc, Q, h, p) and st.shape == (b, nc, h, p, n)
    for want in (ssd_chunk_pallas(*map(jnp.asarray, args)),
                 ref_kernels.ssd_chunk_ref(*map(jnp.asarray, args))):
        _close(y, want[0], SSD_TOL)
        _close(st, want[1], SSD_TOL)
    # the dispatcher runs the plain version for CPU tensors
    before = sc.ssd_chunk_cuda.launches
    y2, st2 = ops.ssd_chunk(*map(torch.tensor, args))
    assert sc.ssd_chunk_cuda.launches == before
    assert torch.equal(y2, y) and torch.equal(st2, st)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_chunk_group_form_equals_expanded(g):
    """B and C at group granularity give exactly what their head-expanded
    copies (``jnp.repeat`` on the group axis) give."""
    b, nc, Q, h, p, n = 2, 2, 16, 4, 16, 8
    x, dt, A, B, C = _ssd_inputs(np.random.default_rng(g), (b, nc, Q, h, p),
                                 (b, nc, Q, g, n))
    rep = lambda a: torch.tensor(np.repeat(a, h // g, axis=3))
    t = torch.tensor
    got = sc.ssd_chunk_plain(t(x), t(dt), t(A), t(B), t(C))
    want = sc.ssd_chunk_plain(t(x), t(dt), t(A), rep(B), rep(C))
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    with pytest.raises(ValueError, match="must divide"):
        sc.ssd_chunk_plain(t(x), t(dt), t(A), t(B[..., :1, :]).expand(
            b, nc, Q, 3, n), t(C[..., :1, :]).expand(b, nc, Q, 3, n))


def _split(a, scheme):
    """An operand's hi and lo parts as float32 tensors.  "3xtf32" (K4's,
    csrc/sm90.cuh::split_tf32) and "tf32": hi = a rounded to tf32 (10
    mantissa bits, to nearest, ties away from zero), lo = a - hi truncated
    to tf32.  "bf16x3": hi = a rounded to bf16, lo = a - hi rounded to
    bf16 (the split K5 uses for its P)."""
    if scheme == "bf16x3":
        hi = a.bfloat16().float()
        return hi, (a - hi).bfloat16().float()
    bits = a.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    lo = ((a - hi).contiguous().view(torch.int32) & ~0x1FFF).view(
        torch.float32)
    return hi, lo


def _split_mm(a, b, scheme):
    """a @ b in float32 from split parts: three products (hi hi + hi lo +
    lo hi) for "3xtf32" and "bf16x3", one (hi hi) for "tf32".  Products
    of tf32 or bf16 values are exact in float32, so only the split and the
    float32 sums round."""
    ah, al = _split(a, scheme)
    bh, bl = _split(b, scheme)
    out = ah @ bh
    return out if scheme == "tf32" else out + ah @ bl + al @ bh


def _ssd_split(x, dt, A, B, C, scheme):
    """K4's arithmetic in torch on the CPU: S = C B^T once per group, y =
    (S o L) xbar and states = (xbar * decay)^T B (the decay moved onto
    xbar, so B is split once for all heads), every product through
    ``_split_mm``."""
    b, nc, Q, h, p = x.shape
    g, n = B.shape[3], B.shape[4]
    cs = torch.cumsum(dt * A, dim=2)
    xbar = x * dt[..., None]
    decay = torch.exp(cs[:, :, -1:, :] - cs)
    causal = torch.ones(Q, Q, dtype=torch.bool).tril()
    y = torch.empty_like(x)
    st = torch.empty((b, nc, h, p, n))
    for k in range(g):
        Bg = B[:, :, :, k].reshape(b * nc, Q, n)
        S = _split_mm(C[:, :, :, k].reshape(b * nc, Q, n),
                      Bg.transpose(1, 2), scheme)
        for hd in range(k * (h // g), (k + 1) * (h // g)):
            c = cs[:, :, :, hd].reshape(b * nc, Q)
            L = torch.exp(torch.where(causal, c[:, :, None] - c[:, None, :],
                                      float("-inf")))
            xb = xbar[:, :, :, hd].reshape(b * nc, Q, p)
            y[:, :, :, hd] = _split_mm(S * L, xb, scheme).reshape(
                b, nc, Q, p)
            xd = xb * decay[:, :, :, hd].reshape(b * nc, Q, 1)
            st[:, :, hd] = _split_mm(xd.transpose(1, 2), Bg,
                                     scheme).reshape(b, nc, p, n)
    return y, st


@pytest.mark.parametrize("b,nc,Q,h,p,n,g", [
    (2, 3, 128, 32, 64, 128, 1),  # mamba2-370m's forward, fewer chunks
    (1, 2, 128, 2, 64, 32, 2), (2, 1, 64, 4, 32, 128, 4),
    (1, 4, 128, 8, 64, 16, 8),    # the reference's kernel-test shapes
    (2, 2, 33, 4, 32, 16, 4),     # a ragged chunk
])
def test_ssd_split_arithmetic_holds_the_bar(b, nc, Q, h, p, n, g):
    """K4's 3xTF32 scheme, carried out in torch, holds K4's bar
    (``TOLERANCE``) against the plain version in float64."""
    args = [torch.tensor(a) for a in _ssd_inputs(
        np.random.default_rng(Q + n + g), (b, nc, Q, h, p), (b, nc, Q, g, n))]
    want = sc.ssd_chunk_plain(*(a.double() for a in args))
    for got, w in zip(_ssd_split(*args, "3xtf32"), want):
        torch.testing.assert_close(got, w.float(), **sc.TOLERANCE)


def _worst(scheme, b, nc, Q, h, p, n, g):
    """``scheme``'s worst |got - want| / (atol + rtol |want|) at K4's bar
    on y and on the states (over 1 misses the bar), against the plain
    version in float64."""
    args = [torch.tensor(a) for a in _ssd_inputs(
        np.random.default_rng(Q + n + g), (b, nc, Q, h, p), (b, nc, Q, g, n))]
    want = sc.ssd_chunk_plain(*(a.double() for a in args))
    tol = sc.TOLERANCE
    return [float(((a - w).abs() / (tol["atol"] + tol["rtol"] * w.abs()))
                  .max()) for a, w in zip(_ssd_split(*args, scheme), want)]


def test_ssd_single_product_fails_the_bar():
    """The control: tf32 alone (one product of the hi parts) misses the
    same bar at the forward's widths, so the bar sees the scheme."""
    assert min(_worst("tf32", 2, 3, 128, 32, 64, 128, 1)) > 1


def test_ssd_bf16_split_fails_the_bar():
    """The second control: bf16 hi + lo with the same three products (8
    mantissa bits a part) misses the bar on y at the full (4, 2048)
    forward's shape, where K4 runs (at the fewer chunks above it holds
    the bar, but barely): K4 splits into tf32 parts."""
    assert _worst("bf16x3", 4, 16, 128, 32, 64, 128, 1)[0] > 1


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_reference(use_kernel, with_h0):
    b, s, h, p, g, n = 2, 192, 4, 16, 2, 8
    rng = np.random.default_rng(9)
    args = _ssd_inputs(rng, (b, s, h, p), (b, s, g, n))
    h0 = (rng.standard_normal((b, h, p, n)) * 0.5).astype(np.float32) \
        if with_h0 else None
    y, hf = ssm.ssd_chunked(*map(torch.tensor, args), chunk=64,
                            h0=None if h0 is None else torch.tensor(h0),
                            use_kernel=use_kernel)
    yr, hr = ref_ssm.ssd_chunked(*map(jnp.asarray, args), chunk=64,
                                 h0=None if h0 is None else jnp.asarray(h0),
                                 use_kernel=use_kernel)
    _close(y, yr, SSD_TOL)
    _close(hf, hr, SSD_TOL)
    # ... and the per-token recurrence, in both packages
    yo, ho = ssm.ssd_ref(*map(torch.tensor, args),
                         h0=None if h0 is None else torch.tensor(h0))
    yro, hro = ref_ssm.ssd_ref(*map(jnp.asarray, args),
                               h0=None if h0 is None else jnp.asarray(h0))
    _close(yo, yro, SSD_TOL)
    _close(ho, hro, SSD_TOL)
    _close(y, yo, SSD_TOL)
    _close(hf, ho, SSD_TOL)


def test_ssd_chunked_bf16_route_mirrors_reference():
    """In bfloat16 the route without the kernel rounds x * dt, L, the
    scores, the decays and the carried state to bf16 where the reference
    does, and accumulates in float32.  The float32 values it rounds differ
    from the reference's in the last bit now and then (cumsum and
    recurrence orders), so about one element in a thousand sees one bf16
    rounding of an operand flipped: a change of 2**-8 of one term, under
    5e-4 here.  The bar, rtol 2**-8 and atol 1e-3, passes that; the same
    inputs computed without the bf16 roundings fail it."""
    b, s, h, p, g, n = 2, 256, 4, 16, 1, 8
    x, dt, A, B, C = _ssd_inputs(np.random.default_rng(5), (b, s, h, p),
                                 (b, s, g, n))
    bar = dict(rtol=2**-8, atol=1e-3)
    bf = lambda a: a.astype(ml_dtypes.bfloat16)
    t = torch.tensor
    y, hf = ssm.ssd_chunked(t(x).bfloat16(), t(dt), t(A), t(B).bfloat16(),
                            t(C).bfloat16(), chunk=64)
    yr, hr = ref_ssm.ssd_chunked(jnp.asarray(bf(x)), jnp.asarray(dt),
                                 jnp.asarray(A), jnp.asarray(bf(B)),
                                 jnp.asarray(bf(C)), chunk=64)
    assert y.dtype == torch.float32
    _close(y, yr, bar)
    _close(hf, hr, bar)
    y32, _ = ssm.ssd_chunked(t(x).bfloat16().float(), t(dt), t(A),
                             t(B).bfloat16().float(),
                             t(C).bfloat16().float(), chunk=64)
    assert not np.allclose(y32.numpy(), np.asarray(yr), **bar)


@pytest.fixture(scope="module")
def mamba():
    """Reduced mamba2-370m in both packages with the reference's weights."""
    rcfg = ref_get_config("mamba2-370m").reduced()
    cfg = get_config("mamba2-370m").reduced()
    rp, _ = ref_lm.init_lm(rcfg, jax.random.PRNGKey(0))
    rp = jax.tree_util.tree_map(np.asarray, rp)
    p = interop.model_params_from(rp, cfg, device="cpu")
    return rcfg, rp, cfg, p


def test_params_carry_ssm_leaves(mamba):
    rcfg, rp, cfg, p = mamba
    mixer = rp["blocks"]["sub0"]["mixer"]
    assert sorted(mixer) == ["A_log", "D_skip", "conv_w", "dt_bias",
                             "norm_scale", "w_in", "w_out"]
    for i, blk in enumerate(p["blocks"]):
        for name, w in mixer.items():
            got = blk["sub0"]["mixer"][name]
            assert tuple(got.shape) == w.shape[1:]
            np.testing.assert_array_equal(got.numpy(), w[i])
    # the analytic count leaves out the RMSNorm scales (two per layer
    # with the reduced config's FFN, one final) and D_skip, as the
    # reference's does
    extra = cfg.d_model * (2 * cfg.num_layers + 1) + \
        cfg.ssm_heads * cfg.num_layers
    assert cfg.param_count() == rcfg.param_count()
    assert sum(x.numel() for x in p.parameters()) == \
        cfg.param_count() + extra
    # the port's own init draws the same tree
    own, specs = ModelAPI(cfg).init(torch.Generator().manual_seed(0))
    assert sorted(own["blocks"][0]["sub0"]["mixer"].keys()) == sorted(mixer)
    assert specs["blocks"]["sub0"]["mixer"]["w_in"] == ("layers", "embed",
                                                        "mlp")
    assert sum(x.numel() for x in own.parameters()) == \
        cfg.param_count() + extra


def test_param_count_matches_reference():
    full, rfull = get_config("mamba2-370m"), ref_get_config("mamba2-370m")
    assert full.param_count() == rfull.param_count() == 368_176_128
    assert full.active_param_count() == rfull.active_param_count()
    assert full.reduced().param_count() == rfull.reduced().param_count()
    assert full.dtype == torch.bfloat16 and full.d_ff == 0
    assert (full.ssm_heads, full.d_inner) == (32, 2048)


def test_mamba_block_prefill_then_decode(mamba):
    """The mixer alone: a prefill of 20 tokens from an empty cache, then
    three one-token decode steps carrying the cache, against the
    reference's (both with its weights)."""
    rcfg, rp, cfg, p = mamba
    rmix = {k: jnp.asarray(v[0]) for k, v in
            rp["blocks"]["sub0"]["mixer"].items()}
    mix = p["blocks"][0]["sub0"]["mixer"]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    cache = ssm.init_ssm_cache(cfg, 2)
    rcache = ref_ssm.init_ssm_cache(rcfg, 2)
    out, cache = ssm.mamba_block(cfg, mix, torch.tensor(x), cache=cache)
    rout, rcache = ref_ssm.mamba_block(rcfg, rmix, jnp.asarray(x),
                                       cache=rcache)
    _close(out, rout, MODEL_TOL)
    for step in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        out, cache = ssm.mamba_block(cfg, mix, torch.tensor(xt), cache=cache)
        rout, rcache = ref_ssm.mamba_block(rcfg, rmix, jnp.asarray(xt),
                                           cache=rcache)
        _close(out, rout, MODEL_TOL)
        _close(cache["conv"], rcache["conv"], MODEL_TOL)
        _close(cache["ssm"], rcache["ssm"], MODEL_TOL)
    # no cache: the same prefill output, new cache built from zeros
    out0, _ = ssm.mamba_block(cfg, mix, torch.tensor(x))
    rout0, _ = ref_ssm.mamba_block(rcfg, rmix, jnp.asarray(x))
    _close(out0, rout0, MODEL_TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_and_loss_match_reference(mamba, use_kernel):
    """Reduced mamba2-370m: the forward over 33 tokens (a ragged chunk,
    Q = 33) and the loss over 33 (Q = 32), in both routes."""
    rcfg, rp, cfg, p = mamba
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (2, 33)).astype(np.int32)
    h, _, _ = lm.forward(cfg, p, torch.tensor(toks), use_kernel=use_kernel)
    rh, _, _ = ref_lm.forward(rcfg, rp, jnp.asarray(toks),
                              use_kernel=use_kernel)
    _close(h, rh, MODEL_TOL)
    loss, _ = lm.lm_loss(cfg, p, {"tokens": torch.tensor(toks)},
                         use_kernel=use_kernel)
    rloss, _ = ref_lm.lm_loss(rcfg, rp, {"tokens": jnp.asarray(toks)},
                              use_kernel=use_kernel)
    assert abs(float(loss) - float(rloss)) < 1e-4
    other, _ = lm.lm_loss(cfg, p, {"tokens": torch.tensor(toks)},
                          use_kernel=not use_kernel)
    assert abs(float(loss) - float(other)) < 1e-4


def test_prefill_decode_greedy_matches_reference(mamba):
    """ModelAPI.prefill_step(use_kernel=True) over a 20-token prompt
    (Q = 20) then four greedy decode steps through the stacked cache,
    against the reference's lm.prefill(use_kernel=True) / decode_step:
    equal tokens, logits within the model bar."""
    rcfg, rp, cfg, p = mamba
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                             (3, 20)).astype(np.int32)
    api = ModelAPI(cfg)
    logits, state = api.prefill_step(p, {"tokens": torch.tensor(toks)},
                                     max_len=25, use_kernel=True)
    rcache = ref_lm.init_cache(rcfg, 3, 25)
    rh, rcache = ref_lm.prefill(rcfg, rp, jnp.asarray(toks), rcache,
                                use_kernel=True)
    rlogits = rh @ jnp.asarray(rp["embed"]["embedding"]).T
    _close(logits, rlogits, MODEL_TOL)
    assert state["cache"]["sub0"]["ssm"].shape == (cfg.num_layers, 3,
                                                   cfg.ssm_heads,
                                                   cfg.ssm_headdim,
                                                   cfg.ssm_state)
    _close(state["cache"]["sub0"]["ssm"], rcache["sub0"]["ssm"], MODEL_TOL)
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    rtok = jnp.argmax(rlogits[:, -1:], axis=-1).astype(jnp.int32)
    length = toks.shape[1]
    for _ in range(4):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(rtok))
        logits, state = api.decode_step(p, tok, state, use_kernel=True)
        length += 1
        rlogits, rcache = ref_lm.decode_step(rcfg, rp, rtok, rcache, length)
        _close(logits, rlogits, MODEL_TOL)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        rtok = jnp.argmax(rlogits[:, -1:], axis=-1).astype(jnp.int32)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(rtok))
    _close(state["cache"]["sub0"]["conv"], rcache["sub0"]["conv"], MODEL_TOL)


ARGV = ["--arch", "mamba2-370m", "--reduced", "--slots", "10", "--devices",
        "8"]


def test_serving_loop_matches_reference(monkeypatch, capsys):
    """The whole slice: the port's launch/serve loop with
    ``--arch mamba2-370m`` (the K3 and K4 routes, their plain versions on
    the CPU) prints the reference's ``repro.launch.serve.main`` lines."""
    monkeypatch.setattr(sys, "argv", ["serve", *ARGV])
    ref_serve.main()
    want = capsys.readouterr().out.splitlines()
    port_serve.main([*ARGV, "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got == want
    assert len(want) == 2 and "decode calls" in want[-1]
