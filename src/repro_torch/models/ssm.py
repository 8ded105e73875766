"""Mamba2 / SSD (state-space duality) sequence mixer [arXiv:2405.21060].

Port of ``repro/models/ssm.py``.  The chunked SSD algorithm splits the
sequence into chunks of Q tokens: the *within-chunk* part is a batch of
small matrix products (``kernels.ops.ssd_chunk``, K4, with
``use_kernel``), the *cross-chunk* part a first-order recurrence over
chunk states (a loop over the chunks here, where the reference takes an
associative scan: the same recurrence, summed in another order).
``ssd_ref`` (the per-token recurrence) is the oracle for both, and the
decode step.

Numerics follow the reference route by route.  The decay statistics (dt
* A cumsums, exps) are float32.  Without ``use_kernel`` the bulk tensors
of the quadratic form (x, B, C, scores, L, decays, carried states) are
rounded to the working type (bf16 at full width) and their products
accumulate in float32, as the reference's ``preferred_element_type``
einsums do.  With ``use_kernel`` the within-chunk products run in
float32 on float32 copies of x, B and C; what lies outside the kernel
(the carried-state term) stays in the working type in both routes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import normal
from repro_torch.parallel.sharding import shard


def init_ssm(gen, cfg):
    D = cfg.d_model
    di, ds, g, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_heads
    conv_dim = di + 2 * g * ds
    s = (2.0 / D) ** 0.5
    f32 = dict(dtype=torch.float32, device=gen.device)
    p = {
        "w_in": normal(gen, (D, 2 * di + 2 * g * ds + nh), cfg.dtype, s),
        "w_out": normal(gen, (di, D), cfg.dtype, (2.0 / di) ** 0.5),
        "conv_w": normal(gen, (cfg.ssm_conv_kernel, conv_dim), cfg.dtype,
                         0.2),
        "A_log": torch.zeros((nh,), **f32),
        "dt_bias": torch.zeros((nh,), **f32),
        "D_skip": torch.ones((nh,), **f32),
        "norm_scale": torch.zeros((di,), **f32),
    }
    specs = {
        "w_in": ("embed", "mlp"),
        "w_out": ("mlp", "embed"),
        "conv_w": ("conv", "mlp"),
        "A_log": (None,),
        "dt_bias": (None,),
        "D_skip": (None,),
        "norm_scale": ("mlp",),
    }
    return p, specs


def _segsum(x):
    """Stable segment-sum: out[..., i, j] = sum_{j < k <= i} x[..., k].

    x: (..., Q) -> (..., Q, Q), lower-triangular support (-inf above)."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, out, float("-inf"))


def _in(t, cdt):
    """``t`` rounded to the working type ``cdt``, as float32 for the
    product (exact: what a float32-accumulating product of ``cdt``
    operands sees)."""
    return t.to(cdt).float()


def ssd_chunked(x, dt, A, B, C, chunk: int = 128, h0=None, use_kernel=False):
    """Chunked SSD scan.

    x:  (b, s, h, p)   input heads        dt: (b, s, h) positive step
    A:  (h,) negative  B, C: (b, s, g, n) with h % g == 0
    h0: optional (b, h, p, n) initial state.
    Returns (y (b, s, h, p) float32, h_final (b, h, p, n) float32).

    With ``use_kernel`` B and C go to K4 at group granularity (head i
    reads group i // (h // g)); the reference expands them to heads
    first, which computes the same function.  Under a mesh (DTensor
    arguments) each rank scans its own (batch, head) shard
    (``_ssd_per_shard``)."""
    if getattr(x, "device_mesh", None) is not None:
        return _ssd_per_shard(x, dt, A, B, C, chunk, h0, use_kernel)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {chunk}")
    nc, Q = s // chunk, chunk
    rep = h // g
    cdt = x.dtype if x.dtype in (torch.bfloat16, torch.float16) \
        else torch.float32

    x = x.reshape(b, nc, Q, h, p)
    dt = dt.float().reshape(b, nc, Q, h)
    Bc = B.reshape(b, nc, Q, g, n).to(cdt)
    Cc = C.reshape(b, nc, Q, g, n).to(cdt)
    # the (d_inner) -> (h, p) reshape loses the head axis's placement;
    # constrain it explicitly (a no-op without a mesh)
    x = shard(x, "batch", "seq_chunks", None, "ssm_heads", None)
    dt = shard(dt, "batch", "seq_chunks", None, "ssm_heads")
    dA = dt * A  # (b, nc, Q, h), negative, float32
    dA_cs = torch.cumsum(dA, dim=2)  # within-chunk cumulative

    if use_kernel:
        f32 = lambda t: t.float().contiguous()
        y_diag, states = kops.ssd_chunk(f32(x), dt.contiguous(), f32(A),
                                        f32(Bc), f32(Cc))
    else:
        xg = _in(x.float() * dt[..., None], cdt).reshape(b, nc, Q, g, rep, p)
        # ---- intra-chunk (dual / quadratic form): Y[i] += C_i . B_j decay x_j
        Lg = shard(_in(torch.exp(_segsum(dA.reshape(b, nc, Q, g, rep).movedim(
            2, 4))), cdt), "batch", "seq_chunks", "ssm_heads", None, None,
            None)  # (b, nc, g, rep, Q, Q)
        scores = _in(torch.einsum("bcign,bcjgn->bcgij", Cc.float(),
                                  Bc.float()), cdt)
        y_diag = torch.einsum("bcgrij,bcjgrp->bcigrp",
                              scores[:, :, :, None] * Lg, xg)
        y_diag = shard(y_diag.reshape(b, nc, Q, h, p), "batch", "seq_chunks",
                       None, "ssm_heads", None)
        # ---- per-chunk terminal states: sum_j exp(dA_cs[-1]-dA_cs[j]) B_j xbar_j
        dg = _in(torch.exp(dA_cs[:, :, -1:, :] - dA_cs), cdt).reshape(
            b, nc, Q, g, rep)
        states = torch.einsum("bcjgn,bcjgrp->bcgrpn", Bc.float(),
                              dg[..., None] * xg)
        states = shard(states.reshape(b, nc, h, p, n), "batch",
                       "seq_chunks", "ssm_heads", None, None)

    # ---- inter-chunk recurrence over chunk index: h_c = h_{c-1}*dec_c + st_c
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])  # (b, nc, h)
    h_cur = (torch.zeros_like(states[:, 0], dtype=torch.float32)
             if h0 is None else h0.float())
    h_prevs = []  # the state ENTERING each chunk, h0 first
    for c in range(nc):
        h_prevs.append(h_cur)
        h_cur = h_cur * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)  # (b, nc, h, p, n)

    # ---- contribution of the carried-in state to each position
    sg = _in(torch.exp(dA_cs), cdt).reshape(b, nc, Q, g, rep)
    hg = _in(h_prevs, cdt).reshape(b, nc, g, rep, p, n)
    y_off = torch.einsum("bcign,bcgrpn->bcigrp", Cc.float(), hg) \
        * sg[..., None]
    y_off = y_off.reshape(b, nc, Q, h, p)

    y = (y_diag + y_off).reshape(b, s, h, p)
    return y, h_cur


def _ssd_per_shard(x, dt, A, B, C, chunk, h0, use_kernel):
    """ssd_chunked on each rank's (batch, head) shard, as an SPMD program
    runs it: DTensor plans no product over the scan's several split batch
    axes.  The heads are split over the "ssm_heads" axis where the model
    has one group (every head reads it); the sequence is whole."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = x.device_mesh
    x = shard(x, "batch", None, "ssm_heads" if B.shape[2] == 1 else None,
              None)

    def like_x(dims):
        """x's splits of (batch, seq, heads, head dim) on ``dims``."""
        return [Shard(dims[p.dim]) if p.is_shard() and dims[p.dim]
                is not None else Replicate() for p in x.placements]

    local = lambda t, dims: t.redistribute(mesh, like_x(dims)).to_local()
    h_pl = like_x((0, None, 1, None))
    y, hf = ssd_chunked(x.to_local(), local(dt, (0, 1, 2, None)),
                        local(A, (None, None, 0, None)),
                        local(B, (0, 1, None, None)),
                        local(C, (0, 1, None, None)), chunk,
                        None if h0 is None else local(h0, (0, None, 1, None)),
                        use_kernel)
    b, s, h, p = x.shape
    return (DTensor.from_local(y, mesh, x.placements, run_check=False,
                               shape=(b, s, h, p),
                               stride=(s * h * p, h * p, p, 1)),
            DTensor.from_local(hf, mesh, h_pl, run_check=False,
                               shape=(b, h, p, B.shape[3]),
                               stride=(h * p * B.shape[3], p * B.shape[3],
                                       B.shape[3], 1)))


def ssd_ref(x, dt, A, B, C, h0=None):
    """Naive per-token recurrence oracle:
    h_t = h_{t-1} * exp(dt_t A) + dt_t * B_t x_t ; y_t = C_t . h_t."""
    b, s, h, p = x.shape
    n = B.shape[3]
    rep = h // B.shape[2]
    Bh = B.float().repeat_interleave(rep, dim=2)
    Ch = C.float().repeat_interleave(rep, dim=2)
    x = x.float()
    dt = dt.float()
    h_cur = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    ys = []
    for t in range(s):
        dA = torch.exp(dt[:, t] * A)  # (b, h)
        h_cur = (h_cur * dA[..., None, None]
                 + (dt[:, t, :, None] * x[:, t])[..., None]
                 * Bh[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", h_cur, Ch[:, t]))
    return torch.stack(ys, dim=1), h_cur


def _causal_conv(x, w, cache=None):
    """Depthwise causal conv1d. x: (b, s, c); w: (k, c); cache: (b, k-1, c).

    Returns (y (b, s, c), new_cache (b, k-1, c))."""
    k, S = w.shape[0], x.shape[1]
    if cache is None:
        cache = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([cache, x], dim=1)
    y = xp[:, :S] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + S] * w[i]
    new_cache = xp[:, -(k - 1):] if k > 1 else cache
    return y, new_cache


def mamba_block(cfg, params, x, *, cache=None, use_kernel=False):
    """Full Mamba2 mixer sublayer.

    cache: None (train/prefill from scratch) or dict with 'conv' (b, k-1, c)
    and 'ssm' (b, h, p, n).  Returns (out (b, s, d_model), new_cache), the
    new cache as fresh tensors (the caller writes them into its cache).
    A cache with one token decodes by the exact recurrence; otherwise the
    chunked scan runs with chunk 128, or s when shorter, halved until it
    divides s."""
    b, s, _ = x.shape
    di, ds, g, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_heads
    hd = cfg.ssm_headdim

    proj = shard(x @ params["w_in"], "batch", "seq",
                 "mlp")  # (b, s, 2di + 2g ds + nh)
    z, xBC, dt_raw = torch.split(proj, [di, di + 2 * g * ds, nh], dim=-1)

    conv_cache = cache["conv"] if cache is not None else None
    xBC, new_conv = _causal_conv(xBC, params["conv_w"], conv_cache)
    xBC = F.silu(xBC)
    x_ssm, Bm, Cm = torch.split(xBC, [di, g * ds, g * ds], dim=-1)

    dt = F.softplus(dt_raw.float() + params["dt_bias"])  # (b, s, nh)
    A = -torch.exp(params["A_log"])  # (nh,)
    xh = x_ssm.reshape(b, s, nh, hd)
    Bh = Bm.reshape(b, s, g, ds)
    Ch = Cm.reshape(b, s, g, ds)

    if cache is not None and s == 1:
        y, hf = ssd_ref(xh, dt, A, Bh, Ch, h0=cache["ssm"])
    else:
        h0 = cache["ssm"] if cache is not None else None
        chunk = min(128, s) if s % 128 != 0 else 128
        while s % chunk != 0:
            chunk //= 2
        y, hf = ssd_chunked(xh, dt, A, Bh, Ch, chunk=chunk, h0=h0,
                            use_kernel=use_kernel)

    y = y + xh.float() * params["D_skip"][:, None]
    y = y.reshape(b, s, di)
    # gated RMSNorm (Mamba2): norm(y * silu(z))
    y = y * F.silu(z.float())
    var = torch.mean(y * y, dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-6) * (1.0 + params["norm_scale"])
    out = shard(y.to(x.dtype) @ params["w_out"], "batch", "seq", "act_embed")
    return out, {"conv": new_conv, "ssm": hf}


def init_ssm_cache(cfg, batch, *, device=None):
    conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_kernel - 1, conv_dim),
                            dtype=cfg.dtype, device=device),
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_headdim,
                            cfg.ssm_state), dtype=torch.float32,
                           device=device),
    }
