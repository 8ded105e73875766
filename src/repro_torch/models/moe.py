"""Mixture-of-Experts FFN: top-k router + capacity dispatch / combine, or
dropless.

Port of ``repro/models/moe.py`` for the three MoE configurations (jamba
16 experts top-2 on every second layer, olmoe 64 top-8, arctic 128 top-2
with a parallel dense residual MLP, which ``blocks.py`` adds).  The
reference computes both forms outside any Pallas kernel (XLA einsums and
``jax.lax.ragged_dot``), so their products here are plain ``einsum`` /
``matmul``.  The router runs in float32 on float32 inputs, whatever the
model's dtype, and ``torch.topk`` gives ``lax.top_k``'s descending order
(the aux loss reads slot 0).
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import _ACTS, normal
from repro_torch.parallel.sharding import grad_placed, shard


def init_moe(gen, cfg):
    """Router (D, E) in float32; experts (E, D, dff) / (E, dff, D) in
    ``cfg.dtype``, each drawn in that type on the generator's device."""
    D, E = cfg.d_model, cfg.num_experts
    dff = cfg.moe_d_ff or cfg.d_ff
    s_in = (2.0 / D) ** 0.5
    p = {
        "router": normal(gen, (D, E), torch.float32, s_in),
        "w_up": normal(gen, (E, D, dff), cfg.dtype, s_in),
        "w_down": normal(gen, (E, dff, D), cfg.dtype, (2.0 / dff) ** 0.5),
    }
    specs = {
        "router": ("embed", None),
        "w_up": ("experts", "embed", "expert_mlp"),
        "w_down": ("experts", "expert_mlp", "embed"),
    }
    if cfg.gated_mlp:
        p["w_gate"] = normal(gen, (E, D, dff), cfg.dtype, s_in)
        specs["w_gate"] = ("experts", "embed", "expert_mlp")
    return p, specs


def route(cfg, params, x):
    """Router of both forms: (probs (..., E) float32, top_w (..., K)
    renormalised, top_i (..., K) in descending probability)."""
    probs = torch.softmax(grad_placed(x.float() @ params["router"]), dim=-1)
    top_w, top_i = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    return probs, top_w, top_i


def _one_hot(idx, n: int):
    """float32 one-hot of ``idx`` over n classes; an index outside [0, n)
    gives a row of zeros, as ``jax.nn.one_hot`` does (and no host check)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _aux(probs, top1, E):
    """Switch load-balance loss: E * sum_e (top-1 fraction_e * mean
    prob_e)."""
    frac = _one_hot(top1.reshape(-1), E).mean(dim=0)
    return E * torch.sum(frac * probs.reshape(-1, E).mean(dim=0))


def _experts(cfg, params, xe, spec, hidden_axes=()):
    """The expert MLP over an expert-major operand (``spec`` names its
    axes, ``e`` first of the weights'); ``hidden_axes``, when given, are
    the hidden activation's logical axes (``shard``)."""
    up = torch.einsum(f"{spec},edf->{spec[:-1]}f", xe, params["w_up"])
    if cfg.gated_mlp:
        gate = torch.einsum(f"{spec},edf->{spec[:-1]}f", xe,
                            params["w_gate"])
        h = _ACTS[cfg.act](gate) * up
    else:
        h = _ACTS[cfg.act](up)
    if hidden_axes:
        h = shard(h, *hidden_axes)
    return torch.einsum(f"{spec[:-1]}f,efd->{spec}", h, params["w_down"])


def capacity(cfg, S: int) -> int:
    """Per-group expert capacity C = min(ceil(S * K * cf / E), S), at
    least 1 (the reference's float arithmetic)."""
    C = int(max(1, -(-S * cfg.top_k * cfg.capacity_factor
                     // cfg.num_experts)))
    return min(C, S)


def dispatch_combine(cfg, top_w, top_i, C: int):
    """GShard dispatch / combine tensors (B, S, E, C) in float32 from the
    routing of (B, S) tokens: queue positions within each expert by a
    cumsum over the group's (token, slot) order; positions past C drop
    (their token falls through to the residual)."""
    B, S, K = top_i.shape
    E = cfg.num_experts
    flat = _one_hot(top_i, E).reshape(B, S * K, E)
    pos = torch.cumsum(flat, dim=1) - flat  # queue position within expert
    pos_of = torch.sum(pos * flat, dim=-1)  # (B, S*K)
    keep = (pos_of < C).float()
    pos_oh = _one_hot(pos_of, C)  # (B, S*K, C); zeros past C
    disp = (flat[..., :, None] * pos_oh[..., None, :]
            * keep[..., None, None]).reshape(B, S, K, E, C)
    return disp.sum(dim=2), (disp * top_w[..., None, None]).sum(dim=2)


def moe_ffn(cfg, params, x):
    """x: (B, S, D) -> ((B, S, D), aux loss).

    GShard grouped dispatch: each batch row is a routing group with
    capacity ``capacity(cfg, S)``; the dispatch and combine tensors are
    (B, S, E, C), in ``cfg.dtype`` for the products (one-hot dispatch is
    exact in bf16).  Overflow tokens fall through to the residual."""
    E = cfg.num_experts
    probs, top_w, top_i = route(cfg, params, x)
    dispatch, combine = dispatch_combine(cfg, top_w, top_i,
                                         capacity(cfg, x.shape[1]))
    dispatch = shard(dispatch.to(cfg.dtype), "batch", None, "experts", None)
    combine = shard(combine.to(cfg.dtype), "batch", None, "experts", None)
    if x.shape[1] > 1 and getattr(x, "device_mesh", None) is not None:
        out = _experts_per_shard(cfg, params, x, dispatch, combine)
        return out, _aux(probs, top_i[..., 0], E)
    # dispatch to experts: the EP all-to-all boundary under a mesh
    xe = shard(torch.einsum("bsec,bsd->becd", dispatch, x), "batch",
               "experts", None, "act_embed")
    ye = shard(_experts(cfg, params, xe, "becd",
                        ("batch", "experts", None, "expert_mlp")),
               "batch", "experts", None, "act_embed")
    out = torch.einsum("bsec,becd->bsd", combine, ye)
    return shard(out, "batch", "seq", "act_embed"), _aux(probs, top_i[..., 0],
                                                          E)


def _experts_per_shard(cfg, params, x, dispatch, combine):
    """moe_ffn's dispatch, experts and combine on each rank's (batch,
    expert) shard, as an SPMD program runs them (DTensor plans no product
    over the dispatch's split batch and expert axes once a routing group
    holds more than one token): the expert weights gathered along their
    other axes, each rank's tokens through its own experts, the partial
    sums over the expert axis all-reduced."""
    from torch.distributed.tensor import DTensor, Partial

    x = shard(x, "batch", None, None)
    experts = {k: shard(params[k], "experts", None, None).to_local()
               for k in ("w_up", "w_gate", "w_down") if k in params}
    xe = torch.einsum("bsec,bsd->becd", dispatch.to_local(), x.to_local())
    ye = _experts(cfg, experts, xe, "becd")
    out = torch.einsum("bsec,becd->bsd", combine.to_local(), ye)
    out = DTensor.from_local(
        out, x.device_mesh,
        [Partial() if p.is_shard(2) else p for p in dispatch.placements],
        run_check=False, shape=x.shape, stride=x.stride())
    return shard(out, "batch", "seq", "act_embed")


# At most this many tokens a call, the dropless form runs every expert
# over every token.  Its products then stay bound by reading the expert
# weights, which a call reads whole once its tokens reach most experts
# (an H100 moves 3.35 TB/s and multiplies 990 TFLOP/s in bf16: below
# ~300 flops a weight byte, i.e. 300 tokens, the weights set the time),
# and no group size reaches the host.  Above it, the sorted grouped form
# does the routed FLOPs only, at one host read of the group sizes.
DENSE_TOKENS = 128


def _sum_in_expert_order(cfg, y_of, top_w, top_i):
    """Each token's k expert rows, weighted, summed in increasing expert
    order in the rows' dtype: the order and rounding of the reference's
    scatter-add over expert-sorted rows.  ``y_of(e, s)`` gives the (T, D)
    rows of each token's expert ``e`` (T,), its top-k slot ``s`` (T,)."""
    sel, order = torch.sort(top_i, dim=-1, stable=True)
    w = torch.gather(top_w, -1, order)
    out = None
    for k in range(cfg.top_k):
        y = y_of(sel[:, k], order[:, k])
        term = y * w[:, k, None].to(y.dtype)
        out = term if out is None else out + term
    return out


def _dropless_dense(cfg, params, xf, top_w, top_i):
    """Every expert over every token, one batched product a weight."""
    E = cfg.num_experts
    ye = _experts(cfg, params, xf.expand(E, -1, -1), "etd")  # (E, T, D)
    tok = torch.arange(xf.shape[0], device=xf.device)
    return _sum_in_expert_order(cfg, lambda e, _: ye[e, tok], top_w, top_i)


def _dropless_grouped(cfg, params, xf, top_w, top_i):
    """The reference's sort + ragged product: the (token, slot) pairs
    sorted by expert (stable), each expert's MLP over its own rows only.
    The group sizes come to the host once a call (one sync)."""
    T, K = top_i.shape
    flat = top_i.reshape(T * K)
    order = torch.argsort(flat, stable=True)
    xs = xf[order // K]  # (T*K, D) sorted by expert
    # (bincount on a CUDA tensor reads its max back first: a second sync)
    sizes = torch.zeros(cfg.num_experts, dtype=torch.int64,
                        device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat)).tolist()
    ys = torch.empty_like(xs)
    start = 0
    for e, n in enumerate(sizes):
        if n:
            one = {name: params[name][e:e + 1]
                   for name in ("w_up", "w_gate", "w_down") if name in params}
            ys[start:start + n] = _experts(cfg, one, xs[None, start:start + n],
                                           "etd")[0]
        start += n
    # back to (token, slot) order, then each token's rows by expert
    y = torch.empty_like(ys)
    y[order] = ys
    y = y.reshape(T, K, -1)
    tok = torch.arange(T, device=xf.device)
    return _sum_in_expert_order(cfg, lambda _, s: y[tok, s], top_w, top_i)


def moe_ffn_dropless(cfg, params, x):
    """Dropless MoE: every token reaches its top-k experts, whatever the
    batch, so prefill / decode outputs do not depend on the batch's
    composition.

    The reference sorts the (token, slot) pairs by expert and runs
    ``ragged_dot`` over the groups.  A call of more than DENSE_TOKENS
    tokens (a prefill) does the same (``_dropless_grouped``); a smaller
    one (a decode step) runs every expert over every token instead
    (``_dropless_dense``), with no sync.  Either way each token sums its
    k expert rows, weighted, in increasing expert order in the model's
    dtype."""
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    probs, top_w, top_i = route(cfg, params, xf)
    form = _dropless_dense if B * S <= DENSE_TOKENS else _dropless_grouped
    out = form(cfg, params, xf, top_w, top_i)
    return (shard(out.reshape(B, S, D).to(x.dtype), "batch", "seq",
                  "act_embed"),
            _aux(probs, top_i[:, 0], cfg.num_experts))
