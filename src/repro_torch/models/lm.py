"""Decoder-only LM assembly: embed -> blocks -> norm -> head (forward only).

Port of ``repro/models/lm.py``: the dense, MoE, SSM, hybrid (Jamba) and
VLM architectures (the VLM backbone takes precomputed patch embeddings
as ``prefix_embeds``).  The parameters are the reference's tree
as modules: ``nn.ModuleDict`` / ``nn.ParameterDict`` with the same keys,
and the layer axis the reference stacks its blocks on becomes an
``nn.ModuleList`` of pattern instances that ``backbone`` loops over.  The
decode cache keeps the reference's stacked layout, one tensor per entry
with the pattern instances on its leading axis: (n_layers, B, S, Hkv, Dh)
for an attention layer's k / v, (n_layers, B, k-1, conv_dim) in the
working type and (n_layers, B, h, p, n) in float32 for an SSM layer's
conv window / state; a hybrid pattern holds both kinds, by in-pattern
index.  The blocks write it in place (the reference returns a new
cache).  Lengths (``cache_len``) are host ints.

Training takes ``lm_loss`` under autograd: the parameters of a module
built with ``trainable=True`` (or made so by ``train.trainer``) take
gradients, and each pattern instance of a cache-free forward runs
inside ``blocks.remat_wrap`` (``cfg.remat``).  The loss takes the plain
routes, as the reference's ``ModelAPI.loss`` does: a hand-written
kernel has no backward, and its route raises on an input that needs a
gradient (``kernels.ops``).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.parallel import sharding


def to_module(tree, trainable: bool = False) -> nn.Module:
    """Nested dicts / lists of tensors -> ModuleDict / ModuleList /
    ParameterDict with the same keys.  The parameters are frozen (serving)
    unless ``trainable``."""
    if isinstance(tree, (list, tuple)):
        return nn.ModuleList([to_module(t, trainable) for t in tree])
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({
            k: nn.Parameter(v.detach(), requires_grad=trainable)
            for k, v in tree.items()})
    if any(isinstance(v, torch.Tensor) for v in tree.values()):
        raise TypeError(f"a params dict mixes tensors and subtrees: "
                        f"{sorted(tree)}")
    return nn.ModuleDict({k: to_module(v, trainable)
                          for k, v in tree.items()})


def _add_layers_axis(spec_tree):
    if isinstance(spec_tree, tuple):
        return ("layers", *spec_tree)
    return {k: _add_layers_axis(v) for k, v in spec_tree.items()}


def init_lm(cfg, key):
    """Returns (params, specs).  ``key`` is a ``torch.Generator``; the
    params land on its device, in ``cfg.dtype`` (norm scales float32).
    The reference draws with ``jax.random``, so the numbers differ: tests
    carry the reference's weights across with ``interop.model_params_from``."""
    if cfg.num_layers % cfg.pattern_period:
        raise ValueError(f"num_layers={cfg.num_layers} is not a multiple "
                         f"of the pattern period {cfg.pattern_period}")
    n_scan = cfg.num_layers // cfg.pattern_period
    embed_p, embed_s = L.init_embed(key, cfg)
    blocks_p, blocks_s = [], None
    for _ in range(n_scan):
        p, blocks_s = B.init_pattern(key, cfg)
        blocks_p.append(p)
    norm_p, norm_s = L.init_norm(cfg, device=key.device)
    params = to_module({"embed": embed_p, "blocks": blocks_p,
                        "final_norm": norm_p})
    specs = {"embed": embed_s, "blocks": _add_layers_axis(blocks_s),
             "final_norm": norm_s}
    return params, specs


def init_cache(cfg, batch: int, max_len: int, *, device=None):
    """Stacked decode cache: {"sub<r>": {"k", "v"}} (attention layers,
    each (n_pattern_instances, batch, max_len, Hkv, Dh)) or {"conv",
    "ssm"} (SSM layers, ``ssm.init_ssm_cache`` per instance), zeros;
    under a mesh placed by ``cache_spec_tree`` (``sharding.zeros``)."""
    n_scan = cfg.num_layers // cfg.pattern_period
    axes = cache_spec_tree(cfg)
    cache = {}
    for r in range(cfg.pattern_period):
        one = B.init_block_cache(cfg, r, batch, max_len, device="meta")
        cache[f"sub{r}"] = {
            name: sharding.zeros((n_scan, *x.shape), x.dtype, device,
                                 *axes[f"sub{r}"][name])
            for name, x in one.items()}
    return cache


def cache_spec_tree(cfg):
    """Logical axes of ``init_cache``'s entries (the reference's)."""
    one = {f"sub{r}": B.cache_specs(cfg, r)
           for r in range(cfg.pattern_period)}
    return _add_layers_axis(one)


def backbone(cfg, params, x, *, positions, cache=None, cache_len=None,
             use_kernel=False, causal=True):
    """Loop the block stack over a (B, S, D) stream.

    Returns (hidden (B, S, D), cache (updated in place), aux_loss: the
    MoE layers' load-balance losses summed over the pattern instances).
    Without a cache each pattern instance runs inside
    ``B.remat_wrap(cfg, ...)`` (the reference wraps its scan body)."""
    aux = 0.0
    step = B.remat_wrap(cfg, _pattern_fn(cfg, positions, use_kernel, causal))
    for i, blk in enumerate(params["blocks"]):
        if cache is None:
            x, aux_i = step(blk, x)
        else:
            blk_cache = {r: {name: t[i] for name, t in c.items()}
                         for r, c in cache.items()}
            x, _, aux_i = B.apply_pattern(
                cfg, blk, x, positions=positions, cache=blk_cache,
                cache_len=cache_len, use_kernel=use_kernel, causal=causal)
        aux = aux + aux_i
    return L.apply_norm(cfg, params["final_norm"], x), cache, aux


def _pattern_fn(cfg, positions, use_kernel, causal):
    """One cache-free pattern instance as fn(params, x) -> (x, aux)."""
    def fn(blk, x):
        x, _, aux = B.apply_pattern(cfg, blk, x, positions=positions,
                                    use_kernel=use_kernel, causal=causal)
        return x, aux
    return fn


def forward(cfg, params, tokens, *, prefix_embeds=None, cache=None,
            cache_len=None, positions=None, use_kernel=False):
    """tokens: (B, S) integer; prefix_embeds: (B, P, D) modality stub input.

    Returns (hidden (B, S(+P), D), cache, aux)."""
    x = L.embed_tokens(cfg, params["embed"], tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    Bsz, S, _ = x.shape
    if positions is None:
        start = int(cache_len) - S if cache_len is not None else 0
        positions = (start + torch.arange(S, device=x.device))[None].expand(
            Bsz, S)
    return backbone(cfg, params, x, positions=positions, cache=cache,
                    cache_len=cache_len, use_kernel=use_kernel)


def chunked_xent(cfg, embed_params, hidden, labels, mask=None,
                 n_chunks: int = 8):
    """Sequence-chunked cross entropy: never more than (B, S/n, V) logits
    at once.  hidden: (B, S, D); labels: (B, S) integer."""
    Bsz, S, D = hidden.shape
    n = n_chunks
    while S % n:
        n -= 1
    cs = S // n
    m = (torch.ones((Bsz, S), device=hidden.device) if mask is None
         else mask.float())
    head = L.lm_head(cfg, embed_params)
    nll_sum = torch.zeros((), device=hidden.device)
    cnt = torch.zeros((), device=hidden.device)
    for c in range(n):
        sl = slice(c * cs, (c + 1) * cs)
        logits = sharding.shard((hidden[:, sl] @ head).float(), "batch",
                                None, "vocab")  # (B, cs, V)
        lse = torch.logsumexp(logits, dim=-1)
        # the picked logit keeps its trailing axis until the subtraction:
        # a vocab-sharded gather's mask (DTensor) has the index's rank
        picked = logits.gather(-1, labels[:, sl, None].long())
        nll_sum = nll_sum + ((lse[..., None] - picked)
                             * m[:, sl, None]).sum()
        cnt = cnt + m[:, sl].sum()
    return nll_sum / torch.clamp_min(cnt, 1.0)


def lm_loss(cfg, params, batch, use_kernel=False, aux_weight: float = 0.01):
    """batch: {"tokens": (B, S+1) integer, optional "prefix_embeds"}.

    Next-token loss over tokens[:, :-1] -> tokens[:, 1:], plus
    ``aux_weight`` times the MoE load-balance loss."""
    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    prefix = batch.get("prefix_embeds")
    hidden, _, aux = forward(cfg, params, inputs, prefix_embeds=prefix,
                             use_kernel=use_kernel)
    if prefix is not None:  # loss only over text positions
        hidden = hidden[:, prefix.shape[1]:]
    loss = chunked_xent(cfg, params["embed"], hidden, labels)
    return loss + aux_weight * aux, {"xent": loss, "aux": aux}


def prefill(cfg, params, tokens, cache, *, prefix_embeds=None,
            use_kernel=False):
    """Process a prompt, filling the cache.  Returns (last_hidden, cache)."""
    S = tokens.shape[1] + (prefix_embeds.shape[1] if prefix_embeds is not None
                           else 0)
    hidden, cache, _ = forward(cfg, params, tokens,
                               prefix_embeds=prefix_embeds, cache=cache,
                               cache_len=S, use_kernel=use_kernel)
    return hidden[:, -1:], cache


def decode_step(cfg, params, token, cache, cache_len, use_kernel=False):
    """One decode step: token (B, 1) with the cache valid up to
    cache_len - 1 BEFORE this token; ``cache_len`` (a host int) is the
    length including the new token.  Returns (logits (B, 1, V), cache)."""
    hidden, cache, _ = forward(cfg, params, token, cache=cache,
                               cache_len=cache_len, use_kernel=use_kernel)
    return L.lm_logits(cfg, params["embed"], hidden), cache
