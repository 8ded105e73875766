"""Unified model API over every architecture (port of
``repro/models/api.py``): init / loss / prefill_step / decode_step,
dispatching on ``cfg.family`` (decoder-only LM, the VLM with its
``prefix_embeds``, or encoder-decoder with ``src_embeds``).
``prefill_step`` and ``decode_step`` take ``use_kernel`` and pass it to
the model (the reference's drop it, so its kernels are unreachable from
them: ROADMAP.md C5).  Serve state lengths are host ints.

The dry run's abstract specs (``abstract_params``, ``batch_specs``,
``serve_state_specs``) are (tensors on the ``meta`` device: shapes and
dtypes, nothing allocated, and their logical axes), the reference's
(ShapeDtypeStruct tree, axes tree) pairs.  The parameter module keeps the
port's layout (a layer list of pattern instances) beside the reference's
axes tree: ``train.tree.leaf_axes`` pairs them.
"""

from __future__ import annotations

import torch

from repro_torch.models import encdec as ED
from repro_torch.models import lm as LM
from repro_torch.models.layers import lm_logits
from repro_torch.train.tree import map_state


class ModelAPI:
    def __init__(self, cfg):
        self.cfg = cfg
        self.is_encdec = cfg.family == "encdec"

    def init(self, key: torch.Generator):
        """(params, specs) on the generator's device."""
        if self.is_encdec:
            return ED.init_encdec(self.cfg, key)
        return LM.init_lm(self.cfg, key)

    def abstract_params(self):
        """(params on the meta device, logical axes): ``init``'s module
        and specs with nothing allocated."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode():
            params, specs = self.init(torch.Generator())
        return map_state(params, lambda _, p: _meta(p.shape, p.dtype)), specs

    def loss(self, params, batch, use_kernel=False):
        if self.is_encdec:
            return ED.encdec_loss(self.cfg, params, batch,
                                  use_kernel=use_kernel)
        return LM.lm_loss(self.cfg, params, batch, use_kernel=use_kernel)

    def prefill_step(self, params, batch, max_len: int, use_kernel=False):
        """Returns (last_token_logits, serve_state).  The KV / SSM cache is
        allocated inside, sized to ``max_len``, on the tokens' device.  An
        encoder-decoder takes ``batch["src_embeds"]`` (B, S_src, D) and
        keeps the cross-attention K / V in the state (``memory_kv``); a
        VLM takes ``batch["prefix_embeds"]`` (B, frontend_tokens, D),
        which fill the cache's first rows."""
        cfg = self.cfg
        tokens = batch["tokens"]
        if self.is_encdec:
            memory = ED.encode(cfg, params, batch["src_embeds"],
                               use_kernel=use_kernel)
            kv = ED.cross_kv(cfg, params, memory)
            cache = ED.init_dec_cache(cfg, tokens.shape[0], max_len,
                                      device=tokens.device)
            hidden, cache = ED.decode(cfg, params, tokens, kv, cache=cache,
                                      cache_len=tokens.shape[1],
                                      use_kernel=use_kernel)
            logits = lm_logits(cfg, params["embed"], hidden[:, -1:])
            return logits, {"cache": cache, "memory_kv": kv,
                            "length": int(tokens.shape[1])}
        cache = LM.init_cache(cfg, tokens.shape[0], max_len,
                              device=tokens.device)
        prefix = batch.get("prefix_embeds")
        hidden, cache = LM.prefill(cfg, params, tokens, cache,
                                   prefix_embeds=prefix,
                                   use_kernel=use_kernel)
        logits = lm_logits(cfg, params["embed"], hidden)
        total = tokens.shape[1] + (prefix.shape[1] if prefix is not None
                                   else 0)
        return logits, {"cache": cache, "length": int(total)}

    def decode_step(self, params, token, state, use_kernel=False):
        """token: (B, 1) integer; state from prefill_step.
        Returns (logits (B, 1, V), new_state)."""
        cfg = self.cfg
        new_len = state["length"] + 1
        if self.is_encdec:
            hidden, cache = ED.decode(cfg, params, token, state["memory_kv"],
                                      cache=state["cache"],
                                      cache_len=new_len,
                                      use_kernel=use_kernel)
            logits = lm_logits(cfg, params["embed"], hidden)
        else:
            logits, cache = LM.decode_step(cfg, params, token,
                                           state["cache"], new_len,
                                           use_kernel=use_kernel)
        return logits, {**state, "cache": cache, "length": new_len}

    # ------------------------------------------------ dry-run abstract specs
    def batch_specs(self, shape):
        """(meta tensor tree, logical-axes tree) for the mode's step-function
        data inputs (a ``configs.ShapeConfig``)."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        f32, i32 = torch.float32, torch.int32

        if shape.mode in ("train", "prefill"):
            extra = 1 if shape.mode == "train" else 0  # next-token labels
            if self.is_encdec:
                src = cfg.frontend_tokens or 512
                specs = {"src_embeds": _meta((B, src, cfg.d_model), f32),
                         "tokens": _meta((B, S + extra), i32)}
                axes = {"src_embeds": ("batch", None, None),
                        "tokens": ("batch", None)}
            elif cfg.family == "vlm":
                text = S - cfg.frontend_tokens
                specs = {"tokens": _meta((B, text + extra), i32),
                         "prefix_embeds": _meta((B, cfg.frontend_tokens,
                                                 cfg.d_model), f32)}
                axes = {"tokens": ("batch", None),
                        "prefix_embeds": ("batch", None, None)}
            else:
                specs = {"tokens": _meta((B, S + extra), i32)}
                axes = {"tokens": ("batch", None)}
            return specs, axes

        # decode: token + serve state (cache sized to S)
        state_shapes, state_axes = self.serve_state_specs(shape)
        return ({"token": _meta((B, 1), i32), "state": state_shapes},
                {"token": ("batch", None), "state": state_axes})

    def serve_state_specs(self, shape):
        """(meta tensor tree, logical-axes tree) of the serve state that
        ``prefill_step`` returns for a cache sized to ``shape.seq_len``
        ("length" a () int32 here; the state holds a host int)."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        length = _meta((), torch.int32)
        if self.is_encdec:
            src = cfg.frontend_tokens or 512
            kv = (cfg.num_layers, B, S, cfg.num_kv_heads,
                  cfg.resolved_head_dim)
            mem = (cfg.num_layers, B, src, cfg.num_kv_heads,
                   cfg.resolved_head_dim)
            shapes = {"cache": {"k": _meta(kv, cfg.dtype),
                                "v": _meta(kv, cfg.dtype)},
                      "memory_kv": (_meta(mem, cfg.dtype),
                                    _meta(mem, cfg.dtype)),
                      "length": length}
            axes = {"cache": {"k": ED.KV_AXES, "v": ED.KV_AXES},
                    "memory_kv": (ED.MEM_AXES, ED.MEM_AXES),
                    "length": ()}
            return shapes, axes
        return ({"cache": LM.init_cache(cfg, B, S, device="meta"),
                 "length": length},
                {"cache": LM.cache_spec_tree(cfg), "length": ()})


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")
