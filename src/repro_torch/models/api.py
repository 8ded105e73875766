"""Unified model API over every architecture (port of
``repro/models/api.py``): init / loss / prefill_step / decode_step,
dispatching on ``cfg.family`` (decoder-only LM, the VLM with its
``prefix_embeds``, or encoder-decoder with ``src_embeds``).
``prefill_step`` and ``decode_step`` take ``use_kernel`` and pass it to
the model (the reference's drop it, so its kernels are unreachable from
them: ROADMAP.md C5).  Serve state lengths are host ints.  The dry-run
specs (``batch_specs``, ``serve_state_specs``) come with the dry run.
"""

from __future__ import annotations

import torch

from repro_torch.models import encdec as ED
from repro_torch.models import lm as LM
from repro_torch.models.layers import lm_logits


class ModelAPI:
    def __init__(self, cfg):
        self.cfg = cfg
        self.is_encdec = cfg.family == "encdec"

    def init(self, key: torch.Generator):
        """(params, specs) on the generator's device."""
        if self.is_encdec:
            return ED.init_encdec(self.cfg, key)
        return LM.init_lm(self.cfg, key)

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
