"""Unified model API over the ported architectures (port of
``repro/models/api.py``): init / loss / prefill_step / decode_step for the
decoder-only families.  ``prefill_step`` and ``decode_step`` take
``use_kernel`` and pass it to the LM (the reference's drop it, so its
kernels are unreachable from them: ROADMAP.md C5).  Serve state lengths
are host ints.
"""

from __future__ import annotations

import torch

from repro_torch.models import lm as LM
from repro_torch.models.layers import lm_logits

ENCDEC_TODO = ("encoder-decoder models are not ported yet: ROADMAP.md, "
               "queue A item 12 (model zoo)")


class ModelAPI:
    def __init__(self, cfg):
        if cfg.family == "encdec":
            raise NotImplementedError(ENCDEC_TODO)
        self.cfg = cfg

    def init(self, key: torch.Generator):
        """(params, specs) on the generator's device."""
        return LM.init_lm(self.cfg, key)

    def loss(self, params, batch, use_kernel=False):
        return LM.lm_loss(self.cfg, params, batch, use_kernel=use_kernel)

    def prefill_step(self, params, batch, max_len: int, use_kernel=False):
        """Returns (last_token_logits, serve_state).  The KV cache is
        allocated inside, sized to ``max_len``, on the tokens' device."""
        cfg = self.cfg
        tokens = batch["tokens"]
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
        new_len = state["length"] + 1
        logits, cache = LM.decode_step(self.cfg, params, token,
                                       state["cache"], new_len,
                                       use_kernel=use_kernel)
        return logits, {**state, "cache": cache, "length": new_len}
