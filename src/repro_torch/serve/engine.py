"""Serving-tier wave machinery + the cloudlet model engine.

Port of ``repro/serve/engine.py``:

  * :class:`WaveBuckets` — pad-to-bucket sizing for request waves (the
    reference's static-shape policy; kept so waves land on few shapes);
  * :class:`ServingEngine` — batched LM serving (prefill + decode with
    the KV cache) around :class:`~repro_torch.models.api.ModelAPI`, for
    the paper's cloudlet-side model.  It runs eagerly (no jit), on the
    card unless ``device`` says otherwise, and passes ``use_kernel`` to
    the model (the reference's engine drops it: ROADMAP.md C5);
  * :class:`Batcher` — FIFO request accumulation + bucketed token padding.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.api import ModelAPI


@dataclasses.dataclass(frozen=True)
class WaveBuckets:
    """Pad-to-bucket sizing: ``bucket_len(n)`` is the smallest bucket
    holding ``n`` items (the largest for anything bigger)."""

    buckets: Tuple[int, ...]

    def __post_init__(self):
        if not self.buckets:
            raise ValueError("need at least one bucket")
        object.__setattr__(self, "buckets", tuple(sorted(self.buckets)))

    def bucket_len(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def pad_rows(self, seqs: Sequence[np.ndarray], length: int,
                 pad_id: int = 0) -> np.ndarray:
        """Stack variable-length int rows into a (len(seqs), length)
        padded matrix (rows truncate at ``length``)."""
        out = np.full((len(seqs), length), pad_id, np.int32)
        for i, s in enumerate(seqs):
            out[i, :len(s)] = s[:length]
        return out


@dataclasses.dataclass
class EngineStats:
    prefill_calls: int = 0
    decode_calls: int = 0
    tokens_prefilled: int = 0
    tokens_decoded: int = 0


class ServingEngine:
    """Batched LM serving (prefill + decode) around ModelAPI.

    ``params`` is the model from ``ModelAPI.init`` (or
    ``interop.model_params_from``) on ``device``."""

    def __init__(self, cfg, params, max_len: int = 256,
                 use_kernel: bool = False, *, device=None):
        self.cfg = cfg
        self.api = ModelAPI(cfg)
        self.params = params
        self.max_len = max_len
        self.use_kernel = use_kernel
        self.device = resolve_device(device)
        self.stats = EngineStats()

    def generate(self, tokens, steps: int, greedy: bool = True,
                 generator: Optional[torch.Generator] = None):
        """tokens: (B, S_prompt) integer (numpy or tensor).  Returns the
        (B, steps) int32 generated ids on the engine's device.  Sampling
        (``greedy=False``) draws from ``generator``."""
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int32,
                                 device=self.device)
        with torch.inference_mode():
            logits, state = self.api.prefill_step(
                self.params, {"tokens": tokens}, self.max_len,
                use_kernel=self.use_kernel)
            self.stats.prefill_calls += 1
            self.stats.tokens_prefilled += tokens.numel()
            out = []
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            for _ in range(steps):
                out.append(tok)
                logits, state = self.api.decode_step(
                    self.params, tok, state, use_kernel=self.use_kernel)
                self.stats.decode_calls += 1
                self.stats.tokens_decoded += tok.shape[0]
                if greedy:
                    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
                else:
                    probs = torch.softmax(logits[:, -1].float(), dim=-1)
                    tok = torch.multinomial(probs, 1, generator=generator).to(
                        torch.int32)
            return torch.cat(out, dim=1)


class Batcher:
    """FIFO request accumulation + bucketed padding for LM waves: each
    slot the engine drains up to ``max_batch`` requests."""

    def __init__(self, max_batch: int, buckets=(32, 64, 128, 256)):
        self.max_batch = max_batch
        self.wave_buckets = WaveBuckets(tuple(buckets))
        self.queue: list = []

    @property
    def buckets(self):
        return list(self.wave_buckets.buckets)

    def submit(self, request):
        self.queue.append(request)

    def __len__(self):
        return len(self.queue)

    def next_wave(self) -> Optional[list]:
        if not self.queue:
            return None
        wave, self.queue = (self.queue[:self.max_batch],
                            self.queue[self.max_batch:])
        return wave

    def bucket_len(self, n: int) -> int:
        return self.wave_buckets.bucket_len(n)

    @staticmethod
    def pad_tokens(seqs, length: int, pad_id: int = 0):
        return WaveBuckets((length,)).pad_rows(seqs, length, pad_id)
