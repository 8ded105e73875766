"""Synthetic-but-learnable LM token pipeline.

Port of ``repro/data/lm_data.py``: numpy on both sides, a copy of the
reference's draws, so the streams are equal bit for bit.  No corpora ship
offline, so the end-to-end training example uses a structured synthetic
stream: a sparse first-order Markov chain over the vocabulary (each token
has a handful of likely successors).  A model that learns the transition
structure drops from ln(V) to near the chain's conditional entropy.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class LMStreamSpec:
    vocab_size: int
    batch: int
    seq_len: int
    branching: int = 8  # successors per token
    temperature: float = 1.0
    seed: int = 0


def token_stream(spec: LMStreamSpec) -> Iterator[dict]:
    """Yields {"tokens": (batch, seq_len + 1) int32} forever."""
    rng = np.random.default_rng(spec.seed)
    V, K = spec.vocab_size, spec.branching
    succ = rng.integers(0, V, size=(V, K))  # successor table
    logits = rng.normal(0, 1, size=(V, K)) / spec.temperature
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)

    state = rng.integers(0, V, size=spec.batch)
    while True:
        out = np.empty((spec.batch, spec.seq_len + 1), np.int32)
        out[:, 0] = state
        for t in range(1, spec.seq_len + 1):
            u = rng.random((spec.batch, 1))
            choice = (u > np.cumsum(probs[state], -1)).sum(-1)
            choice = np.minimum(choice, K - 1)
            state = succ[state, choice]
            out[:, t] = state
        yield {"tokens": out}


def conditional_entropy(spec: LMStreamSpec) -> float:
    """Analytic per-token entropy of the chain (the loss floor)."""
    rng = np.random.default_rng(spec.seed)
    V, K = spec.vocab_size, spec.branching
    rng.integers(0, V, size=(V, K))  # keep RNG stream aligned with stream()
    logits = rng.normal(0, 1, size=(V, K)) / spec.temperature
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return float(-(p * np.log(p)).sum(-1).mean())
