"""Training pipeline for learned gain predictors.

Port of the parts of ``repro/gain/train.py`` that need no trainer.  The
paper's predictor is trained on *calibration traffic that saw both
classifiers*: for each sample the observed gain is the cloudlet-vs-local
confidence-in-truth difference (footnote 4).  This module produces those
``(local-probs, true-gain)`` pairs — from a classifier pair or from a fully
synthetic generator — orders them into per-device TRACE HISTORY sequences
through the workload layer's counter-based image stream, and fits the
closed-form ridge (:class:`~repro_torch.gain.model.RidgeGainModel`).

The SSD head's training loop (``train_seq_gain``) and the ridge's
checkpoints (``save_ridge`` / ``load_ridge``) run on the trainer and the
checkpoint manager, which are not ported yet (ROADMAP.md queue A item 12):
they raise NotImplementedError.
"""

from __future__ import annotations

import numpy as np

from repro_torch.data.predictor import _numpy, probs_features
from repro_torch.gain.model import RidgeGainModel

TRAINER_TODO = ("{} needs the trainer and the checkpoint manager, which are "
                "not ported yet: ROADMAP.md, queue A item 12 (training)")


def gain_pairs(pair, x_calib, y_calib):
    """(local_probs (S, C), gains (S,)) from calibration traffic that saw
    both classifiers — the observed gain is the cloudlet-vs-local
    confidence-in-truth difference, clipped at 0 (paper footnote 4).
    ``pair`` is any object with ``local_probs(x)`` / ``cloud_probs(x)``."""
    lp = _numpy(pair.local_probs(x_calib))
    cp = _numpy(pair.cloud_probs(x_calib))
    y = np.asarray(y_calib)
    idx = np.arange(len(y))
    gains = np.clip(cp[idx, y] - lp[idx, y], 0.0, 1.0)
    return lp, gains


def synthetic_gain_problem(S: int = 512, C: int = 10, seed: int = 0):
    """A deterministic synthetic (probs, gains) problem — no classifier
    training needed (the gain tier's analogue of ``synthetic_pool``).

    Gains are a smooth function of the device's own confidence signals
    (low top-1 / high entropy -> more to gain from the cloudlet) plus a
    per-class offset and noise: learnable from the probability features,
    but not trivially so.  numpy draws, the reference's exactly.
    """
    rng = np.random.default_rng(seed)
    logits = rng.normal(0.0, 1.6, (S, C))
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    top1 = probs.max(-1)
    ent = -np.sum(probs * np.log(probs + 1e-9), axis=-1) / np.log(C)
    cls_offset = rng.uniform(0.0, 0.08, C)[probs.argmax(-1)]
    gains = (0.22 * (1.0 - top1) + 0.10 * ent + cls_offset
             + rng.normal(0.0, 0.015, S))
    return probs.astype(np.float64), np.clip(gains, 0.0, 1.0)


def oracle_pool(probs: np.ndarray, gains: np.ndarray, seed: int = 0):
    """A ``PrecomputedPool`` whose phi_hat/sigma ARE the true gains (the
    oracle tables the regret harness scores against).  Correctness is
    sampled consistently with the gains: the cloudlet is right wherever
    the device is, plus an extra-success margin that grows with the true
    gain — so better gain estimates really do buy service accuracy."""
    from repro_torch.serve.simulator import PrecomputedPool
    rng = np.random.default_rng(seed)
    S = len(gains)
    top1 = probs.max(-1)
    local_correct = (rng.random(S) < np.clip(top1, 0.25, 0.95))
    p_extra = np.clip(2.2 * gains, 0.0, 0.95)
    cloud_correct = local_correct | (rng.random(S) < p_extra)
    return PrecomputedPool(
        local_correct=local_correct.astype(np.float64),
        cloud_correct=cloud_correct.astype(np.float64),
        d_local=top1.astype(np.float64),
        phi_hat=np.asarray(gains, np.float64),
        sigma=np.full(S, 0.02),
        cycles=np.clip(rng.normal(441e6, 90e6, S), 150e6, None))


def trace_history(probs: np.ndarray, gains: np.ndarray, *, T: int = 512,
                  N: int = 8, seq_len: int = 64, seed: int = 0,
                  num_rates: int = 3, burst_len=(5, 10),
                  mean_gap: float = 8.0, device=None):
    """Per-device trace-history training sequences from the workload layer.

    The counter-based image stream (``generate_service_workload`` on
    ``device``, None -> cuda: the exact stream the engines replay) orders
    the calibration pairs into each device's per-slot history; windows of
    ``seq_len`` slots become the sequence head's training examples.

    Returns (feats (num, L, F+1), targets (num, L)) float32 numpy arrays.
    """
    from repro_torch.device import resolve_device
    from repro_torch.workload import generate_service_workload
    wl = generate_service_workload(seed, T, N, len(gains), num_rates,
                                   tuple(burst_len), mean_gap,
                                   device=resolve_device(device))
    img = wl.img.cpu().numpy()  # (T, N) image index per device-slot
    X = probs_features(probs)
    X = np.concatenate([X, np.ones((len(gains), 1))], axis=-1)
    feats, targets = [], []
    for n in range(N):
        col = img[:, n]
        for t0 in range(0, T - seq_len + 1, seq_len):
            w = col[t0:t0 + seq_len]
            feats.append(X[w])
            targets.append(np.asarray(gains)[w])
    return (np.stack(feats).astype(np.float32),
            np.stack(targets).astype(np.float32))


def _batches(feats, targets, batch: int, seed: int):
    rng = np.random.default_rng(seed)
    n = len(feats)
    while True:
        idx = rng.integers(0, n, batch)
        yield feats[idx], targets[idx]


def fit_ridge_gain(probs, gains, *, class_specific: bool = True,
                   l2: float = 1e-3, device=None) -> RidgeGainModel:
    """Closed-form fit (general + class-specific) -> tensor model on
    ``device`` (None -> cuda)."""
    return RidgeGainModel.fit(probs, gains, class_specific=class_specific,
                              l2=l2, device=device)


def train_seq_gain(probs, gains, **kw):
    """Train the SSD sequence head on trace-history windows: needs the
    trainer (ROADMAP.md queue A item 12); raises NotImplementedError.
    Until then a ``SeqGainModel`` takes seeded weights
    (``model.init_seq_params``) or the reference's
    (``interop.seq_gain_model_from``)."""
    raise NotImplementedError(TRAINER_TODO.format("train_seq_gain"))


def save_ridge(ckpt_dir: str, model: RidgeGainModel, step: int = 0) -> str:
    """Checkpoint a ridge model: needs the checkpoint manager (ROADMAP.md
    queue A item 12); raises NotImplementedError."""
    raise NotImplementedError(TRAINER_TODO.format("save_ridge"))


def load_ridge(ckpt_dir: str, step: int = None) -> RidgeGainModel:
    """Restore a ridge checkpoint: needs the checkpoint manager (ROADMAP.md
    queue A item 12); raises NotImplementedError."""
    raise NotImplementedError(TRAINER_TODO.format("load_ridge"))
