"""Training pipeline for learned gain predictors.

Port of ``repro/gain/train.py``.  The paper's predictor is trained on
*calibration traffic that saw both classifiers*: for each sample the
observed gain is the cloudlet-vs-local confidence-in-truth difference
(footnote 4).  This module produces those ``(local-probs, true-gain)``
pairs — from a classifier pair or from a fully synthetic generator —
orders them into per-device TRACE HISTORY sequences through the workload
layer's counter-based image stream, and fits:

  * the closed-form ridge (:class:`~repro_torch.gain.model.RidgeGainModel`,
    general + class-specific — the paper's Fig. 4 configuration),
    checkpointed through ``train.checkpoint``'s atomic writer in the
    reference's format (``save_ridge`` / ``load_ridge``); and
  * the tiny SSD/Mamba2 sequence head
    (:class:`~repro_torch.gain.model.SeqGainModel`), trained with the
    fault-tolerant ``train.trainer.TrainLoop`` and its
    ``CheckpointManager`` (``train_seq_gain``).
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch

from repro_torch.data.predictor import _numpy, probs_features
from repro_torch.device import resolve_device
from repro_torch.gain.model import (RidgeGainModel, SeqGainConfig,
                                    SeqGainModel, init_seq_params, seq_apply)


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
    return _windowed(probs, gains, history_windows(
        len(gains), T=T, N=N, seq_len=seq_len, seed=seed,
        num_rates=num_rates, burst_len=burst_len, mean_gap=mean_gap,
        device=device))


def _windowed(probs, gains, windows):
    """(feats (num, L, F+1), targets (num, L)) float32 of the images in
    ``windows`` (num, L)."""
    X = probs_features(probs)
    X = np.concatenate([X, np.ones((len(gains), 1))], axis=-1)
    return (X[windows].astype(np.float32),
            np.asarray(gains)[windows].astype(np.float32))


def history_windows(S: int, *, T: int = 512, N: int = 8, seq_len: int = 64,
                    seed: int = 0, num_rates: int = 3, burst_len=(5, 10),
                    mean_gap: float = 8.0, device=None) -> np.ndarray:
    """(num, seq_len) image indices of the trace-history windows: device
    by device, each device's image stream cut into ``seq_len``-slot
    windows (``trace_history``'s order)."""
    from repro_torch.workload import generate_service_workload
    wl = generate_service_workload(seed, T, N, S, num_rates,
                                   tuple(burst_len), mean_gap,
                                   device=resolve_device(device))
    img = wl.img.cpu().numpy()  # (T, N) image index per device-slot
    return np.stack([img[t0:t0 + seq_len, n] for n in range(N)
                     for t0 in range(0, T - seq_len + 1, seq_len)])


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


def train_seq_gain(probs, gains, *, steps: int = 120, seq_len: int = 64,
                   batch: int = 8, T: int = 512, N: int = 8,
                   lr: float = 2e-2, seed: int = 0, ckpt_dir=None,
                   cfg: SeqGainConfig = None, params=None,
                   log_fn=lambda *a: None, device=None):
    """Train the tiny SSD sequence head on trace-history windows, on
    ``device`` (None -> cuda).

    Runs the fault-tolerant ``train.trainer.TrainLoop`` (auto-resume,
    atomic ``train.checkpoint`` writes through a ``CheckpointManager``)
    over the workload-ordered sequences of :func:`trace_history`, with
    AdamW (no weight decay) at a constant ``lr``; the training forward
    takes the plain route (``seq_apply(use_kernel=False)``), as the
    reference's.  ``params``: initial head weights (default:
    ``init_seq_params`` from a CPU generator seeded with ``seed``; the
    reference draws its own with ``jax.random``, and they carry across
    by ``interop``).  Sigma is the per-class residual std on the training
    windows (the head resolved on them, through K4 on the card) — the
    same confidence semantics as the ridge predictor.

    Returns (SeqGainModel, history)."""
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import OptimizerSpec
    from repro_torch.train.trainer import (TrainLoop, TrainState,
                                           make_train_step)

    dev = resolve_device(device)
    probs = np.asarray(probs)
    C = probs.shape[1]
    if cfg is None:
        cfg = SeqGainConfig(feat_dim=C + 4)
    windows = history_windows(len(gains), T=T, N=N, seq_len=seq_len,
                              seed=seed, device=dev)
    feats, targets = _windowed(probs, gains, windows)

    def loss_fn(params, b):
        fb, tb = b
        phi = seq_apply(cfg, params, fb, use_kernel=False)
        return torch.mean((phi - tb) ** 2), {}

    spec = OptimizerSpec(name="adamw", lr=lr, weight_decay=0.0)
    step_fn = make_train_step(loss_fn, spec, lambda s: lr)
    if params is None:
        params = init_seq_params(torch.Generator().manual_seed(seed), cfg,
                                 device=dev)
    params = _tree_map(lambda t: t.detach().clone().to(dev), params)
    state = TrainState.create(params, spec)
    if ckpt_dir is None:
        ckpt_dir = tempfile.mkdtemp(prefix="gain_seq_ckpt_")
    manager = CheckpointManager(ckpt_dir, keep=2)
    loop = TrainLoop(train_step=step_fn, manager=manager,
                     ckpt_every=max(steps // 2, 1),
                     log_every=max(steps // 4, 1), log_fn=log_fn)
    state, history = loop.run(state, _batches(feats, targets, batch, seed),
                              num_steps=steps)
    params = _tree_map(lambda t: t.detach(), state.params)

    # per-class residual sigma on the training windows (flattened), each
    # window's images' local classes in the same order
    with torch.no_grad():
        phi_tr = seq_apply(cfg, params, torch.from_numpy(feats).to(dev),
                           use_kernel=dev.type == "cuda").cpu().numpy()
    resid = (phi_tr - targets).ravel()
    cls_flat = probs.argmax(-1)[windows].ravel()
    gen_std = max(float(resid.std()), 1e-4)
    sigma = np.full(C, gen_std)
    for c in range(C):
        m = cls_flat == c
        if m.sum() >= 8:
            sigma[c] = max(float(resid[m].std()), 1e-4)
    model = SeqGainModel(cfg=cfg, params=params,
                         sigma=torch.tensor(sigma, dtype=torch.float32,
                                            device=dev))
    return model, history


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def save_ridge(ckpt_dir: str, model: RidgeGainModel, step: int = 0) -> str:
    """Checkpoint a ridge model through ``train.checkpoint``'s atomic
    writer (the reference's format: either package loads it)."""
    from repro_torch.train import checkpoint as ckpt
    return ckpt.save(ckpt_dir, step,
                     {"coefs": model.coefs, "sigma": model.sigma})


def load_ridge(ckpt_dir: str, step: int = None, *,
               device=None) -> RidgeGainModel:
    """The ridge model of checkpoint ``step`` (None: the latest) on
    ``device`` (None -> cuda), float32."""
    from repro_torch.train import checkpoint as ckpt
    dev = resolve_device(device)
    if step is None:
        step = ckpt.latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir!r}")
    shapes = {le["key"]: le["shape"]
              for le in ckpt.manifest(ckpt_dir, step)["leaves"]}
    like = {k: torch.empty(shapes[k], dtype=torch.float32, device=dev)
            for k in ("coefs", "sigma")}
    tree = ckpt.restore(ckpt_dir, step, like=like)
    return RidgeGainModel(coefs=tree["coefs"], sigma=tree["sigma"])
