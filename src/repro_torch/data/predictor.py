"""Offloading-gain predictor (paper Sec. II.A + VI.A.2).

Port of ``repro/data/predictor.py``, numpy on both sides, so the fits
are the reference's bit for bit.  Each device estimates the cloudlet's
accuracy improvement phi(s) = d_0(s) - d_n(s) from its OWN classifier
output, without seeing the cloudlet result.  Closed-form ridge regression
(general + class-specific, the paper's Fig. 4 winner) on features of the
local probability vector, with a per-class residual std sigma: the
predictor confidence in the risk-adjusted gain w = phi_hat - v * sigma
(eq. 1).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def probs_features(probs: np.ndarray) -> np.ndarray:
    """Features of a local softmax output: full vector + confidence summary.

    (top-1 prob, top-2 margin, entropy, probs...) -> (F,) per sample.
    """
    probs = np.asarray(probs)
    top2 = np.sort(probs, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    ent = -np.sum(probs * np.log(probs + 1e-9), axis=-1)
    return np.concatenate(
        [top2[..., 1:2], margin[..., None], ent[..., None], probs], axis=-1)


def _ridge(X, y, l2=1e-3):
    F = X.shape[1]
    A = X.T @ X + l2 * np.eye(F)
    return np.linalg.solve(A, X.T @ y)


@dataclasses.dataclass
class GainPredictor:
    """Ridge gain predictor; ``class_specific`` fits one model per locally
    inferred class (the paper's best configuration)."""

    class_specific: bool = True
    l2: float = 1e-3
    coefs: np.ndarray | None = None  # (C, F+1) or (1, F+1)
    sigma: np.ndarray | None = None  # (C,) or (1,) residual std
    num_classes: int = 0

    def fit(self, local_probs: np.ndarray, gains: np.ndarray):
        """local_probs: (S, C) device softmax; gains: (S,) observed
        d_0(s) - d_n(s) from labeled calibration traffic."""
        local_probs = np.asarray(local_probs)
        gains = np.asarray(gains)
        S, C = local_probs.shape
        self.num_classes = C
        X = probs_features(local_probs)
        X = np.concatenate([X, np.ones((S, 1))], axis=-1)
        cls = np.argmax(local_probs, axis=-1)
        if self.class_specific:
            # classes with too few samples for a well-posed solve take the
            # general fit AND its residual std (a 1-sample class scored on
            # its own residual would get sigma = 0: full confidence where
            # the data is thinnest)
            w_gen = _ridge(X, gains, self.l2)
            sig_gen = (gains - X @ w_gen).std()
            coefs, sigmas = [], []
            for c in range(C):
                m = cls == c
                if m.sum() < X.shape[1] + 2:
                    coefs.append(w_gen)
                    sigmas.append(sig_gen)
                else:
                    w = _ridge(X[m], gains[m], self.l2)
                    coefs.append(w)
                    sigmas.append((gains[m] - X[m] @ w).std())
            self.coefs = np.stack(coefs)
            self.sigma = np.asarray(sigmas)
        else:
            w = _ridge(X, gains, self.l2)
            self.coefs = w[None]
            self.sigma = np.asarray([(gains - X @ w).std()])
        return self

    def predict(self, local_probs: np.ndarray):
        """Returns (phi_hat (S,), sigma (S,)) — gain estimate + confidence."""
        local_probs = np.asarray(local_probs)
        X = probs_features(local_probs)
        X = np.concatenate([X, np.ones((X.shape[0], 1))], axis=-1)
        if self.class_specific:
            cls = np.argmax(local_probs, axis=-1)
            phi = np.einsum("sf,sf->s", X, self.coefs[cls])
            sig = self.sigma[cls]
        else:
            phi = X @ self.coefs[0]
            sig = np.full(X.shape[0], self.sigma[0])
        return phi, sig

    def mae(self, local_probs, gains) -> float:
        phi, _ = self.predict(local_probs)
        return float(np.abs(phi - np.asarray(gains)).mean())


def calibrate(pair, x_calib, y_calib, class_specific=True) -> GainPredictor:
    """Fit a predictor from calibration traffic that saw both classifiers.

    ``pair`` is any object with ``local_probs(x)`` / ``cloud_probs(x)``
    returning (S, C) arrays (or tensors).  The observed gain per sample is
    the cloudlet-vs-local *confidence-in-truth* difference, clipped at 0
    (paper footnote 4)."""
    lp = _numpy(pair.local_probs(x_calib))
    cp = _numpy(pair.cloud_probs(x_calib))
    y = np.asarray(y_calib)
    idx = np.arange(len(y))
    gains = np.clip(cp[idx, y] - lp[idx, y], 0.0, 1.0)
    return GainPredictor(class_specific=class_specific).fit(lp, gains)


def _numpy(x) -> np.ndarray:
    """A host numpy copy of an array or a tensor."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)
