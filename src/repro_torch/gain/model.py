"""Trained gain predictors as tensor functions.

Port of ``repro/gain/model.py``.  Two model families behind
:class:`~repro_torch.gain.source.ModelGain`:

  :class:`RidgeGainModel` — the paper's best configuration (Fig. 4,
    class-specific closed-form ridge).  Fitting stays in
    :class:`repro_torch.data.predictor.GainPredictor` (closed form,
    numpy); inference — features, per-class coefficient gather, dot — runs
    on the pool's device in one pass.

  :class:`SeqGainModel` — a tiny Mamba2/SSD sequence head
    (:func:`repro_torch.models.ssm.mamba_block`) over per-image
    probability features; the pool's images run as ONE sequence in index
    order, and on the card its chunk scan is the SSD kernel (K4).  It is
    trained by ``gain.train.train_seq_gain`` (the plain route under
    autograd); its weights may also come from :func:`init_seq_params` or
    from the reference (``interop.seq_gain_model_from``).

Both expose ``apply(probs) -> (phi_hat, sigma)``, float32 (S,) tensors on
``probs``' device: the whole contract :class:`ModelGain` needs.

Arithmetic: the ridge's features and dot (:func:`xla_probs_features`,
:func:`ridge_dot`) are formed by elementwise ops in the order and
roundings of the reference's compiled CPU program — its float32 log
(:func:`xla_logf`, the Cephes polynomial XLA emits), the entropy and the
14-term dot summed left to right, with its fused multiply-adds (one
rounding, formed here through float64) — so a ridge model gives the
reference's bits, and the same bits on the CPU and the card.  That order
was read from the LLVM IR that jaxlib 0.9.0 emits for an x86-64 host with
AVX-512F and FMA; another jaxlib, or a host without FMA, may fuse other
products, and ``tests/test_torch_gain.py``'s bit-for-bit checks of the
ridge's tables against the reference would show it.  The SSD head needs
no such copy (its chunk scan on the card is K4, in 3xTF32): its features
are :func:`probs_features_t`'s plain ``torch.log`` and row sum.
"""

from __future__ import annotations

import dataclasses
import functools
import struct
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.data.predictor import GainPredictor
from repro_torch.device import resolve_device


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c for float32 operands with one rounding to float32 (the
    product is exact in float64): the fused multiply-add the reference's
    compiled CPU program issues, the same bits on every device."""
    return (a.double() * b.double() + c.double()).float()


def _c(value_hex: str, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant (given as the hex of its double image, as LLVM
    prints it) as a 0-dim tensor on ``like``'s device, so every product
    and sum below is a float32 op; made once a device (a copy to the card
    each call would wait for the card)."""
    return _constant(value_hex, like.device)


@functools.lru_cache(maxsize=None)
def _constant(value_hex: str, device: torch.device) -> torch.Tensor:
    v = np.float32(struct.unpack(">d", bytes.fromhex(value_hex))[0])
    return torch.tensor(v, dtype=torch.float32, device=device)


def xla_logf(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive finite float32 ``x``, bit for bit as the
    reference's compiled CPU program computes ``jnp.log`` in float32: the
    Cephes logf polynomial XLA emits, in its order, with the fused
    multiply-adds its code generator forms (a product with one use feeds
    an add as one rounding); the same bits on every device."""
    c = lambda h: _c(h, x)
    one = c("3FF0000000000000")
    x = torch.maximum(x.float(), c("3810000000000000"))  # min normal
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 127).float() + one
    m = ((bits & -2139095041) | 1056964608).view(torch.float32)
    low = m < c("3FE6A09E60000000")  # sqrt(1/2)
    e = e - low.float()
    x = (m - one) + torch.where(low, m, torch.zeros_like(m))
    x2 = x * x
    x3 = x2 * x
    y = _fma(x, c("3FB2043760000000"), c("BFBD7A3700000000"))
    y1 = _fma(x, c("BFBFCBA9E0000000"), c("3FC23D37E0000000"))
    y2 = _fma(x, c("3FC999D580000000"), c("BFCFFFFF80000000"))
    y = _fma(y, x, c("3FBDE4A340000000"))
    y1 = _fma(y1, x, c("BFC555CA00000000"))
    y2 = _fma(y2, x, c("3FD5555540000000"))
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * c("BF2BD01060000000"))
    x = _fma(-c("3FE0000000000000"), x2, x) + y
    return _fma(e, c("3FE6300000000000"), x)


def _features(probs, top2, entropy):
    """(top-1, margin, entropy, probs..., 1) from the sorted top two."""
    margin = top2[..., 1] - top2[..., 0]
    ones = torch.ones(probs.shape[:-1] + (1,), dtype=probs.dtype,
                      device=probs.device)
    return torch.cat([top2[..., 1:2], margin[..., None], entropy[..., None],
                      probs, ones], dim=-1)


def probs_features_t(probs: torch.Tensor) -> torch.Tensor:
    """Tensor form of :func:`repro_torch.data.predictor.probs_features`
    with the ridge's bias column: (top-1, top-2 margin, entropy, probs...,
    1) -> (..., C + 4), float32 on ``probs``' device, in plain torch ops
    (the SSD head's input)."""
    probs = probs.float()
    top2 = torch.sort(probs, dim=-1).values[..., -2:]
    entropy = -torch.sum(probs * torch.log(probs + 1e-9), dim=-1)
    return _features(probs, top2, entropy)


def xla_probs_features(probs: torch.Tensor) -> torch.Tensor:
    """:func:`probs_features_t` bit for bit as the reference's compiled
    CPU program forms it (the ridge's input): the log is
    :func:`xla_logf`, and the entropy sums p * log(p + 1e-9) left to
    right, each term fused into the sum."""
    probs = probs.float()
    top2 = torch.sort(probs, dim=-1).values[..., -2:]
    log = xla_logf(probs + _c("3E112E0BE0000000", probs))
    acc = torch.zeros_like(probs[..., 0])
    for k in range(probs.shape[-1]):
        acc = _fma(probs[..., k], log[..., k], acc)
    return _features(probs, top2, -acc)


def ridge_dot(X: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Row-wise dot of (S, F) features and (S, F) coefficients in the
    reference's order (XLA's CPU GEMV): left to right, the first eight
    products rounded on their own, the rest fused into the sum."""
    acc = X[:, 0] * W[:, 0]
    for k in range(1, X.shape[1]):
        acc = (acc + X[:, k] * W[:, k] if k < 8
               else _fma(X[:, k], W[:, k], acc))
    return acc


def _as_probs(probs, device) -> torch.Tensor:
    if isinstance(probs, torch.Tensor):
        return probs.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(probs), dtype=torch.float32,
                        device=device)


@dataclasses.dataclass(frozen=True, eq=False)
class RidgeGainModel:
    """Closed-form ridge coefficients as a tensor predictor.

    coefs: (C, F+1) class-specific — or (1, F+1) general — float32 weights;
    sigma: (C,) or (1,) per-class residual std (predictor confidence).
    ``apply`` runs on the device of its ``probs`` (the weights follow).
    """

    coefs: torch.Tensor
    sigma: torch.Tensor

    @classmethod
    def from_predictor(cls, predictor: GainPredictor, *,
                       device=None) -> "RidgeGainModel":
        if predictor.coefs is None:
            raise ValueError("predictor is not fitted")
        dev = resolve_device(device)
        f32 = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)
        return cls(coefs=f32(predictor.coefs), sigma=f32(predictor.sigma))

    @classmethod
    def fit(cls, local_probs, gains, *, class_specific: bool = True,
            l2: float = 1e-3, device=None) -> "RidgeGainModel":
        """Closed-form fit (general + class-specific) -> tensor model."""
        pred = GainPredictor(class_specific=class_specific, l2=l2)
        return cls.from_predictor(pred.fit(local_probs, gains),
                                  device=device)

    def apply(self, probs):
        """probs (S, C) float32 -> (phi_hat (S,), sigma (S,))."""
        dev = (probs.device if isinstance(probs, torch.Tensor)
               else self.coefs.device)
        probs = _as_probs(probs, dev)
        coefs, sigma = self.coefs.to(dev), self.sigma.to(dev)
        X = xla_probs_features(probs)
        cls = torch.argmax(probs, dim=-1)
        phi = ridge_dot(X, coefs[cls.clamp_max(coefs.shape[0] - 1)])
        return phi, sigma[cls.clamp_max(sigma.shape[0] - 1)]


@dataclasses.dataclass(frozen=True)
class SeqGainConfig:
    """Tiny Mamba2 head dims (d_inner must equal heads * headdim)."""

    feat_dim: int
    d_model: int = 16
    d_inner: int = 32
    ssm_state: int = 8
    ssm_ngroups: int = 1
    ssm_heads: int = 2
    ssm_headdim: int = 16
    ssm_conv_kernel: int = 2
    dtype: object = torch.float32

    def as_model_cfg(self):
        """The attribute bag ``repro_torch.models.ssm`` expects."""
        return SimpleNamespace(**dataclasses.asdict(self))


def init_seq_params(gen: torch.Generator, cfg: SeqGainConfig, *,
                    device=None) -> dict:
    """Random head weights drawn from ``gen`` (on the generator's device),
    placed on ``device`` (None -> cuda): the reference's shapes and
    scales, not its draws (those carry over by ``interop``)."""
    from repro_torch.models.layers import normal
    from repro_torch.models.ssm import init_ssm

    dev = resolve_device(device)
    s = (2.0 / cfg.feat_dim) ** 0.5
    w_feat = normal(gen, (cfg.feat_dim, cfg.d_model), torch.float32, s)
    mamba, _ = init_ssm(gen, cfg.as_model_cfg())
    w_head = normal(gen, (cfg.d_model, 1), torch.float32, 1.0 / cfg.d_model)
    params = {
        "w_feat": w_feat,
        "b_feat": torch.zeros((cfg.d_model,), dtype=torch.float32),
        "mamba": mamba,
        "w_head": w_head,
        "b_head": torch.zeros((), dtype=torch.float32),
    }
    return _params_to(params, dev)


def _params_to(params, device):
    if isinstance(params, dict):
        return {k: _params_to(v, device) for k, v in params.items()}
    return params.to(device)


def seq_apply(cfg: SeqGainConfig, params, feats: torch.Tensor, *,
              use_kernel: bool):
    """feats (b, L, feat_dim) -> per-position gain estimates (b, L).  With
    ``use_kernel`` the mixer's chunk scan goes through ``kernels.ops``
    (K4 on a CUDA tensor, its plain version on a CPU one): resolution
    takes it.  Training passes False: the plain route under autograd, as
    the reference's (K4 has no backward)."""
    from repro_torch.models.ssm import mamba_block
    x = feats @ params["w_feat"] + params["b_feat"]
    y, _ = mamba_block(cfg.as_model_cfg(), params["mamba"], x,
                       use_kernel=use_kernel)
    return (y @ params["w_head"])[..., 0] + params["b_head"]


@dataclasses.dataclass(frozen=True, eq=False)
class SeqGainModel:
    """Sequence head + per-class residual-sigma table.

    ``apply`` runs the pool's images as ONE sequence in index order, a
    pure function of the probability matrix, so resolution is
    deterministic and replayable.  The weights follow ``probs``' device.
    """

    cfg: SeqGainConfig
    params: dict
    sigma: torch.Tensor  # (C,) per-class residual std

    @torch.no_grad()
    def apply(self, probs):
        dev = (probs.device if isinstance(probs, torch.Tensor)
               else self.sigma.device)
        probs = _as_probs(probs, dev)
        feats = probs_features_t(probs)
        phi = seq_apply(self.cfg, _params_to(self.params, dev),
                        feats[None], use_kernel=dev.type == "cuda")[0]
        cls = torch.argmax(probs, dim=-1)
        sigma = self.sigma.to(dev)
        return phi, sigma[cls.clamp_max(sigma.shape[0] - 1)]
