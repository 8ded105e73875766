"""Synthetic stand-ins for the paper's MNIST / CIFAR-10 experiments.

Port of ``repro/data/synthetic.py``.  Classification problems with a
*controlled* local-vs-cloudlet accuracy gap, and two trained classifiers
of different capacity, mirroring the paper's 1-layer (device) vs 4-layer
(cloudlet) CNNs:

  * ``easy``  (MNIST-like):  well-separated clusters -> small gap;
  * ``hard``  (CIFAR-like):  overlapping, anisotropic clusters + label
    noise -> a larger gap (the paper's Fig. 3/5 observations).

``make_dataset`` is numpy, a copy of the reference's draws (the same
arrays bit for bit).  The classifiers are ``MLP`` modules trained by a
small Adam loop on ``device`` (None -> cuda): ``adam_step`` takes one
step on the minibatch it is given, ``train_mlp`` draws the minibatch
indices from a ``torch.Generator``.  Initial weights and indices come
from CPU generators seeded from ``seed``, so a run draws the same
numbers on any device; the reference draws with ``jax.random``, so its
classifiers carry across by ``interop.classifier_pair_from`` and the
port's own are held to the reference's accuracy bands.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device


@dataclasses.dataclass
class Dataset:
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    num_classes: int


def make_dataset(kind: str = "hard", seed: int = 0, n_train: int = 6000,
                 n_test: int = 2000, dim: int = 32,
                 num_classes: int = 10) -> Dataset:
    """Gaussian-mixture classification with kind-dependent difficulty."""
    rng = np.random.default_rng(seed)
    # Tuned so the trained pair reproduces the paper's measured gaps:
    # easy (MNIST-like) ~ +4-6%, hard (CIFAR-like) ~ +14-15%.
    if kind == "easy":
        sep, noise_scale, label_noise, informative = 1.55, 1.25, 0.0, 13
    elif kind == "hard":
        sep, noise_scale, label_noise, informative = 1.2, 1.5, 0.04, 10
    else:
        raise ValueError(kind)

    # Only a low-dimensional subspace is informative; the rest is noise the
    # low-capacity device model cannot average out (CIFAR-vs-MNIST effect).
    means = np.zeros((num_classes, dim))
    means[:, :informative] = rng.normal(0, sep, size=(num_classes, informative))
    # anisotropic covariances: random scale per dimension per class
    scales = rng.uniform(0.8, noise_scale, size=(num_classes, dim))

    def sample(n):
        y = rng.integers(0, num_classes, n)
        x = means[y] + rng.normal(0, 1, (n, dim)) * scales[y]
        if label_noise > 0:
            flip = rng.random(n) < label_noise
            y = np.where(flip, rng.integers(0, num_classes, n), y)
        return x.astype(np.float32), y.astype(np.int32)

    x_tr, y_tr = sample(n_train)
    x_te, y_te = sample(n_test)
    return Dataset(x_tr, y_tr, x_te, y_te, num_classes)


# ----------------------------------------------------------------------------
# MLP classifiers (device: shallow / narrow, cloudlet: deep / wide)
# ----------------------------------------------------------------------------

class MLP(nn.Module):
    """ReLU MLP: ``layers[i]`` holds "w" (d_in, d_out) and "b" (d_out,),
    float32, the reference's params list as modules."""

    def __init__(self, weights):
        super().__init__()
        self.layers = nn.ModuleList(
            [nn.ParameterDict({"w": nn.Parameter(w), "b": nn.Parameter(b)})
             for w, b in weights])

    def forward(self, x):
        h = x
        for layer in self.layers[:-1]:
            h = F.relu(h @ layer["w"] + layer["b"])
        last = self.layers[-1]
        return h @ last["w"] + last["b"]


def mlp_init(gen: torch.Generator, sizes, *, device=None) -> MLP:
    """He-normal weights drawn from ``gen`` (a CPU generator), zero
    biases, on ``device`` (None -> cuda)."""
    dev = resolve_device(device)
    weights = []
    for d_in, d_out in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((d_in, d_out), generator=gen) * (2.0 / d_in) ** 0.5
        weights.append((w.to(dev), torch.zeros((d_out,), device=dev)))
    return MLP(weights)


def mlp_apply(model: MLP, x: torch.Tensor) -> torch.Tensor:
    return model(x)


def adam_init(model: MLP, steps: int) -> dict:
    """The micro-trainer's state: zero moments, and the bias corrections
    1 - 0.9^t, 1 - 0.999^t of t = 1..steps in float32 (tables on the
    device: a step reads its entry without a host value)."""
    dev = model.layers[0]["w"].device
    t = torch.arange(1, steps + 1, dtype=torch.float32, device=dev)
    zeros = lambda p: torch.zeros_like(p, requires_grad=False)
    return {"m": [zeros(p) for p in model.parameters()],
            "v": [zeros(p) for p in model.parameters()],
            "bc1": 1 - torch.pow(0.9, t), "bc2": 1 - torch.pow(0.999, t)}


def xent(model: MLP, xb, yb) -> torch.Tensor:
    """Mean cross entropy of the model's logits against labels yb."""
    logp = F.log_softmax(model(xb), dim=-1)
    return -torch.mean(torch.gather(logp, 1, yb[:, None].long()))


def adam_step(model: MLP, state: dict, x, y, idx, i: int,
              lr: float = 3e-3):
    """Step ``i`` (from 0) of the reference's Adam micro-trainer on the
    minibatch ``x[idx]``, ``y[idx]``: the gradient of ``xent``, moments
    (0.9, 0.999), bias-corrected, eps 1e-8; parameters and moments are
    written in place."""
    params = list(model.parameters())
    with torch.enable_grad():
        grads = torch.autograd.grad(xent(model, x[idx], y[idx]), params)
    bc1, bc2 = state["bc1"][i], state["bc2"][i]
    with torch.no_grad():
        for p, g, m, v in zip(params, grads, state["m"], state["v"]):
            m.copy_(0.9 * m + 0.1 * g)
            v.copy_(0.999 * v + 0.001 * g ** 2)
            p.copy_(p - lr * (m / bc1) / (torch.sqrt(v / bc2) + 1e-8))


def train_mlp(model: MLP, x, y, gen: torch.Generator, steps: int = 600,
              batch: int = 256, lr: float = 3e-3) -> MLP:
    """``steps`` Adam steps on minibatches of ``batch`` indices drawn
    uniformly from ``gen`` (a CPU generator; drawn at once and moved to
    the model's device).  Trains ``model`` in place and returns it."""
    dev = model.layers[0]["w"].device
    x = torch.as_tensor(x, device=dev)
    y = torch.as_tensor(y, device=dev)
    idx = torch.randint(0, x.shape[0], (steps, batch), generator=gen).to(dev)
    state = adam_init(model, steps)
    for i in range(steps):
        adam_step(model, state, x, y, idx[i], i, lr)
    return model


@dataclasses.dataclass
class ClassifierPair:
    """Trained device + cloudlet classifiers over one dataset."""

    local_params: MLP
    cloud_params: MLP
    local_acc: float
    cloud_acc: float

    @torch.no_grad()
    def local_probs(self, x) -> torch.Tensor:
        return _probs(self.local_params, x)

    @torch.no_grad()
    def cloud_probs(self, x) -> torch.Tensor:
        return _probs(self.cloud_params, x)


def _probs(model: MLP, x) -> torch.Tensor:
    dev = model.layers[0]["w"].device
    return torch.softmax(model(torch.as_tensor(x, device=dev)), dim=-1)


def _generators(seed: int, n: int) -> list:
    """n CPU generators seeded from ``seed`` (one a role, as the
    reference splits its key)."""
    return [torch.Generator().manual_seed(int(s)) for s in
            np.random.SeedSequence(seed).generate_state(n)]


@torch.no_grad()
def accuracy(model: MLP, x, y) -> float:
    dev = model.layers[0]["w"].device
    pred = torch.argmax(model(torch.as_tensor(x, device=dev)), dim=-1)
    return float((pred == torch.as_tensor(y, device=dev)).float().mean())


def train_pair(data: Dataset, seed: int = 0, local_frac: float = 0.05,
               local_width: int = 14, local_steps: int = 450, *,
               device=None) -> ClassifierPair:
    """Train the pair on ``device`` (None -> cuda): the device model sees
    a small slice of the training data and has one narrow hidden layer
    (the paper's resource-constrained device, 1-layer CNN); the cloudlet
    model is deeper / wider and sees everything (4-layer CNN)."""
    dev = resolve_device(device)
    g_init_l, g_train_l, g_init_c, g_train_c = _generators(seed, 4)
    dim = data.x_train.shape[1]
    C = data.num_classes

    n_local = max(int(len(data.x_train) * local_frac), 200)
    local = mlp_init(g_init_l, [dim, local_width, C], device=dev)
    train_mlp(local, data.x_train[:n_local], data.y_train[:n_local],
              g_train_l, steps=local_steps)
    cloud = mlp_init(g_init_c, [dim, 256, 256, 128, C], device=dev)
    train_mlp(cloud, data.x_train, data.y_train, g_train_c, steps=2500)

    return ClassifierPair(local, cloud,
                          accuracy(local, data.x_test, data.y_test),
                          accuracy(cloud, data.x_test, data.y_test))


def build_scenario(kind: str, seed: int = 0, *, device=None):
    """Dataset + trained classifier pair with kind-matched device capacity
    (easy: MNIST-like, small cloudlet gap; hard: CIFAR-like, larger).
    Returns (Dataset, ClassifierPair)."""
    data = make_dataset(kind, seed=seed)
    if kind == "easy":
        pair = train_pair(data, seed=seed, local_frac=0.07, local_width=20,
                          local_steps=550, device=device)
    else:
        pair = train_pair(data, seed=seed, local_frac=0.05, local_width=14,
                          local_steps=450, device=device)
    return data, pair
