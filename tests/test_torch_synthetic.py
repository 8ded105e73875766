"""The paper's trained-classifier scenario in the port against the JAX
package, on the CPU: ``data/synthetic.py`` and ``serve/simulator.py``'s
``build_pool`` / ``make_scenario``.

- ``make_dataset`` is numpy in both: equal bit for bit;
- the Adam micro-trainer, fed the reference's minibatch indices (its
  ``jax.random`` draws replayed here) from the reference's weights
  (``interop.mlp_params_from``), gives the reference's weights after 20
  steps within 1e-5 (measured: 1.2e-7);
- ``build_pool`` from a classifier pair carried across
  (``interop.classifier_pair_from``) and the predictor calibrated on it
  equals the reference's pool: correctness exactly, confidences, gains
  and sigma at rtol=1e-6;
- the port's own ``make_scenario`` (its classifiers drawn and trained from
  its own generators, so held to bands, not bits) lands in the
  reference's bands: the accuracies and the cloudlet gap of the
  reference's ``build_scenario`` over seeds 0-4 (easy: local 0.9065-0.971,
  cloud 0.9625-0.9885, gap 0.0175-0.056; hard: local 0.5115-0.6485, cloud
  0.71-0.809, gap 0.136-0.1995), each widened by 0.01.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import predictor as ref_predictor
from repro.data import synthetic as ref_syn
from repro.serve import simulator as ref_sim
from repro_torch import interop
from repro_torch.data import predictor, synthetic
from repro_torch.serve import simulator

# (low, high) of local_acc, cloud_acc and their gap, reference seeds 0-4
BANDS = {"easy": ((0.9065, 0.971), (0.9625, 0.9885), (0.0175, 0.056)),
         "hard": ((0.5115, 0.6485), (0.71, 0.809), (0.136, 0.1995))}
WIDEN = 0.01


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test process: these tests run thousands of
    small products, and the suite runs several processes on the CPU
    cores, where more threads than cores wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", ["easy", "hard"])
def test_make_dataset_bit_equal(kind):
    got = synthetic.make_dataset(kind, seed=3)
    want = ref_syn.make_dataset(kind, seed=3)
    for k in ("x_train", "y_train", "x_test", "y_test"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert got.num_classes == want.num_classes
    with pytest.raises(ValueError):
        synthetic.make_dataset("medium")


def test_adam_steps_with_reference_indices():
    data = ref_syn.make_dataset("hard", seed=0)
    params = ref_syn.mlp_init(jax.random.PRNGKey(3), [32, 256, 256, 128, 10])
    key, steps = jax.random.PRNGKey(4), 20
    x, y = jnp.asarray(data.x_train), jnp.asarray(data.y_train)
    want = ref_syn._train(params, x, y, key, steps=steps)
    idx = []  # the reference loop's draws: split, then randint
    for _ in range(steps):
        key, sub = jax.random.split(key)
        idx.append(np.array(jax.random.randint(sub, (256,), 0, x.shape[0])))
    model = interop.mlp_params_from(jax.tree.map(np.asarray, params),
                                    device="cpu")
    state = synthetic.adam_init(model, steps)
    xt, yt = torch.from_numpy(data.x_train), torch.from_numpy(data.y_train)
    for i in range(steps):
        synthetic.adam_step(model, state, xt, yt, torch.from_numpy(idx[i]), i)
    for layer, ref_layer in zip(model.layers, want):
        for k in ("w", "b"):
            np.testing.assert_allclose(layer[k].detach().numpy(),
                                       np.asarray(ref_layer[k]),
                                       rtol=0, atol=1e-5)
    # the forward is the reference's mlp_apply
    np.testing.assert_allclose(
        synthetic.mlp_apply(model, xt[:64]).detach().numpy(),
        np.asarray(ref_syn.mlp_apply(want, x[:64])), rtol=1e-5, atol=1e-5)


def test_build_pool_matches_reference():
    """The reference's pair (a few training steps from its weights), the
    predictor calibrated on it, the pool: both packages."""
    data = ref_syn.make_dataset("easy", seed=1)
    k = jax.random.split(jax.random.PRNGKey(1), 4)
    x, y = jnp.asarray(data.x_train), jnp.asarray(data.y_train)
    local = ref_syn._train(ref_syn.mlp_init(k[0], [32, 20, 10]), x[:420],
                           y[:420], k[1], steps=30)
    cloud = ref_syn._train(ref_syn.mlp_init(k[2], [32, 256, 256, 128, 10]),
                           x, y, k[3], steps=30)
    ref_pair = ref_syn.ClassifierPair(local, cloud, 0.5, 0.75)
    ref_pred = ref_predictor.calibrate(ref_pair, data.x_train[:5000],
                                       data.y_train[:5000])
    want = ref_sim.build_pool(data, ref_pair, ref_pred, seed=1)

    pair = interop.classifier_pair_from(
        ref_syn.ClassifierPair(jax.tree.map(np.asarray, local),
                               jax.tree.map(np.asarray, cloud), 0.5, 0.75),
        device="cpu")
    assert (pair.local_acc, pair.cloud_acc) == (0.5, 0.75)
    pred = predictor.calibrate(pair, data.x_train[:5000],
                               data.y_train[:5000])
    got = simulator.build_pool(data, pair, pred, seed=1)
    for k in ("local_correct", "cloud_correct"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    for k in ("d_local", "phi_hat", "sigma", "cycles"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("kind", ["easy", "hard"])
def test_make_scenario_in_reference_bands(kind):
    data, pair, pred, pool = simulator.make_scenario(kind, seed=0,
                                                     device="cpu")
    got = (pair.local_acc, pair.cloud_acc, pair.cloud_acc - pair.local_acc)
    for value, (lo, hi), name in zip(got, BANDS[kind],
                                     ("local", "cloud", "gap")):
        assert lo - WIDEN <= value <= hi + WIDEN, (kind, name, value)
    S = len(data.y_test)
    assert pool.phi_hat.shape == pool.sigma.shape == (S,)
    assert abs(pool.local_correct.mean() - pair.local_acc) < 1e-6
    assert pred.coefs.shape == (10, 14)
    # the pool serves: the scan engine on the CPU
    res = simulator.simulate_service(
        simulator.SimConfig(num_devices=4, T=120, B_n=0.06, seed=1), pool,
        device="cpu")
    assert pair.local_acc - 0.1 < res["accuracy"] <= 1.0
