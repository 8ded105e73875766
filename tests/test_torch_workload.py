"""The port's workload layer against the JAX package: bit-identical draws.

JAX runs on the CPU; data crosses between the packages as numpy arrays.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.admission import quantize_states_device as ref_quantize
from repro.serve.simulator import pool_space as ref_pool_space
from repro.serve.simulator import synthetic_pool as ref_synthetic_pool
from repro.workload import streams as ref_streams
from repro.workload.service import \
    generate_service_workload as ref_generate
from repro_torch.serve.admission import (quantize_states,
                                         quantize_states_device)
from repro_torch.serve.simulator import pool_space, synthetic_pool
from repro_torch.workload import streams
from repro_torch.workload.service import (generate_service_workload,
                                          validate_rng_version)

CPU = torch.device("cpu")


@pytest.mark.parametrize("seed", [0, 1, 123456])
def test_keys_match_jax(seed):
    for sid in (1, 2, 4):
        ref = np.asarray(ref_streams.stream_key(seed, sid))
        assert streams.stream_key(seed, sid) == tuple(int(x) for x in ref)
    key = streams.fold_in(streams.stream_key(seed, 1), 3)
    ref = jax.random.fold_in(ref_streams.stream_key(seed, 1), 3)
    assert key == tuple(int(x) for x in np.asarray(ref))


@pytest.mark.parametrize("seed", [0, 1, 123456])
def test_uniform_block_bit_identical(seed):
    """T=130 is not a multiple of ROW_BLOCK; 4 channels, N=7."""
    T, N, C = 130, 7, 4
    got = streams.uniform_block(seed, streams.STREAM_SERVICE, T, N, C,
                                device=CPU).numpy()
    ref = np.asarray(ref_streams.uniform_block(
        seed, ref_streams.STREAM_SERVICE, T, N, C))
    assert got.shape == (C, T, N) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    # block 1 straight from jax.random.uniform under its block key
    key = jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(seed),
                           ref_streams.STREAM_SERVICE), 1)
    raw = np.asarray(jax.random.uniform(key, (64, C, N))).transpose(1, 0, 2)
    np.testing.assert_array_equal(got[:, 64:128], raw)


def test_uniform_matches_jax_uniform():
    key = (12345, 678)
    jkey = jnp.asarray(np.array(key, np.uint32))
    for shape in ((5,), (3, 11), (2, 4, 9)):
        np.testing.assert_array_equal(
            streams.uniform(key, shape, device=CPU).numpy(),
            np.asarray(jax.random.uniform(jkey, shape)))


@pytest.mark.parametrize("seed,T,N,kw", [
    (0, 130, 7, {}),
    (4, 203, 5, {}),
    (123456, 64, 33, dict(burst_len=(2, 4), mean_gap=3.0,
                          channel_stay=0.8)),
])
def test_generate_service_workload_equal(seed, T, N, kw):
    got = generate_service_workload(seed, T, N, 64, 3, device=CPU, **kw)
    ref = ref_generate(seed, T, N, 64, 3, **kw)
    for name in ("on", "img", "rates"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    assert got.on.dtype == torch.bool and got.img.dtype == torch.int32


def test_chain_and_hold_processes_equal():
    rng = np.random.default_rng(0)
    u = rng.random((50, 6), dtype=np.float32)
    s0 = rng.random(6) < 0.5
    got = streams.markov_chain(torch.from_numpy(u), torch.from_numpy(s0),
                               0.3, 0.8)
    ref = ref_streams.markov_chain(jnp.asarray(u), jnp.asarray(s0),
                                   jnp.float32(0.3), jnp.float32(0.8))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    change = rng.random((50, 6)) < 0.2
    cand = rng.integers(0, 5, (50, 6)).astype(np.int32)
    entry = rng.integers(0, 5, 6).astype(np.int32)
    got = streams.hold_resample_from(torch.from_numpy(change),
                                     torch.from_numpy(cand),
                                     torch.from_numpy(entry))
    ref = ref_streams.hold_resample_from(jnp.asarray(change),
                                         jnp.asarray(cand),
                                         jnp.asarray(entry))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_quantize_states_device_equal():
    """Random raw values plus exact level midpoints (ties to the first
    level) quantize to the same indices."""
    space = pool_space(synthetic_pool())
    assert (dataclasses.astuple(space)
            == dataclasses.astuple(ref_pool_space(ref_synthetic_pool())))
    rng = np.random.default_rng(1)
    mids = lambda lv: (np.asarray(lv[:-1]) + np.asarray(lv[1:])) / 2
    T, N = 40, 9
    o = rng.uniform(0.1, 0.5, (T, N)).astype(np.float32)
    h = rng.uniform(2e8, 6e8, (T, N)).astype(np.float32)
    w = rng.uniform(0.0, 0.35, (T, N)).astype(np.float32)
    o[0, :2] = mids(space.o_levels)
    h[0, :2] = mids(space.h_levels)
    w[0, :7] = mids(space.w_levels)
    task = rng.random((T, N)) < 0.7
    got = quantize_states_device(space, *(torch.from_numpy(x)
                                          for x in (o, h, w, task)))
    ref = ref_quantize(space, o, h, w, task)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(quantize_states(space, o, h, w, task),
                                  np.asarray(ref))


def test_rng_versions():
    assert validate_rng_version(1) == 1
    with pytest.raises(ValueError, match="retired"):
        validate_rng_version(0)
    with pytest.raises(ValueError, match="rng_version"):
        validate_rng_version(7)
