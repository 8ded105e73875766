"""The port's cloudlet LM against the JAX package: layers, the reduced
olmo-1b forward / prefill + decode / loss with the reference's weights
carried across by ``interop.model_params_from``, greedy generation and
the configs (the other architectures: ``tests/test_torch_zoo.py``).

Bar: rtol = atol = 2e-5 in float32.  Both packages compute the same
function in float32 at d_model 128 over two layers; what differs is the
summation order of the matmuls and reductions, a few float32 ulps per
value, far inside 2e-5.  (The reference holds its own prefill + decode
against its forward at 2e-4 of the logits' scale, tests/test_models.py.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as ref_layers
from repro.models import lm as ref_lm
from repro.models.api import ModelAPI as RefAPI
from repro.serve.engine import ServingEngine as RefEngine
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import layers, lm
from repro_torch.models.api import ModelAPI
from repro_torch.serve.engine import ServingEngine

TOL = dict(rtol=2e-5, atol=2e-5)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def olmo():
    """Reduced olmo-1b in both packages with the reference's weights."""
    rcfg = ref_get_config("olmo-1b").reduced()
    cfg = get_config("olmo-1b").reduced()
    rp, _ = ref_lm.init_lm(rcfg, jax.random.PRNGKey(0))
    p = interop.model_params_from(jax.tree_util.tree_map(np.asarray, rp),
                                  cfg, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (2, 25)).astype(np.int32)
    return rcfg, rp, cfg, p, toks


def test_norms_match_reference():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 64)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    tx, jx = torch.tensor(x), jnp.asarray(x)
    _close(layers.rmsnorm(tx, torch.tensor(scale)),
           ref_layers.rmsnorm(jx, jnp.asarray(scale)))
    _close(layers.layernorm(tx, torch.tensor(scale), torch.tensor(bias)),
           ref_layers.layernorm(jx, jnp.asarray(scale), jnp.asarray(bias)))
    _close(layers.nonparam_ln(tx), ref_layers.nonparam_ln(jx))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    tx = torch.tensor(x).to(getattr(torch, dtype))
    want = ref_layers.apply_rope(jnp.asarray(x).astype(dtype),
                                 jnp.asarray(pos), 500.0)
    got = layers.apply_rope(tx, torch.tensor(pos), 500.0)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(TOL if dtype == "float32"
                                  else dict(rtol=2e-2, atol=2e-2)))


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True),
                                       ("gelu", False), ("relu", False)])
def test_mlp_matches_reference(act, gated):
    import dataclasses
    cfg = dataclasses.replace(get_config("olmo-1b").reduced(), act=act,
                              gated_mlp=gated)
    rng = np.random.default_rng(2)
    p = {n: (rng.standard_normal(s) * 0.2).astype(np.float32) for n, s in (
        ("w_up", (128, 256)), ("w_down", (256, 128)),
        ("w_gate", (128, 256)))}
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    want = ref_layers.apply_mlp(cfg, {n: jnp.asarray(v) for n, v in p.items()},
                                jnp.asarray(x))
    got = layers.apply_mlp(cfg, {n: torch.tensor(v) for n, v in p.items()},
                           torch.tensor(x))
    _close(got, want)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_matches_reference(olmo, use_kernel):
    """The no-cache forward; with use_kernel it goes through
    ops.flash_attention (K5's plain version on CPU tensors)."""
    rcfg, rp, cfg, p, toks = olmo
    want, _, _ = ref_lm.forward(rcfg, rp, jnp.asarray(toks[:, :16]))
    got, _, aux = lm.forward(cfg, p, torch.tensor(toks[:, :16]),
                             use_kernel=use_kernel)
    _close(got, want)
    assert aux == 0.0


@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_and_decode_match_reference(olmo, use_kernel):
    """ModelAPI.prefill_step + three decode_steps (K6's route with
    use_kernel) against the reference's, logits and caches."""
    rcfg, rp, cfg, p, toks = olmo
    r_api, api = RefAPI(rcfg), ModelAPI(cfg)
    r_logits, r_state = r_api.prefill_step(
        rp, {"tokens": jnp.asarray(toks[:, :12])}, max_len=20)
    logits, state = api.prefill_step(p, {"tokens": torch.tensor(toks[:, :12])},
                                     max_len=20, use_kernel=use_kernel)
    _close(logits, r_logits)
    assert state["length"] == 12
    for i in range(12, 15):
        tok = toks[:, i:i + 1]
        r_logits, r_state = r_api.decode_step(rp, jnp.asarray(tok), r_state)
        logits, state = api.decode_step(p, torch.tensor(tok), state,
                                        use_kernel=use_kernel)
        _close(logits, r_logits)
    assert state["length"] == int(r_state["length"]) == 15
    for name in ("k", "v"):
        _close(state["cache"]["sub0"][name],
               r_state["cache"]["sub0"][name])


def test_loss_matches_reference(olmo):
    rcfg, rp, cfg, p, toks = olmo
    want, want_m = ref_lm.lm_loss(rcfg, rp, {"tokens": jnp.asarray(toks)})
    for use_kernel in (False, True):
        got, m = lm.lm_loss(cfg, p, {"tokens": torch.tensor(toks)},
                            use_kernel=use_kernel)
        assert float(got) == pytest.approx(float(want), rel=2e-5, abs=2e-5)
        assert float(m["xent"]) == pytest.approx(float(want_m["xent"]),
                                                 rel=2e-5, abs=2e-5)


def test_generate_matches_reference(olmo):
    """Greedy tokens of ServingEngine.generate equal the reference's."""
    rcfg, rp, cfg, p, toks = olmo
    prompts = toks[:, :16]
    want = RefEngine(rcfg, rp, max_len=25).generate(prompts, steps=8)
    for use_kernel in (False, True):
        eng = ServingEngine(cfg, p, max_len=25, use_kernel=use_kernel,
                            device="cpu")
        got = eng.generate(prompts, steps=8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.int32
        assert (eng.stats.prefill_calls, eng.stats.decode_calls,
                eng.stats.tokens_decoded) == (1, 8, 16)


def test_sampling_draws_from_generator(olmo):
    _, _, cfg, p, toks = olmo
    eng = ServingEngine(cfg, p, max_len=25, device="cpu")
    outs = [eng.generate(toks[:, :16], steps=4, greedy=False,
                         generator=torch.Generator().manual_seed(s))
            for s in (3, 3)]
    assert torch.equal(outs[0], outs[1])
    assert int(outs[0].min()) >= 0 and int(outs[0].max()) < cfg.vocab_size


def test_init_and_interop_shapes(olmo):
    """ModelAPI.init and model_params_from build the reference's tree:
    per-layer blocks of the reference's shapes, frozen, float32 when
    reduced, as many parameters as param_count."""
    rcfg, rp, cfg, p, _ = olmo
    mine, specs = ModelAPI(cfg).init(torch.Generator().manual_seed(0))
    for params in (mine, p):
        assert len(params["blocks"]) == cfg.num_layers
        for name, w in params["blocks"][0]["sub0"]["mixer"].items():
            ref = rp["blocks"]["sub0"]["mixer"][name]
            assert tuple(w.shape) == tuple(ref.shape[1:]), name
            assert w.dtype == torch.float32 and not w.requires_grad
        assert sum(x.numel() for x in params.parameters()) == \
            cfg.param_count()
    assert specs["blocks"]["sub0"]["mixer"]["wq"] == (
        "layers", "embed", "heads", "head_dim")


def test_param_count_matches_reference():
    for reduced in (False, True):
        cfg, rcfg = get_config("olmo-1b"), ref_get_config("olmo-1b")
        if reduced:
            cfg, rcfg = cfg.reduced(), rcfg.reduced()
        assert cfg.param_count() == rcfg.param_count()
        assert cfg.active_param_count() == rcfg.active_param_count()
    full = get_config("olmo-1b")
    assert full.param_count() == 1_176_764_416
    assert full.dtype == torch.bfloat16
    assert full.reduced().dtype == torch.float32


def test_unported_model_paths_raise():
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")
