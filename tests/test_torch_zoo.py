"""The rest of the model zoo against the JAX package: the eight configs
and what they use (the MoE FFN in both forms, Arctic's dense residual,
the hybrid Jamba stack, the encoder-decoder backbone function by
function, the VLM prefix path) through ``ModelAPI`` (forward, prefill +
decode, loss, init) with the reference's weights carried across by
``interop``; the MoE forms alone with equal routing; the dropless
batch-composition property; the enc-dec's kernel routes; and
``launch.serve --arch olmoe-1b-7b`` printing the reference's lines.

Bar: rtol = atol = 2e-5 in float32, as ``tests/test_torch_models.py``
holds olmo-1b: both packages compute the same float32 function at
d_model 128 over a few layers, in other summation orders.  MoE routing
indices are held equal, not close.  Jamba runs at one pattern instance
(8 layers) to keep the file cheap.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import encdec as ref_encdec
from repro.models import lm as ref_lm
from repro.models import moe as ref_moe
from repro.models.api import ModelAPI as RefAPI
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.launch import serve as port_serve
from repro_torch.models import encdec, lm, moe
from repro_torch.models.api import ModelAPI
from repro_torch.serve.engine import ServingEngine

TOL = dict(rtol=2e-5, atol=2e-5)
ARCHS = ["yi-9b", "command-r-35b", "deepseek-67b", "internvl2-1b",
         "olmoe-1b-7b", "jamba-v0.1-52b", "arctic-480b",
         "seamless-m4t-medium"]
B, PROMPT, STEPS, SRC = 2, 8, 3, 16

# torch's first float32 exp over a large CPU tensor, in a process that has
# loaded JAX, is now and then off by up to 1e-4 relative (ROADMAP.md C7;
# Jamba's SSM layers take large exps).  One call before any test.
torch.exp(torch.zeros(1 << 16))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


def _close_trees(got, want, path="state"):
    """Every leaf of the reference's tree (dicts, tuples) against the
    port's at the bar."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _close_trees(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close_trees(g, w, f"{path}[{i}]")
    else:
        assert tuple(got.shape) == tuple(want.shape), path
        _close(got, want)


def _cfgs(arch):
    """(reference, port) configs at reduced(); Jamba at one pattern
    instance."""
    rc, pc = ref_get_config(arch).reduced(), get_config(arch).reduced()
    if pc.family == "hybrid":
        rc = dataclasses.replace(rc, num_layers=rc.pattern_period)
        pc = dataclasses.replace(pc, num_layers=pc.pattern_period)
    return rc, pc


def _params_from(rp, cfg):
    rp = jax.tree_util.tree_map(np.asarray, rp)
    if cfg.family == "encdec":
        return interop.encdec_params_from(rp, cfg, device="cpu")
    return interop.model_params_from(rp, cfg, device="cpu")


def _batch(cfg, seed=0):
    """numpy inputs from a seed: tokens (B, PROMPT + STEPS + 1), the VLM's
    prefix embeddings (B, frontend_tokens, D), the enc-dec's source
    frames (B, SRC, D)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, PROMPT + STEPS + 1)
                                  ).astype(np.int32)}
    if cfg.family == "vlm":
        out["prefix_embeds"] = (0.02 * rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)
    if cfg.family == "encdec":
        out["src_embeds"] = (0.1 * rng.standard_normal(
            (B, SRC, cfg.d_model))).astype(np.float32)
    return out


def _max_len(cfg):
    return PROMPT + STEPS + (cfg.frontend_tokens if cfg.family == "vlm"
                             else 0) + 1


def _prompt(batch, tokens):
    """The serving batch of a prompt: ``tokens`` plus the modality input."""
    return {"tokens": tokens, **{k: v for k, v in batch.items()
                                 if k != "tokens"}}


@pytest.fixture(scope="module", params=ARCHS)
def zoo(request):
    """One architecture in both packages with the reference's weights,
    the numpy inputs and the reference's outputs (forward hidden and aux,
    prefill + decode logits and final state, loss).  One test reads it,
    so that the reference's work runs once whichever worker takes it."""
    rc, pc = _cfgs(request.param)
    r_api = RefAPI(rc)
    rp, _ = r_api.init(jax.random.PRNGKey(0))
    p = _params_from(rp, pc)
    batch = _batch(pc)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    toks = jb["tokens"]
    memory = kv = None
    if pc.family == "encdec":
        memory = ref_encdec.encode(rc, rp, jb["src_embeds"])
        kv = ref_encdec.cross_kv(rc, rp, memory)
        fwd, _ = ref_encdec.decode(rc, rp, toks[:, :PROMPT], kv)
        fwd_aux = 0.0
    else:
        fwd, _, fwd_aux = ref_lm.forward(
            rc, rp, toks[:, :PROMPT], prefix_embeds=jb.get("prefix_embeds"))
    logits, state = r_api.prefill_step(rp, _prompt(jb, toks[:, :PROMPT]),
                                       max_len=_max_len(pc))
    steps = [logits]
    decode = jax.jit(r_api.decode_step)  # one trace for the three steps
    for i in range(PROMPT, PROMPT + STEPS):
        logits, state = decode(rp, toks[:, i:i + 1], state)
        steps.append(logits)
    loss, metrics = r_api.loss(rp, jb)
    return dict(rc=rc, rp=rp, cfg=pc, p=p, batch=batch, fwd=fwd,
                fwd_aux=float(fwd_aux), memory=memory, kv=kv,
                steps=steps, state=state,
                loss=float(loss), xent=float(metrics["xent"]),
                aux=float(metrics["aux"]))


def _t(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _check_forward(zoo, use_kernel):
    """The no-cache forward (K5's plain version with use_kernel) and its
    MoE aux loss; an enc-dec's functions one by one: encode (K5
    non-causal), cross_kv ((num_layers, B, S_src, Hkv, Dh) each), the
    no-cache decode."""
    cfg, p, tb = zoo["cfg"], zoo["p"], _t(zoo["batch"])
    toks = tb["tokens"][:, :PROMPT]
    if cfg.family == "encdec":
        memory = encdec.encode(cfg, p, tb["src_embeds"],
                               use_kernel=use_kernel)
        _close(memory, zoo["memory"])
        kv = encdec.cross_kv(cfg, p, memory)
        _close_trees(kv, zoo["kv"], "memory_kv")
        assert kv[0].shape == (cfg.num_layers, B, SRC, cfg.num_kv_heads,
                               cfg.resolved_head_dim)
        got, none = encdec.decode(cfg, p, toks, kv, use_kernel=use_kernel)
        assert none is None
        aux = 0.0
    else:
        got, _, aux = lm.forward(cfg, p, toks,
                                 prefix_embeds=tb.get("prefix_embeds"),
                                 use_kernel=use_kernel)
    _close(got, zoo["fwd"])
    assert float(aux) == pytest.approx(zoo["fwd_aux"], rel=2e-5, abs=2e-5)
    assert (float(aux) > 0) == bool(cfg.num_experts)


def _check_prefill_and_decode(zoo, use_kernel):
    """ModelAPI.prefill_step + three decode_steps (K6's plain version in
    every self-attention, and in an enc-dec's one-row cross-attention,
    with use_kernel) against the reference's: logits at every step and
    the final state (KV / SSM caches, the enc-dec's memory K / V)."""
    cfg, p, tb = zoo["cfg"], zoo["p"], _t(zoo["batch"])
    api = ModelAPI(cfg)
    logits, state = api.prefill_step(
        p, _prompt(tb, tb["tokens"][:, :PROMPT]), max_len=_max_len(cfg),
        use_kernel=use_kernel)
    got = [logits]
    for i in range(PROMPT, PROMPT + STEPS):
        logits, state = api.decode_step(p, tb["tokens"][:, i:i + 1], state,
                                        use_kernel=use_kernel)
        got.append(logits)
    for g, w in zip(got, zoo["steps"]):
        _close(g, w)
    assert state["length"] == int(zoo["state"]["length"])
    _close_trees({k: v for k, v in state.items() if k != "length"},
                 {k: v for k, v in zoo["state"].items() if k != "length"})


def _check_loss(zoo, use_kernel):
    """ModelAPI.loss: the total (xent + 0.01 aux), xent and aux."""
    loss, m = ModelAPI(zoo["cfg"]).loss(zoo["p"], _t(zoo["batch"]),
                                        use_kernel=use_kernel)
    for got, want in ((loss, zoo["loss"]), (m["xent"], zoo["xent"]),
                      (m["aux"], zoo["aux"])):
        assert float(got) == pytest.approx(want, rel=2e-5, abs=2e-5)


def _check_init_tree(zoo):
    """ModelAPI.init builds the reference's tree, instance by instance
    (Jamba: attention at in-pattern index 4, MoE on odd indices), with
    the reference's shapes, and the analytic count of the parameters
    (norm scales and D_skip aside, which the analytic count leaves
    out)."""
    cfg, rp = zoo["cfg"], zoo["rp"]
    mine, specs = ModelAPI(cfg).init(torch.Generator().manual_seed(0))
    stacks = (("encoder", "decoder") if cfg.family == "encdec"
              else ("blocks",))

    def walk(got, want, path):
        if isinstance(want, dict):
            assert sorted(got.keys()) == sorted(want), path
            for k in want:
                walk(got[k], want[k], f"{path}.{k}")
        else:
            assert tuple(got.shape) == tuple(want.shape), path
            assert got.dtype == torch.float32 and not got.requires_grad

    for name in rp:
        if name in stacks:
            for i, layer in enumerate(mine[name]):
                walk(layer, jax.tree_util.tree_map(lambda x: x[i], rp[name]),
                     f"{name}[{i}]")
        else:
            walk(mine[name], rp[name], name)
    if cfg.family == "encdec":  # the decoder cache: the reference's layout
        _close_trees(encdec.init_dec_cache(cfg, B, 12),
                     ref_encdec.init_dec_cache(zoo["rc"], B, 12), "cache")
    if cfg.dense_residual:  # Arctic: the dense MLP beside the experts
        assert all("ffn_dense" in blk["sub0"] for blk in mine["blocks"])
    if cfg.family == "hybrid":
        sub = mine["blocks"][0]
        assert [("wq" in sub[f"sub{r}"]["mixer"],
                 "router" in sub[f"sub{r}"]["ffn"]) for r in range(8)] == [
            (r == 4, r % 2 == 1) for r in range(8)]
        cache = lm.init_cache(cfg, 2, 16)
        assert [sorted(cache[f"sub{r}"]) for r in range(8)] == [
            ["k", "v"] if r == 4 else ["conv", "ssm"] for r in range(8)]
    norm_dicts = {"norm1", "norm2", "norm_x", "enc_norm", "final_norm"}
    left_out = sum(x.numel() for n, x in mine.named_parameters()
                   if n.split(".")[-2] in norm_dicts
                   or n.endswith(".D_skip"))
    assert sum(x.numel() for x in mine.parameters()) - left_out == \
        cfg.param_count()
    assert sorted(specs[stacks[0]]) == sorted(rp[stacks[0]])


def test_arch_matches_reference(zoo):
    """Reduced config of each new architecture (Jamba at one pattern
    instance; Arctic's MoE with its dense residual) on both routes
    (use_kernel False / True: the kernels' plain versions on the CPU):
    the forward (an enc-dec's functions one by one), prefill + decode
    (the caches; an enc-dec's cross K / V in the state, its cross- and
    self-attention steps on K6's plain version), the loss, and the init
    tree."""
    for use_kernel in (False, True):
        _check_forward(zoo, use_kernel)
        _check_prefill_and_decode(zoo, use_kernel)
        _check_loss(zoo, use_kernel)
    _check_init_tree(zoo)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch):
    for reduced in (False, True):
        cfg, rcfg = get_config(arch), ref_get_config(arch)
        if reduced:
            cfg, rcfg = cfg.reduced(), rcfg.reduced()
        assert cfg.param_count() == rcfg.param_count()
        assert cfg.active_param_count() == rcfg.active_param_count()
        fields = {f.name for f in dataclasses.fields(cfg)}
        assert {f.name for f in dataclasses.fields(rcfg)} - fields == {
            "scan_layers", "use_bias"}
        for name in fields - {"dtype_name"}:
            assert getattr(cfg, name) == getattr(rcfg, name), name
        assert cfg.dtype == (torch.float32 if reduced else torch.bfloat16)


# ---------------------------------------------------------------------------
# the MoE FFN

def _moe_case(arch, E, K, seed=3, S=24):
    """A reduced MoE config with the full model's experts and top-k,
    expert weights drawn with numpy from ``seed`` at the reference's
    scales (``init_moe``), and an input (2, S, D)."""
    rc = dataclasses.replace(ref_get_config(arch).reduced(), num_experts=E,
                             top_k=K)
    pc = dataclasses.replace(get_config(arch).reduced(), num_experts=E,
                             top_k=K)
    rng = np.random.default_rng(seed)
    D, dff = pc.d_model, pc.moe_d_ff or pc.d_ff
    shapes = {"router": ((D, E), D), "w_up": ((E, D, dff), D),
              "w_gate": ((E, D, dff), D), "w_down": ((E, dff, D), dff)}
    rp = {k: (rng.standard_normal(s) * (2.0 / fan) ** 0.5).astype(np.float32)
          for k, (s, fan) in shapes.items()}
    x = rng.standard_normal((2, S, D)).astype(np.float32)
    return rc, pc, rp, {k: torch.tensor(v) for k, v in rp.items()}, x


MOE_CASES = [("olmoe-1b-7b", 64, 8), ("arctic-480b", 128, 2),
             ("jamba-v0.1-52b", 16, 2)]


@pytest.mark.parametrize("impl", ["capacity", "dropless", "dropless grouped"])
@pytest.mark.parametrize("arch,E,K", MOE_CASES)
def test_moe_ffn_matches_reference(arch, E, K, impl, monkeypatch):
    """moe_ffn / moe_ffn_dropless against the reference's: equal routing
    indices (in lax.top_k's descending order), outputs and aux loss.  The
    dropless form takes 48 tokens densely; 144 (more than DENSE_TOKENS, a
    prefill) take the sorted grouped form, which also equals the dense
    form on the same routing."""
    grouped = impl == "dropless grouped"
    rc, pc, rp, p, x = _moe_case(arch, E, K, S=72 if grouped else 24)
    assert (x.shape[0] * x.shape[1] > moe.DENSE_TOKENS) == grouped
    probs, top_w, top_i = moe.route(pc, p, torch.tensor(x))
    r_w, r_i = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ rp["router"]),
                             K)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(r_i))
    _close(top_w, np.asarray(r_w) / np.asarray(r_w).sum(-1, keepdims=True))
    forms = []
    for name in ("_dropless_dense", "_dropless_grouped"):
        real = getattr(moe, name)
        monkeypatch.setattr(moe, name, lambda *a, _real=real, _name=name: (
            forms.append(_name), _real(*a))[1])
    ref_fn, fn = ((ref_moe.moe_ffn, moe.moe_ffn) if impl == "capacity" else
                  (ref_moe.moe_ffn_dropless, moe.moe_ffn_dropless))
    want, want_aux = jax.jit(ref_fn, static_argnums=0)(rc, rp,
                                                       jnp.asarray(x))
    got, aux = fn(pc, p, torch.tensor(x))
    _close(got, want)
    assert float(aux) == pytest.approx(float(want_aux), rel=2e-5, abs=2e-5)
    assert forms == {"capacity": [], "dropless": ["_dropless_dense"],
                     "dropless grouped": ["_dropless_grouped"]}[impl]
    if grouped:
        D = pc.d_model
        dense = moe._dropless_dense(pc, p, torch.tensor(x).reshape(-1, D),
                                    top_w.reshape(-1, K),
                                    top_i.reshape(-1, K))
        _close(dense, got.reshape(-1, D))


def test_capacity_drops_overflow_tokens():
    """At capacity_factor 0.5 (4 experts top-2, 24 tokens a group: C = 6,
    room for 24 of the 48 routed slots) the dispatch fills each expert's
    C places in the group's (token, slot) order and drops the rest: the
    output equals the reference's, and differs from the dropless form at
    exactly the tokens that lost a slot."""
    rc, pc, rp, p, x = _moe_case("olmoe-1b-7b", 4, 2)
    rc, pc = (dataclasses.replace(c, capacity_factor=0.5) for c in (rc, pc))
    _, top_w, top_i = moe.route(pc, p, torch.tensor(x))
    C = moe.capacity(pc, 24)
    dispatch, _ = moe.dispatch_combine(pc, top_w, top_i, C)
    assert C == 6 and dispatch.shape == (2, 24, 4, C)
    assert torch.equal(dispatch.sum(dim=1).amax(-1),
                       torch.ones(2, 4))  # each place holds one token
    dropped = dispatch.sum(dim=(2, 3)) < 2  # a token lost a slot
    assert int(dispatch.sum()) <= 2 * 4 * C and bool(dropped.any())
    cap, _ = moe.moe_ffn(pc, p, torch.tensor(x))
    _close(cap, jax.jit(ref_moe.moe_ffn, static_argnums=0)(
        rc, rp, jnp.asarray(x))[0])
    free, _ = moe.moe_ffn_dropless(pc, p, torch.tensor(x))
    same = torch.isclose(cap, free, rtol=1e-5, atol=1e-5).all(-1)
    assert torch.equal(~same, dropped)


def test_moe_capacity_matches_dropless_when_no_drops():
    """The port's own form of the reference's check
    (tests/test_models.py:156-168): with capacity_factor = E no token
    overflows, so the GShard form equals the dropless one."""
    cfg = get_config("olmoe-1b-7b").reduced()
    params, _ = lm.init_lm(cfg, torch.Generator().manual_seed(0))
    toks = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 32)), dtype=torch.int32)
    h1, _, a1 = lm.forward(dataclasses.replace(
        cfg, capacity_factor=float(cfg.num_experts)), params, toks)
    h2, _, a2 = lm.forward(dataclasses.replace(cfg, moe_impl="dropless"),
                           params, toks)
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), rtol=1e-4, atol=1e-4)
    assert float(a1) == pytest.approx(float(a2), rel=1e-6)


def test_dropless_generate_matches_unbatched():
    """Batch composition does not change dropless greedy outputs (the
    reference's check, tests/test_serve.py:44-58; moe_ffn_dropless is
    held against the reference's above)."""
    pc = dataclasses.replace(get_config("olmoe-1b-7b").reduced(),
                             moe_impl="dropless")
    p, _ = ModelAPI(pc).init(torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(2).integers(
        0, pc.vocab_size, (2, 8)).astype(np.int32)
    eng = ServingEngine(pc, p, max_len=32, device="cpu")
    batched = eng.generate(prompts, steps=4).numpy()
    singles = [eng.generate(prompts[i:i + 1], steps=4).numpy()[0]
               for i in range(2)]
    np.testing.assert_array_equal(batched, np.stack(singles))


# ---------------------------------------------------------------------------
# the encoder-decoder's kernel routes

def test_cross_attention_step_takes_the_decode_route(monkeypatch):
    """With use_kernel a decode step's cross-attention is one query row
    against the S_src memory rows: ops.decode_attention (K6) with
    cache_len = S_src, beside the self-attention's call; at prefill the
    cross-attention goes to ops.flash_attention (K5), non-causal."""
    from repro_torch.kernels import ops
    _, pc = _cfgs("seamless-m4t-medium")
    api = ModelAPI(pc)
    p, _ = api.init(torch.Generator().manual_seed(0))
    calls = []
    for name in ("decode_attention", "flash_attention"):
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append((_name, a[1].shape[1], a[3] if len(a) > 3 else
                          kw.get("causal")))
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, spy)
    tb = _t(_batch(pc))
    _, state = api.prefill_step(p, _prompt(tb, tb["tokens"][:, :PROMPT]),
                                max_len=16, use_kernel=True)
    L = pc.num_layers
    assert calls == ([("flash_attention", SRC, False)] * pc.enc_layers
                     + [("flash_attention", SRC, False)] * L)
    calls.clear()
    api.decode_step(p, tb["tokens"][:, PROMPT:PROMPT + 1], state,
                    use_kernel=True)
    assert calls == [("decode_attention", 16, PROMPT + 1),
                     ("decode_attention", SRC, SRC)] * L


# ---------------------------------------------------------------------------
# the serving entry point

OLMOE_ARGV = ["--arch", "olmoe-1b-7b", "--reduced", "--slots", "10",
              "--devices", "8"]


def test_olmoe_serving_loop_matches_reference(monkeypatch, capsys):
    """``launch.serve --arch olmoe-1b-7b --reduced`` (K3's and K6's plain
    versions on the CPU, the capacity MoE in every layer) prints the
    reference's lines."""
    import sys
    from repro.launch import serve as ref_serve
    monkeypatch.setattr(sys, "argv", ["serve", *OLMOE_ARGV])
    ref_serve.main()
    want = capsys.readouterr().out.splitlines()
    port_serve.main([*OLMOE_ARGV, "--device", "cpu"])
    assert capsys.readouterr().out.splitlines() == want
    assert len(want) == 2 and "decode calls" in want[-1]


def test_serve_rejects_an_encoder_decoder():
    """The engine serves token batches, as the reference's: an
    encoder-decoder needs its source frames (ModelAPI.prefill_step with
    ``src_embeds``), so the serving loop says so before its first slot
    (the reference's fails at its first wave, on the missing key)."""
    with pytest.raises(ValueError, match="src_embeds"):
        port_serve.main(["--arch", "seamless-m4t-medium", "--reduced",
                         "--device", "cpu"])
