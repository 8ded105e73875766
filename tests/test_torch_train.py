"""The training substrate of the port against the JAX package, on the CPU.

Same inputs (numpy, from a seed; the reference's weights carried across
by ``interop``) through both packages:

- the optimizers: AdamW, Adafactor (factored and not, its update clip
  over a stacked leaf) and SGD, three updates of the same params and
  grads, at rtol=1e-6, atol=1e-7; clipping; the cosine schedule;
- loss and gradients of five reduced families (olmo-1b, mamba2-370m,
  olmoe-1b-7b, Jamba at one pattern instance, seamless): the loss within
  1e-5 relative of ``jax.value_and_grad(api.loss)``'s, every gradient
  leaf within 1e-4 of its max |grad| (the port's per-instance leaves
  stacked as the reference's); ``remat="full"`` and ``"dots"`` give
  ``"none"``'s loss and gradients;
- three ``make_train_step`` steps of reduced olmo-1b, with and without
  ``accum_steps=2``: losses within 1e-5 relative, every parameter leaf
  within 1e-4 of its max |value|;
- checkpoints: round trip, torn-write skip, rotation, a port checkpoint
  restored by the reference and a reference checkpoint restored by the
  port (AdamW and Adafactor states, bf16 and float32 leaves), resume,
  preemption, a missing leaf;
- the prefetch straggler, int8 quantization (bit for bit), the LM token
  stream (bit for bit) and ``launch.train`` on the CPU.

The kernel route's grad guard is a card test (tests/test_torch_cuda.py).
"""

import dataclasses
import os
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data import lm_data as ref_lm_data
from repro.models.api import ModelAPI as RefAPI
from repro.train import checkpoint as ref_ckpt
from repro.train import compression as ref_comp
from repro.train import optimizer as ref_opt
from repro.train import trainer as ref_trainer
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.data import lm_data
from repro_torch.models.api import ModelAPI
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compression as comp
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import (PrefetchIterator, TrainLoop,
                                       TrainState, make_train_step)

OPT_TOL = dict(rtol=1e-6, atol=1e-7)
LOSS_REL = 1e-5
GRAD_FRAC = 1e-4  # of the leaf's max |grad| (or |param|)
B, S, SRC = 2, 16, 16
FAMILIES = ["olmo-1b", "mamba2-370m", "olmoe-1b-7b", "jamba-v0.1-52b",
            "seamless-m4t-medium"]

# torch's first float32 exp over a large CPU tensor, in a process that has
# loaded JAX, is now and then off by up to 1e-4 relative (ROADMAP.md C7)
torch.exp(torch.zeros(1 << 16))


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test process: these tests run thousands of
    small products, and the suite runs several processes on the CPU
    cores, where more threads than cores wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in ref_ckpt._flatten_with_paths(tree)}


def _port_flat(tree) -> dict:
    """The port's state tree as the reference lays it out: {key: array}
    with a layer stack's instances stacked (what a checkpoint holds)."""
    return {k: a.view(jnp.bfloat16) if d == "bfloat16" else a
            for k, (a, d) in ckpt.host_leaves(tree).items()}


def _leaves_close(got: dict, want: dict, frac=GRAD_FRAC, what=""):
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        g = np.asarray(got[k], np.float32)
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, (what, k)
        tol = frac * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol,
                                   err_msg=f"{what} {k}")


# ---------------------------------------------------------------------------
# optimizers

def _opt_case(seed=0):
    """Reference params / grads (numpy) with a stacked leaf of 3
    instances, a factored (8, 6) matrix at factored_min 4, and vectors;
    the port's as named tensors (the stack as a list)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    ref = {"blocks": {"w": f(3, 8, 6), "s": f(3, 5)}, "m": f(8, 6),
           "b": f(7)}
    grads = [{"blocks": {"w": f(3, 8, 6), "s": f(3, 5)}, "m": f(8, 6),
              "b": f(7)} for _ in range(3)]

    def port(t):
        return {"blocks": [{"w": torch.tensor(t["blocks"]["w"][i]),
                            "s": torch.tensor(t["blocks"]["s"][i])}
                           for i in range(3)],
                "m": torch.tensor(t["m"]), "b": torch.tensor(t["b"])}

    def names(t):
        from repro_torch.train.tree import named_leaves
        return named_leaves(port(t))

    return ref, grads, port(ref), [names(g) for g in grads]


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_optimizer_updates_match_reference(name):
    """Three updates (clipped at 1.0, weight decay 0.1, a float32 lr
    tensor) of the same params and grads give the reference's params and
    state."""
    spec_kw = dict(name=name, lr=0.05, factored_min=4)
    ref_p, ref_g, p, g = _opt_case()
    rspec, spec = ref_opt.OptimizerSpec(**spec_kw), opt.OptimizerSpec(
        **spec_kw)
    rp = jax.tree.map(jnp.asarray, ref_p)
    rstate = ref_opt.init_opt_state(rspec, rp)
    state = opt.init_opt_state(spec, p)
    lr_r = ref_opt.cosine_schedule(0.05, 2, 10)
    lr_p = opt.cosine_schedule(0.05, 2, 10)
    for i in range(3):
        rp, rstate, rnorm = ref_opt.apply_update(
            rspec, rp, jax.tree.map(jnp.asarray, ref_g[i]), rstate,
            lr_r(jnp.int32(i)))
        p, state, norm = opt.apply_update(spec, p, g[i], state,
                                          lr_p(torch.tensor(i)))
        np.testing.assert_allclose(float(norm), float(rnorm), rtol=1e-6)
    for got, want in ((_port_flat(p), _ref_flat(rp)),
                      (_port_flat(state), _ref_flat(rstate))):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **OPT_TOL)
    if name == "adafactor":  # the (8, 6) leaves are factored
        assert set(state["v"]["m"]) == {"vr", "vc"}
        assert set(state["v"]["b"]) == {"v"}


def test_clip_and_schedule_match_reference():
    g = {"a": np.full((4,), 100.0, np.float32),
         "b": np.arange(3, dtype=np.float32)}
    rclip, rnorm = ref_opt.clip_by_global_norm(
        jax.tree.map(jnp.asarray, g), 1.0)
    clip, norm = opt.clip_by_global_norm(
        {k: torch.tensor(v) for k, v in g.items()}, 1.0)
    assert float(norm) == pytest.approx(float(rnorm), rel=1e-6)
    for k in g:
        np.testing.assert_allclose(clip[k].numpy(), np.asarray(rclip[k]),
                                   **OPT_TOL)
    assert float(opt.global_norm(clip)) == pytest.approx(1.0, rel=1e-5)
    rlr = ref_opt.cosine_schedule(1.0, warmup=10, total=100)
    lr = opt.cosine_schedule(1.0, warmup=10, total=100)
    steps = np.arange(0, 120, 7, dtype=np.int32)
    np.testing.assert_allclose(
        lr(torch.tensor(steps)).numpy(), np.asarray(rlr(jnp.asarray(steps))),
        **OPT_TOL)
    assert float(lr(torch.tensor(0))) < float(lr(torch.tensor(9)))
    assert float(lr(torch.tensor(99))) < 0.2


# ---------------------------------------------------------------------------
# loss and gradients of the model zoo

def _cfgs(arch, **kw):
    rc, pc = ref_get_config(arch).reduced(), get_config(arch).reduced()
    if pc.family == "hybrid":  # one pattern instance (8 layers)
        kw["num_layers"] = pc.pattern_period
    return dataclasses.replace(rc, **kw), dataclasses.replace(pc, **kw)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S + 1)
                                  ).astype(np.int32)}
    if cfg.family == "encdec":
        out["src_embeds"] = (0.1 * rng.standard_normal(
            (B, SRC, cfg.d_model))).astype(np.float32)
    return out


def _params_from(rp, cfg):
    rp = jax.tree_util.tree_map(np.asarray, rp)
    fn = (interop.encdec_params_from if cfg.family == "encdec"
          else interop.model_params_from)
    return fn(rp, cfg, device="cpu")


def _port_grads(cfg, p, batch):
    api = ModelAPI(cfg)
    leaves = dict(p.named_parameters())
    for t in leaves.values():
        t.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = api.loss(p, tb)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(arch):
    """The loss (xent + 0.01 aux) and every gradient leaf against
    jax.value_and_grad of the reference's loss on its weights; remat
    "full" and "dots" against "none" in the port."""
    rc, pc = _cfgs(arch)
    rp, _ = RefAPI(rc).init(jax.random.PRNGKey(0))
    batch = _batch(pc)
    (rloss, _), rgrads = jax.jit(jax.value_and_grad(
        RefAPI(rc).loss, has_aux=True))(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _port_grads(pc, _params_from(rp, pc), batch)
    assert loss == pytest.approx(float(rloss), rel=LOSS_REL)
    _leaves_close(_port_flat(grads), _ref_flat(rgrads), what=arch)
    for remat in ("full", "dots"):
        cfg = dataclasses.replace(pc, remat=remat)
        r_loss, r_grads = _port_grads(cfg, _params_from(rp, cfg), batch)
        assert r_loss == pytest.approx(loss, rel=1e-6), remat
        for k, g in grads.items():
            np.testing.assert_allclose(r_grads[k].numpy(), g.numpy(),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"{remat} {k}")


def test_remat_recomputes():
    """The backward of remat="full" recomputes a pattern instance's matrix
    products; "dots" keeps them (no product more than "none" runs)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
                CountMM.n += 1
            return func(*args, **(kwargs or {}))

    rc, pc = _cfgs("olmo-1b")
    rp, _ = RefAPI(rc).init(jax.random.PRNGKey(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch(pc).items()}
    backward_mm = {}
    for remat in ("none", "dots", "full"):
        cfg = dataclasses.replace(pc, remat=remat)
        p = _params_from(rp, cfg)
        p.requires_grad_(True)
        loss, _ = ModelAPI(cfg).loss(p, batch)
        CountMM.n = 0
        with CountMM():
            loss.backward()
        backward_mm[remat] = CountMM.n
    assert backward_mm["dots"] == backward_mm["none"] < backward_mm["full"], \
        backward_mm


# ---------------------------------------------------------------------------
# train steps

@pytest.fixture(scope="module")
def olmo_steps():
    """Three steps of reduced olmo-1b (AdamW, launch.train's cosine
    schedule) in the reference, with accum_steps 1 and 2: the start
    params, the batches, the losses and the final state."""
    rc, pc = _cfgs("olmo-1b")
    api = RefAPI(rc)
    rp, _ = api.init(jax.random.PRNGKey(0))
    spec = ref_opt.OptimizerSpec(name="adamw", lr=1e-3)
    lr_fn = ref_opt.cosine_schedule(1e-3, warmup=5, total=100)
    batches = [_batch(pc, seed=s) for s in range(3)]
    out = {"rp": rp, "batches": batches, "cfg": (rc, pc)}
    for accum in (1, 2):
        step = jax.jit(ref_trainer.make_train_step(api.loss, spec, lr_fn,
                                                   accum_steps=accum))
        st = ref_trainer.TrainState.create(rp, spec)
        losses = []
        for b in batches:
            st, m = step(st, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
        out[accum] = (st, losses)
    return out


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_reference(olmo_steps, accum):
    rc, pc = olmo_steps["cfg"]
    spec = opt.OptimizerSpec(name="adamw", lr=1e-3)
    step = make_train_step(ModelAPI(pc).loss, spec,
                           opt.cosine_schedule(1e-3, warmup=5, total=100),
                           accum_steps=accum)
    st = TrainState.create(_params_from(olmo_steps["rp"], pc), spec)
    losses = []
    for b in olmo_steps["batches"]:
        st, m = step(st, b)
        losses.append(float(m["loss"]))
    rst, rlosses = olmo_steps[accum]
    np.testing.assert_allclose(losses, rlosses, rtol=LOSS_REL)
    assert int(st.step) == int(rst.step) == 3
    _leaves_close(_port_flat(st.params), _ref_flat(rst.params),
                  what="params")
    _leaves_close(_port_flat(st.opt_state["m"]),
                  _ref_flat(rst.opt_state["m"]), what="m")


def test_train_state_carries_across(olmo_steps):
    """interop.train_state_from gives the reference's state leaf for leaf,
    and a step from it continues the reference's run."""
    rc, pc = olmo_steps["cfg"]
    rst, _ = olmo_steps[1]
    np_state = jax.tree.map(np.asarray, rst)
    st = interop.train_state_from(
        np_state, _params_from(rst.params, pc), device="cpu")
    want = _ref_flat(rst)
    got = _port_flat(st)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert all(p.requires_grad for p in st.params.parameters())


# ---------------------------------------------------------------------------
# checkpoints

def test_roundtrip_and_atomicity():
    tree = {"a": torch.arange(10.0), "b": {"c": torch.ones(
        (3, 4), dtype=torch.bfloat16)}, "n": torch.tensor(5, dtype=torch.int32)}
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 7, tree)
        assert ckpt.latest_step(d) == 7
        back = ckpt.restore(d, 7, tree)
        assert torch.equal(back["a"], tree["a"])
        assert back["b"]["c"].dtype == torch.bfloat16
        assert torch.equal(back["b"]["c"], tree["b"]["c"])
        assert back["n"].shape == () and int(back["n"]) == 5
        # a torn write is invisible
        os.makedirs(os.path.join(d, "step_00000009.tmp-zz"), exist_ok=True)
        assert ckpt.latest_step(d) == 7
        with pytest.raises(KeyError):
            ckpt.restore(d, 7, {"z": torch.zeros(3)})


def test_manager_rotation_and_latest():
    tree = {"x": torch.zeros(4)}
    with tempfile.TemporaryDirectory() as d:
        mgr = ckpt.CheckpointManager(d, keep=2, async_write=False)
        for s in (1, 2, 3, 4):
            mgr.save(s, tree)
        assert mgr.latest() == 4
        assert len([k for k in os.listdir(d) if k.startswith("step_")]) == 2
        amgr = ckpt.CheckpointManager(d, keep=2)  # the background writer
        t = {"x": torch.ones(4)}
        amgr.save(5, t)
        t["x"] += 1  # written in place after the save: not in the file
        assert amgr.latest() == 5
        assert float(ckpt.restore(d, 5, tree)["x"].sum()) == 4.0


@pytest.mark.parametrize("arch,dtype", [("olmo-1b", "bfloat16"),
                                        ("deepseek-67b", "float32")],
                         ids=["adamw-bf16", "adafactor-f32"])
def test_checkpoints_cross_packages(arch, dtype):
    """A train state one step in (olmo: AdamW over bf16 params; deepseek:
    Adafactor, its (128, 256) leaves factored) saved by either package
    restores in the other, leaf for leaf."""
    rc, pc = _cfgs(arch, dtype_name=dtype)
    assert rc.optimizer == pc.optimizer
    rp, _ = RefAPI(rc).init(jax.random.PRNGKey(1))
    spec = ref_opt.OptimizerSpec(name=rc.optimizer, lr=1e-3)
    step = jax.jit(ref_trainer.make_train_step(
        RefAPI(rc).loss, spec, lambda s: 1e-3))
    rst, _ = step(ref_trainer.TrainState.create(rp, spec),
                  {k: jnp.asarray(v) for k, v in _batch(pc).items()})
    pst = interop.train_state_from(jax.tree.map(np.asarray, rst),
                                   _params_from(rst.params, pc),
                                   device="cpu")
    with tempfile.TemporaryDirectory() as d:
        ref_ckpt.save(d, 1, rst)  # reference -> port
        back = _port_flat(ckpt.restore(d, 1, pst))
        for k, v in _ref_flat(rst).items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)
        ckpt.save(d, 2, pst)  # port -> reference
        rback = _ref_flat(ref_ckpt.restore(d, 2, rst))
        for k, v in _port_flat(pst).items():
            np.testing.assert_array_equal(rback[k], v, err_msg=k)
        # the same keys, shapes and dtypes, in the same order
        assert (ref_ckpt.manifest(d, 1)["leaves"]
                == ckpt.manifest(d, 2)["leaves"])


def _quadratic_loss(params, batch):
    return torch.sum((params["w"] - batch["target"]) ** 2), {}


def _sgd_loop(d, **kw):
    spec = opt.OptimizerSpec(name="sgd", lr=0.1, grad_clip=0.0)
    step = make_train_step(_quadratic_loss, spec, lambda s: 0.1)
    mgr = ckpt.CheckpointManager(d, async_write=False)
    loop = TrainLoop(step, mgr, log_fn=lambda *a: None, **kw)
    return loop, mgr, spec


def test_resume_training_continues():
    batch = {"target": np.zeros((4,), np.float32)}
    with tempfile.TemporaryDirectory() as d:
        loop, mgr, spec = _sgd_loop(d, ckpt_every=5, log_every=100)
        state, _ = loop.run(TrainState.create({"w": torch.full((4,), 3.0)},
                                              spec),
                            iter([batch] * 100), num_steps=10)
        w10 = state.params["w"].detach().clone()
        loop2, _, _ = _sgd_loop(d, ckpt_every=5, log_every=100)
        state2, _ = loop2.run(TrainState.create(
            {"w": torch.full((4,), 3.0)}, spec), iter([batch] * 100),
            num_steps=20)
        assert int(state2.step) == 20
        restart = ckpt.restore(d, 10, TrainState.create(
            {"w": torch.zeros(4)}, spec))
        assert torch.equal(restart.params["w"].detach(), w10)
        # 20 steps of w <- 0.8 w from 3, through the restart
        np.testing.assert_allclose(state2.params["w"].detach().numpy(),
                                   3 * 0.8 ** 20, rtol=1e-5)


def test_preemption_saves():
    batch = {"target": np.zeros((4,), np.float32)}
    with tempfile.TemporaryDirectory() as d:
        loop, mgr, spec = _sgd_loop(d, ckpt_every=1000, log_every=1000)

        def batches():
            for i in range(100):
                if i == 3:
                    loop.preempt()  # simulated SIGTERM
                yield batch

        state, _ = loop.run(TrainState.create({"w": torch.ones(4)}, spec),
                            batches(), num_steps=100)
        assert int(state.step) <= 5
        assert mgr.latest() == int(state.step)


def test_straggler_reuses_last_batch():
    def slow_gen():
        yield {"i": 0}
        time.sleep(0.5)
        yield {"i": 1}

    it = PrefetchIterator(slow_gen(), depth=1, deadline_s=0.05)
    a = next(it)
    b = next(it)  # deadline hit -> reuse
    assert a["i"] == 0 and b["i"] == 0
    assert it.stragglers >= 1
    time.sleep(0.6)
    assert next(it)["i"] == 1


# ---------------------------------------------------------------------------
# compression, LM data, the entry point

def test_quantize_int8_bit_equal():
    x = np.random.default_rng(0).normal(0, 3, (4096,)).astype(np.float32)
    x[:3] = [0.0, 1e-30, -7.25]
    rq, rs = ref_comp.quantize_int8(jnp.asarray(x))
    q, s = comp.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert q.dtype == torch.int8
    assert float(s) == float(rs)
    np.testing.assert_array_equal(comp.dequantize_int8(q, s).numpy(),
                                  np.asarray(ref_comp.dequantize_int8(rq, rs)))
    res = comp.init_residual({"w": torch.ones(2, 3, dtype=torch.bfloat16)})
    assert res["w"].dtype == torch.float32 and res["w"].shape == (2, 3)


def test_token_stream_bit_equal():
    spec = dict(vocab_size=97, batch=3, seq_len=20, seed=5)
    got, want = (lm_data.token_stream(lm_data.LMStreamSpec(**spec)),
                 ref_lm_data.token_stream(ref_lm_data.LMStreamSpec(**spec)))
    for _ in range(3):
        np.testing.assert_array_equal(next(got)["tokens"],
                                      next(want)["tokens"])
    assert (lm_data.conditional_entropy(lm_data.LMStreamSpec(**spec))
            == ref_lm_data.conditional_entropy(
                ref_lm_data.LMStreamSpec(**spec)))


def test_launch_train_resumes(capsys):
    """python -m repro_torch.launch.train --reduced --device cpu: the
    reference's lines; a second run resumes from the first's checkpoint
    and its history continues; a SIGTERM-like preemption saves."""
    from repro_torch.launch import train
    argv = ["--arch", "olmo-1b", "--reduced", "--device", "cpu",
            "--batch", "2", "--seq-len", "16", "--ckpt-every", "4"]
    with tempfile.TemporaryDirectory() as d:
        st, hist = train.main(argv + ["--steps", "10", "--ckpt-dir", d])
        assert int(st.step) == 10 and [h["step"] for h in hist] == [10]
        st, hist = train.main(argv + ["--steps", "20", "--ckpt-dir", d])
        out = capsys.readouterr().out
        assert "[trainer] resumed from step 10" in out
        assert "[train] arch=olmo-1b-smoke params~" in out
        assert "[train] synthetic stream loss floor ~" in out
        assert int(st.step) == 20 and [h["step"] for h in hist] == [20]
        assert np.isfinite(hist[-1]["loss"])
        assert ckpt.latest_step(d) == 20
