"""The port's dry run (``repro_torch.launch.dryrun``), its abstract specs
and the sharding rules at full width, against the JAX package's, on the
CPU.

Three processes run side by side (one module fixture):

- the reference (JAX, 512 forced host devices) dumps, for every arch: the
  abstract params, batch and serve-state specs, the optimizer states'
  shapes and axes, the shape-aware specs on both production meshes, each
  cell's skip reason and model FLOPs (its compiles stubbed: no compile is
  needed for them), the per-chip argument bytes of olmo-1b x train_4k on
  (16, 16) (``NamedSharding.shard_shape``), and the reduced olmo-1b and
  mamba2-370m (511-row vocabulary) train cells compiled on a (2, 2) host
  mesh (``probe_costs=False``);
- the port, in fake worlds (``launch.mesh.fake_world``): olmo-1b x
  train_4k's arguments placed on (16, 16), the two reduced train cells
  traced on a fake (2, 2) mesh (mamba2's once more under torch 2.11's
  additive plans), ``shard`` under a mesh; then, in a gloo world of one,
  the reduced olmo-1b's records on a (1, 1) mesh against its real steps;
- the port's CLI: ``python -m repro_torch.launch.dryrun --arch olmo-1b
  --shape train_4k --device cpu`` on the (16, 16) mesh.

The specs are compared leaf for leaf in the reference's layout: the
port's per-instance leaves of a layer list are stacked back on their
"layers" axis (``train.tree.ref_key``).
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
from test_torch_parallel import FakeMesh

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.launch import dryrun
from repro_torch.models.api import ModelAPI
from repro_torch.parallel.sharding import shape_aware_spec_tree
from repro_torch.train import optimizer as opt
from repro_torch.train.tree import leaf_axes, named_leaves, ref_key

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300
MESHES = {"16x16": FakeMesh({"data": 16, "model": 16}),
          "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16})}

REFERENCE = """
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import SHAPES, get_config, list_archs
from repro.launch import dryrun
from repro.launch.mesh import make_production_mesh
from repro.models.api import ModelAPI
from repro.parallel.sharding import shape_aware_spec_tree
from repro.train import optimizer as opt

assert jax.device_count() == 512
meshes = {"16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True)}


def walk(tree, axes, path, fn, acc):
    if isinstance(tree, dict):
        for k in tree:
            walk(tree[k], None if axes is None else axes[k], path + (str(k),),
                 fn, acc)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            walk(v, None if axes is None else axes[i], path + (str(i),), fn,
                 acc)
    else:
        acc["/".join(path)] = fn(tree, axes)
    return acc


def desc(s, a):
    return [list(s.shape), str(s.dtype), None if a is None else list(a)]


def spec(ns, _):
    return [list(e) if isinstance(e, tuple) else e for e in ns.spec]


out = {"archs": {}, "cells": {}}
for arch in list_archs():
    cfg = get_config(arch)
    api = ModelAPI(cfg)
    shapes, logical = api.abstract_params()
    rec = {"params": walk(shapes, logical, (), desc, {}), "specs": {},
           "opt": {}, "batch": {}, "state": {}}
    for name, mesh in meshes.items():
        sh = shape_aware_spec_tree(shapes, logical, mesh=mesh)
        rec["specs"][name] = walk(sh, None, (), spec, {})
    for name in ("adamw", "adafactor", "sgd"):
        ospec = opt.OptimizerSpec(name=name)
        st = jax.eval_shape(lambda: opt.init_opt_state(ospec, jax.tree.map(
            lambda s: jnp.zeros(s.shape, s.dtype), shapes)))
        rec["opt"][name] = walk(st, opt.opt_state_specs(ospec, shapes,
                                                        logical), (), desc, {})
    for sname, shp in SHAPES.items():
        rec["batch"][sname] = walk(*api.batch_specs(shp), (), desc, {})
        rec["state"][sname] = walk(*api.serve_state_specs(shp), (), desc, {})
    out["archs"][arch] = rec


class Compiled:  # a compile stub: the cells' records without compiling
    def cost_analysis(self):
        return {"flops": 1.0, "bytes accessed": 1.0}

    def memory_analysis(self):
        class M:
            generated_code_size_in_bytes = argument_size_in_bytes = 0
            output_size_in_bytes = temp_size_in_bytes = 0
            alias_size_in_bytes = 0
        return M()

    def as_text(self):
        return ""


compile_once = dryrun._compile_once
dryrun._compile_once = lambda *a, **k: (None, Compiled())
for arch in list_archs():
    for sname, shp in SHAPES.items():
        r = dryrun.run_cell(arch, sname, mesh=meshes["16x16"], verbose=False)
        out["cells"][f"{arch}/{sname}"] = {
            "skip": dryrun.skip_reason(get_config(arch), shp),
            **{k: r.get(k) for k in ("status", "model_flops", "param_count",
                                     "active_param_count")}}
        if r["status"] == "ok":
            out["ok_keys"] = sorted(r)
dryrun._compile_once = compile_once

_, args, shard, _ = dryrun.build_cell(get_config("olmo-1b"),
                                      SHAPES["train_4k"], meshes["16x16"])
out["train_4k_arg_bytes"] = sum(
    int(np.prod(s.shard_shape(a.shape))) * a.dtype.itemsize
    for a, s in zip(jax.tree.leaves(args), jax.tree.leaves(shard)))

mesh22 = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
r = dryrun.run_cell("olmo-1b", "train_4k", mesh=mesh22, probe_costs=False,
                    cfg_fn=lambda c: c.reduced(), verbose=False)
out["reduced22"] = {k: r.get(k) for k in ("status", "argument_size_in_bytes")}
r = dryrun.run_cell("mamba2-370m", "train_4k", mesh=mesh22, probe_costs=False,
                    cfg_fn=lambda c: dataclasses.replace(c.reduced(),
                                                         vocab_size=511),
                    verbose=False)
out["mamba22"] = {k: r.get(k) for k in ("status", "argument_size_in_bytes")}
json.dump(out, open(sys.argv[1], "w"))
"""

PORT = """
import dataclasses, json, logging, sys
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch.analysis.hlo_stats import CostTrace, cost_summary
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_test_mesh
from repro_torch.parallel.compile_mode import compile_options
from repro_torch.parallel.sharding import axis_rules, shard

logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
aten = torch.ops.aten


class AdditivePlans(TorchDispatchMode):
    \"\"\"Each add / sub of DTensors, planned as torch 2.11's DTensor plans
    it (torch/distributed/tensor/_ops/_pointwise_ops.py: pointwise_strategy,
    common_pointwise_strategy): the operand with the most shards (the first
    of several; the first of an in-place op) is followed, and its Partial
    placements are kept, so every other operand is redistributed to them.
    ``asked`` holds each redistribution from a Shard to a Partial that such
    a plan needs (torch 2.11 raises "not supported yet" there), with the
    autograd node it ran under.\"\"\"

    ADD = (aten.add.Tensor, aten.sub.Tensor)
    IN_PLACE = (aten.add_.Tensor, aten.sub_.Tensor)

    def __init__(self):
        super().__init__()
        self.asked = []
        self.seen = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = pytree.arg_tree_leaves(*args, **kwargs)
        if not any(isinstance(a, DTensor) for a in ins):
            return func(*args, **kwargs)
        ops = [a for a in args if isinstance(a, DTensor)]
        if func in self.ADD + self.IN_PLACE and len(ops) > 1:
            self.seen += 1
            led = ops[0] if func in self.IN_PLACE else max(
                ops, key=lambda a: (a._spec.num_shards, a.ndim))
            node = torch._C._current_autograd_node()
            for i, p in enumerate(led.placements):
                for a in ops:
                    if p.is_partial() and a.placements[i].is_shard():
                        self.asked.append([
                            type(node).__name__ if node else "forward",
                            str(func), [str(q) for q in a.placements],
                            [str(q) for q in led.placements],
                            list(a.shape)])
        return NotImplemented


out = {}
fake_world(256, "cpu")
mesh = dryrun.make_production_mesh(device="cpu")
with FakeTensorMode():
    _, args = dryrun.build_cell(get_config("olmo-1b"), SHAPES["train_4k"],
                                mesh)
    out["train_4k_arg_bytes"] = cost_summary(CostTrace(), args, ())[
        "argument_size_in_bytes"]
    state = args[0]
    out["placements"] = {
        "wq": [str(p) for p in
               state.params["blocks"][0]["sub0"]["mixer"]["wq"].placements],
        "m_wq": [str(p) for p in
                 state.opt_state["m"]["blocks.0.sub0.mixer.wq"].placements],
        "tokens": [str(p) for p in args[1]["tokens"].placements]}
    x = DTensor.from_local(torch.empty(16, 64), mesh, [Shard(0), Shard(1)],
                           run_check=False)
    with axis_rules(mesh=mesh):
        y = shard(x, "batch", None)
        out["shard"] = [str(p) for p in y.placements] + [list(
            y.to_local().shape)]
        out["same"] = shard(x, "batch", "mlp") is x
dist.destroy_process_group()

fake_world(4, "cpu")
rec = dryrun.run_cell("olmo-1b", "train_4k",
                      mesh=make_test_mesh((2, 2), device="cpu"),
                      cfg_fn=lambda c: c.reduced(), verbose=False)
out["reduced22"] = rec

# the reduced mamba2-370m, its vocabulary cut to 511 rows: as 50280 rows
# over 16, the model axis does not divide it, so the tied table lies whole
# over that axis while the logits split it; then the same step traced
# under AdditivePlans (no CostTrace)
odd = lambda c: dataclasses.replace(c.reduced(), vocab_size=511)
mesh = make_test_mesh((2, 2), device="cpu")
out["mamba22"] = dryrun.run_cell("mamba2-370m", "train_4k", mesh=mesh,
                                 cfg_fn=odd, verbose=False)
with FakeTensorMode():
    fn, args = dryrun.build_cell(odd(get_config("mamba2-370m")),
                                 SHAPES["train_4k"], mesh)
    plans = AdditivePlans()
    with compile_options(flash_block=2048), axis_rules(mesh=mesh), \\
            implicit_replication(), plans:
        fn(*args)
out["mamba22_plans"] = {"seen": plans.seen, "asked": plans.asked}
dist.destroy_process_group()

# a mesh of one over a gloo world of one: each record against the real
# step on plain tensors (FlopCounterMode's flops, a CostTrace's bytes)
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import ShapeConfig
from repro_torch.data.lm_data import LMStreamSpec, token_stream
from repro_torch.launch.mesh import world_of_one
from repro_torch.models import lm as LM
from repro_torch.models.api import ModelAPI
from repro_torch.parallel.compile_mode import compile_options
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import TrainState, make_train_step

world_of_one("cpu")
mesh = make_test_mesh((1, 1), device="cpu")
cfg = get_config("olmo-1b").reduced()
api = ModelAPI(cfg)
out["one"] = {}
for B, S, mode in ((4, 32, "train"), (2, 64, "prefill"), (4, 64, "decode")):
    rec = dryrun.run_cell("olmo-1b", ShapeConfig(mode, S, B, mode), mesh=mesh,
                          cfg_fn=lambda c: c.reduced(), verbose=False)
    gen = torch.Generator().manual_seed(0)
    params, _ = api.init(gen)
    if mode == "train":
        spec = opt.OptimizerSpec(name=cfg.optimizer)
        state = TrainState.create(params, spec)
        step = make_train_step(api.loss, spec,
                               opt.cosine_schedule(3e-4, 100, 10000))
        batch = {"tokens": torch.from_numpy(next(token_stream(LMStreamSpec(
            vocab_size=cfg.vocab_size, batch=B, seq_len=S)))["tokens"])}
        args, call = (state, batch), lambda: step(state, batch)
    elif mode == "prefill":
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                         generator=gen, dtype=torch.int32)}
        args = (params, batch)
        call = lambda: api.prefill_step(params, batch, S)
    else:
        token = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                              dtype=torch.int32)
        st = {"cache": LM.init_cache(cfg, B, S), "length": S - 1}
        args, call = (params, token, st), lambda: api.decode_step(params,
                                                                  token, st)
    grad = torch.enable_grad() if mode == "train" else torch.no_grad()
    with grad, compile_options(flash_block=2048):
        with FlopCounterMode(display=False) as fc:
            call()
        trace = CostTrace()
        with trace:
            res = call()
    real = cost_summary(trace, args, res)
    keys = ("argument_size_in_bytes", "temp_size_in_bytes")
    out["one"][mode] = {"status": rec["status"],
                        "rec": [rec["flops"]] + [rec[k] for k in keys],
                        "real": [fc.get_total_flops()] + [real[k] for k in keys],
                        "collectives": rec["collectives"]}
dist.destroy_process_group()
json.dump(out, open(sys.argv[1], "w"), default=str)
"""


def _start(args, d, name, env):
    log = open(d / f"{name}.log", "w+")
    return name, subprocess.Popen(args, env=env, stdout=log,
                                  stderr=subprocess.STDOUT, cwd=ROOT), log


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    ref_env = dict(env, XLA_FLAGS=env.get("XLA_FLAGS", "")
                   + " --xla_force_host_platform_device_count=512")
    procs = [
        _start([sys.executable, "-c", textwrap.dedent(REFERENCE),
                str(d / "ref.json")], d, "reference", ref_env),
        _start([sys.executable, "-c", textwrap.dedent(PORT),
                str(d / "port.json")], d, "port", env),
        _start([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                "olmo-1b", "--shape", "train_4k", "--device", "cpu", "--out",
                str(d / "cli")], d, "cli", env)]
    try:
        for _, p, _ in procs:
            p.wait(timeout=TIMEOUT)
    finally:
        for _, p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = {}
    for name, p, log in procs:
        log.seek(0)
        logs[name] = log.read()
        log.close()
        assert p.returncode == 0, f"{name} failed:\n{logs[name][-4000:]}"
    with open(d / "ref.json") as f:
        ref = json.load(f)
    with open(d / "port.json") as f:
        port = json.load(f)
    with open(d / "cli" / "olmo_1b_train_4k_single.json") as f:
        cli = json.load(f)
    return ref, port, cli, logs["cli"]


def _dtype(t):
    return str(t.dtype).removeprefix("torch.")


def _flat(tree, axes, path=()):
    """{path: (leaf, axes)} of a port tree: dicts (a dotted key split into
    parts), lists and tuples; the axes tree alongside (or None)."""
    if isinstance(tree, torch.Tensor):
        return {path: (tree, axes)}
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, None if axes is None else axes[k],
                             path + tuple(str(k).split("."))))
    else:
        for i, v in enumerate(tree):
            out.update(_flat(v, None if axes is None else axes[i],
                             path + (str(i),)))
    return out


def _stacked(flat) -> dict:
    """Per-instance leaves stacked back on the "layers" axis: {reference
    path: [shape, dtype, axes]}; the instances of a leaf must agree."""
    groups = {}
    for parts, (t, axes) in flat.items():
        path, index = ref_key(parts)
        desc = (tuple(t.shape), _dtype(t),
                None if axes is None else tuple(axes))
        groups.setdefault(path, []).append((index, desc))
    out = {}
    for path, items in groups.items():
        descs = {desc for _, desc in items}
        assert len(descs) == 1, (path, descs)
        shape, dtype, axes = descs.pop()
        if items[0][0]:
            assert sorted(i for i, _ in items) == [(n,) for n in range(
                len(items))], path
            shape = (len(items),) + shape
            axes = None if axes is None else ("layers",) + axes
        out[path] = [list(shape), dtype, None if axes is None else list(axes)]
    return out


def _ref(desc):
    return {k: [v[0], v[1], v[2]] for k, v in desc.items()}


@pytest.fixture(scope="module")
def abstract():
    """{arch: (api, params on meta, logical axes, per-leaf axes)}."""
    out = {}
    for arch in list_archs():
        api = ModelAPI(get_config(arch))
        params, logical = api.abstract_params()
        out[arch] = (api, params, logical, leaf_axes(params, logical))
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_abstract_params_match_reference(runs, abstract, arch):
    """Shapes, dtypes and logical axes of every parameter, nothing
    allocated (meta tensors)."""
    ref = runs[0]["archs"][arch]
    _, params, _, axes = abstract[arch]
    named = named_leaves(params)
    assert all(t.device.type == "meta" for t in named.values())
    flat = {tuple(k.split(".")): (t, axes[k]) for k, t in named.items()}
    assert _stacked(flat) == _ref(ref["params"])


@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_reference(runs, abstract, arch):
    """Every leaf's spec from shape_aware_spec_tree on both production
    meshes: the stacked leaves' specs equal the reference's, and each
    per-instance leaf's is its stacked leaf's without the layers axis."""
    ref = runs[0]["archs"][arch]["specs"]
    _, params, _, axes = abstract[arch]
    named = named_leaves(params)
    stacked = _stacked({tuple(k.split(".")): (t, axes[k])
                        for k, t in named.items()})
    meta = {p: torch.empty(s, device="meta") for p, (s, _, _) in
            stacked.items()}
    logical = {p: tuple(a) for p, (_, _, a) in stacked.items()}
    for name, mesh in MESHES.items():
        got = shape_aware_spec_tree(meta, logical, mesh=mesh)
        want = {p: tuple(tuple(e) if isinstance(e, list) else e for e in s)
                for p, s in ref[name].items()}
        assert got == want, name
        per_leaf = shape_aware_spec_tree(named, axes, mesh=mesh)
        for k, spec in per_leaf.items():
            path, index = ref_key(k.split("."))
            assert spec == got[path][len(index):], (name, k)


@pytest.mark.parametrize("arch", list_archs())
def test_batch_and_state_specs_match_reference(runs, abstract, arch):
    ref = runs[0]["archs"][arch]
    api = abstract[arch][0]
    for sname, shape in SHAPES.items():
        for key, fn in (("batch", api.batch_specs),
                        ("state", api.serve_state_specs)):
            tree, axes = fn(shape)
            got = {"/".join(p): [list(t.shape), _dtype(t), list(a)]
                   for p, (t, a) in _flat(tree, axes).items()}
            assert all(t.device.type == "meta"
                       for t, _ in _flat(tree, axes).values())
            assert got == _ref(ref[key][sname]), (key, sname)


@pytest.mark.parametrize("arch", list_archs())
def test_opt_state_specs_match_reference(runs, abstract, arch):
    """AdamW, Adafactor and SGD: the state's shapes and dtypes
    (init_opt_state on the meta params) and its logical axes
    (opt_state_specs), congruent leaf for leaf, as the reference's."""
    ref = runs[0]["archs"][arch]["opt"]
    _, params, _, axes = abstract[arch]
    named = named_leaves(params)
    for name in ("adamw", "adafactor", "sgd"):
        spec = opt.OptimizerSpec(name=name)
        state = opt.init_opt_state(spec, params)
        specs = opt.opt_state_specs(spec, named, axes)
        assert _stacked(_flat(state, specs)) == _ref(ref[name]), name


@pytest.mark.parametrize("arch", list_archs())
def test_skip_counts_and_model_flops_match_reference(runs, arch):
    cfg = get_config(arch)
    for sname, shape in SHAPES.items():
        want = runs[0]["cells"][f"{arch}/{sname}"]
        assert dryrun.skip_reason(cfg, shape) == want["skip"]
        if want["skip"]:
            rec = dryrun.run_cell(arch, sname, verbose=False)
            assert rec["status"] == want["status"] == "skipped"
            continue
        assert cfg.param_count() == want["param_count"]
        assert cfg.active_param_count() == want["active_param_count"]
        assert dryrun.model_flops(cfg, shape) == want["model_flops"]


def test_train_4k_argument_bytes(runs):
    """Per-chip argument bytes of olmo-1b x train_4k on (16, 16): state
    (params, AdamW moments, counts) and tokens, placed by the rules, equal
    the reference's NamedSharding shard shapes' bytes."""
    ref, port, _, _ = runs
    assert port["train_4k_arg_bytes"] == ref["train_4k_arg_bytes"]
    assert port["placements"] == {
        "wq": ["S(0)", "S(1)"],  # embed over data, heads over model
        "m_wq": ["S(0)", "S(1)"],
        "tokens": ["S(0)", "R"]}


def test_reduced_cell_on_a_fake_2x2_mesh(runs):
    ref, port, _, _ = runs
    rec = port["reduced22"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["argument_size_in_bytes"] == \
        ref["reduced22"]["argument_size_in_bytes"]
    assert rec["mesh"] == "2x2" and rec["n_chips"] == 4
    assert rec["flops"] > 0 and rec["temp_size_in_bytes"] > 0
    assert rec["collectives"]["total_wire_bytes"] > 0


def test_reduced_mamba2_cell_on_a_fake_2x2_mesh(runs):
    """The SSM path under a mesh: the reduced mamba2-370m x train_4k, its
    tied table's 511 rows not divided by the model axis (as 50280 over
    16), traces its loss, backward and update on a fake (2, 2) mesh; its
    argument bytes equal the reference's compiled cell's."""
    ref, port, _, _ = runs
    rec = port["mamba22"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == "2x2" and rec["n_chips"] == 4
    assert rec["flops"] > 0 and rec["collectives"]["total_wire_bytes"] > 0
    assert ref["mamba22"]["status"] == "ok"
    assert rec["argument_size_in_bytes"] == \
        ref["mamba22"]["argument_size_in_bytes"]


def test_mamba2_cell_asks_no_shard_to_partial_of_torch_2_11(runs):
    """No add or sub of the reduced mamba2 cell's step, planned by torch
    2.11's rule (``AdditivePlans``), redistributes a Shard to a Partial.
    The tied table's two gradients meet in one add: the head's, partial
    over data and split over model, and the lookup's, placed as the table
    (split over data, whole over model).  Followed as 2.11 follows it,
    that add asks the lookup's Shard(1) for Partial(sum), which 2.11's
    DTensor cannot make (mamba2-370m x train_4k on the card);
    ``layers.lm_head`` places the head's gradient as the table is."""
    plans = runs[1]["mamba22_plans"]
    assert plans["seen"] > 0
    assert plans["asked"] == []


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_record_on_a_mesh_of_one_equals_the_real_step(runs, mode):
    """On a (1, 1) mesh (a world of one) the reduced olmo-1b's record has
    the real step's FLOPs (FlopCounterMode's count), argument bytes and
    peak temporaries (a CostTrace of the plain step), and no collective:
    chip_smoke 14b's gates, here on the CPU."""
    one = runs[1]["one"][mode]
    assert one["status"] == "ok"
    assert one["rec"] == one["real"] and one["rec"][0] > 0
    assert one["collectives"] == {"total_wire_bytes": 0}


def test_shard_redistributes_under_a_mesh(runs):
    port = runs[1]
    assert port["shard"] == ["S(0)", "R", [16, 1024]]
    assert port["same"] is True


def test_cli_record(runs):
    """python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
    --device cpu: status ok on the (16, 16) mesh, with the reference's
    keys and H100 roofline terms."""
    ref, port, cli, log = runs
    assert cli["status"] == "ok", cli.get("traceback")
    assert cli["mesh"] == "16x16" and cli["n_chips"] == 256
    assert set(ref["ok_keys"]) <= set(cli)
    assert cli["argument_size_in_bytes"] == ref["train_4k_arg_bytes"]
    r = cli["roofline"]
    assert r["compute_s"] == cli["flops"] / dryrun.HW["peak_flops_bf16"]
    assert r["memory_s"] == cli["bytes_accessed"] / dryrun.HW["hbm_bw"]
    assert r["collective_s"] == cli["collectives"]["total_wire_bytes"] / \
        dryrun.HW["net_bw_per_gpu"]
    assert r["dominant"] == max(("compute_s", "memory_s", "collective_s"),
                                key=r.get)
    assert cli["model_flops"] == runs[0]["cells"][
        "olmo_1b/train_4k"]["model_flops"]
    assert "1 ok, 0 skipped, 0 errors of 1 cells" in log


def test_cuda_device_needs_a_card(tmp_path, monkeypatch):
    """The CLI's default device is cuda, which raises without a card (and
    starts no world)."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "olmo-1b", "--shape", "decode_32k", "--out",
                     str(tmp_path)])
    assert not dist.is_initialized()
