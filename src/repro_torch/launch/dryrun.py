"""Multi-pod dry run: trace every (arch x shape x mesh) cell, allocating
nothing (port of ``repro/launch/dryrun.py``).

For each cell the arguments are fake DTensors (``FakeTensorMode``: shapes,
dtypes and placements, no memory) placed by the logical-axis rules on the
production mesh (``launch.mesh.make_production_mesh`` over ``fake_world``'s
256 or 512 fake ranks), and the step runs eagerly at full depth under
``analysis.hlo_stats.CostTrace``, which records:
  * one rank's argument, output and peak temporary bytes (proves the cell
    fits the card's HBM),
  * FLOPs and bytes accessed per partition (the roofline),
  * DTensor's collectives, in the reference's format.
Train cells trace the loss, its backward and the optimizer update
(``train.trainer.make_train_step``); prefill and decode cells
``ModelAPI``'s steps on the plain routes (the reference's steps take no
kernel).  Plain tensors the models make inside (positions, masks) combine
with DTensors as replicated (``implicit_replication``): every rank makes
the same ones, so no model code needs a mesh to make them.

An eager trace sees every layer instance, so the reference's depth probe
(unrolled compiles at one and two instances, extrapolated, because XLA
counts a while body once) has no counterpart; the record keeps the
reference's keys (``probe_instances`` names the pattern instances traced,
all of them) so that either package's ``roofline.py`` reads either
package's records.  The fake world cannot live beside a real process
group, so the CLI runs the dry run in a process of its own, as the
reference's does (which sets XLA_FLAGS at import).

Usage:
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k \\
      --device cpu
  python -m repro_torch.launch.dryrun --all [--multi-pod] \\
      [--out experiments/dryrun]
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import time
import traceback

import torch

from repro_torch.analysis.hlo_stats import (CostTrace, collective_stats,
                                            cost_summary)
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models.api import ModelAPI
from repro_torch.parallel import axis_rules
from repro_torch.parallel.compile_mode import compile_options
from repro_torch.parallel.sharding import (DEFAULT_RULES, PRESETS, _map,
                                           mesh_sizes,
                                           shape_aware_spec_tree,
                                           to_placements)
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.trainer import TrainState, make_train_step
from repro_torch.train.tree import leaf_axes, map_state, named_leaves

# One NVIDIA H100 SXM5 80GB (NVIDIA's H100 data sheet; dense rates at the
# 700 W limit).
HW = {
    "peak_flops_bf16": 989e12,
    "peak_flops_f32": 67e12,  # outside the tensor cores
    "hbm_bw": 3.35e12,
    # The collective term's one rate.  A 256-GPU mesh spans 32 eight-GPU
    # nodes, so a ring along either mesh axis leaves the node's NVLink and
    # is bound by the node-to-node link: one 400 Gb/s NDR InfiniBand port
    # (ConnectX-7) per GPU (NVIDIA DGX H100 data sheet), 50e9 B/s each way.
    "net_bw_per_gpu": 50e9,
    "hbm_bytes": 80e9,  # "80GB"; the card reports 85.0e9 bytes in all
}


def input_specs(arch: str, shape_name: str):
    """Public helper: abstract model inputs for a cell (no allocation)."""
    cfg = get_config(arch)
    api = ModelAPI(cfg)
    return api.batch_specs(SHAPES[shape_name])


def skip_reason(cfg, shape) -> str | None:
    if shape.sub_quadratic_only and cfg.family not in ("ssm", "hybrid"):
        return ("skipped: long_500k requires sub-quadratic attention; "
                f"{cfg.name} is full-attention (see DESIGN.md)")
    return None


def _placed(meta, spec, mesh):
    """A fake DTensor of ``meta``'s global shape and dtype, placed by
    ``spec`` on ``mesh`` (run under the trace's FakeTensorMode)."""
    from torch.distributed.tensor import DTensor

    sizes = mesh_sizes(mesh)
    local = [dim // math.prod(sizes[a] for a in (
        (entry,) if isinstance(entry, str) else entry or ()))
        for dim, entry in zip(meta.shape, spec)]
    t = torch.empty(local, dtype=meta.dtype, device=mesh.device_type)
    return DTensor.from_local(t, mesh, to_placements(spec, mesh),
                              run_check=False, shape=meta.shape,
                              stride=meta.stride())


def _place_tree(meta_tree, logical_tree, mesh, rules):
    specs = shape_aware_spec_tree(meta_tree, logical_tree, rules, mesh)
    return _map(lambda t, s: _placed(t, s, mesh), meta_tree, specs,
                leaf=lambda t: isinstance(t, torch.Tensor))


def build_cell(cfg, shape, mesh, rules=None):
    """Returns (fn, args): the cell's step and its arguments, fake
    DTensors placed on ``mesh`` by ``rules`` (call it under a
    FakeTensorMode).  DTensor plans each op's collectives from its
    operands' placements, as GSPMD does for the reference."""
    api = ModelAPI(cfg)
    params_meta, params_logical = api.abstract_params()
    batch_meta, batch_logical = api.batch_specs(shape)
    # rules passed here are OVERRIDES; merge with defaults before resolving
    # argument placements (axis_rules does the same merge for activations).
    rules = {**DEFAULT_RULES, **(rules or {})}

    named = named_leaves(params_meta)
    axes = leaf_axes(params_meta, params_logical)
    pspecs = shape_aware_spec_tree(named, axes, rules, mesh)
    params = map_state(params_meta, lambda parts, p: _placed(
        p, pspecs[".".join(parts)], mesh))
    batch = _place_tree(batch_meta, batch_logical, mesh, rules)

    if shape.mode == "train":
        opt_spec = opt_lib.OptimizerSpec(name=cfg.optimizer)
        opt_meta = opt_lib.init_opt_state(opt_spec, params_meta)
        opt_axes = opt_lib.opt_state_specs(opt_spec, named, axes)
        step = torch.empty((), dtype=torch.int32, device="meta")
        state = TrainState(
            params=params,
            opt_state=_place_tree(opt_meta, opt_axes, mesh, rules),
            step=_placed(step, (), mesh))
        for p in params.parameters():
            p.requires_grad_(True)
        lr_fn = opt_lib.cosine_schedule(3e-4, 100, 10000)
        return make_train_step(api.loss, opt_spec, lr_fn), (state, batch)

    if shape.mode == "prefill":
        def prefill(p, b):
            return api.prefill_step(p, b, max_len=shape.seq_len)
        return prefill, (params, batch)

    # decode: one token against a cache holding seq_len - 1 rows (the
    # state's length is a host int in the port)
    state = {**batch["state"], "length": shape.seq_len - 1}
    return api.decode_step, (params, batch["token"], state)


def trace_cell(cfg, shape, mesh, rules=None, flash_block=2048):
    """Trace one cell: (CostTrace, args, outputs), the tensors fake."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    with FakeTensorMode():
        fn, args = build_cell(cfg, shape, mesh, rules)
        trace = CostTrace()
        with compile_options(flash_block=flash_block), \
                axis_rules(rules, mesh=mesh), implicit_replication(), trace:
            out = fn(*args)
    return trace, args, out


def model_flops(cfg, shape) -> float:
    """The step's useful FLOPs: 6 (train) or 2 (prefill, decode) per
    active parameter per token."""
    n_active = cfg.active_param_count()
    if shape.mode == "decode":
        return 2.0 * n_active * shape.global_batch
    per_token = 6.0 if shape.mode == "train" else 2.0
    return per_token * n_active * shape.global_batch * shape.seq_len


def run_cell(arch: str, shape_name, multi_pod: bool = False, rules=None,
             mesh=None, verbose: bool = True, cfg_fn=None,
             flash_block=2048, device=None) -> dict:
    """One cell's record.  ``shape_name`` names a ``SHAPES`` entry or is a
    ``ShapeConfig``; ``mesh`` defaults to the production mesh over the
    current (fake) world, on ``device``'s type."""
    cfg = get_config(arch)
    if cfg_fn is not None:
        cfg = cfg_fn(cfg)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    rec = {"arch": arch, "shape": shape.name,
           "mesh": ("x".join(map(str, mesh.shape)) if mesh is not None
                    else "2x16x16" if multi_pod else "16x16"),
           "mode": shape.mode}
    reason = skip_reason(cfg, shape)
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec

    t0 = time.time()
    try:
        mesh = mesh or make_production_mesh(multi_pod=multi_pod,
                                            device=device)
        n_chips = mesh.size()
        trace, args, out = trace_cell(cfg, shape, mesh, rules, flash_block)
        rec.update(cost_summary(trace, args, out))
        rec["collectives"] = collective_stats(trace.collectives)
        rec["probe_instances"] = [cfg.num_layers // cfg.pattern_period]
        rec["status"] = "ok"
        rec["compile_s"] = round(time.time() - t0, 1)  # the trace's seconds
        rec["probe_s"] = 0.0
        rec["n_chips"] = n_chips

        # roofline terms (per step, seconds), per partition: each term
        # divides one rank's count by one card's peak.
        rec["param_count"] = cfg.param_count()
        rec["active_param_count"] = cfg.active_param_count()
        rec["model_flops"] = model_flops(cfg, shape)

        flops = rec["flops"]
        bytes_acc = rec["bytes_accessed"]
        wire = rec["collectives"]["total_wire_bytes"]
        rec["flops_total"] = flops * n_chips
        rec["bytes_total"] = bytes_acc * n_chips
        rec["roofline"] = {
            "compute_s": flops / HW["peak_flops_bf16"],
            "memory_s": bytes_acc / HW["hbm_bw"],
            "collective_s": wire / HW["net_bw_per_gpu"],
        }
        dom = max(rec["roofline"], key=rec["roofline"].get)
        rec["roofline"]["dominant"] = dom
        if flops:
            rec["mf_ratio"] = rec["model_flops"] / rec["flops_total"]
        if verbose:
            r = rec["roofline"]
            print(f"[dryrun] {arch}/{shape.name}/{rec['mesh']}: ok "
                  f"trace {rec['compile_s']}s flops {flops:.3e} "
                  f"compute {r['compute_s']*1e3:.2f}ms "
                  f"mem {r['memory_s']*1e3:.2f}ms "
                  f"coll {r['collective_s']*1e3:.2f}ms -> {dom}",
                  flush=True)
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[dryrun] {arch}/{shape.name}/{rec['mesh']}: "
                  f"ERROR {rec['error'][:200]}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--rules", default="default",
                    choices=["default", "sp", "decode"],
                    help="sharding preset (see parallel.sharding.PRESETS)")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--device", default="cuda",
                    help="the fake mesh's device type (cuda needs a card)")
    args = ap.parse_args(argv)
    import torch.distributed as dist

    # DTensor warns of each multi-step redistribution it plans
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    preset = PRESETS[args.rules]

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    results = []
    for multi_pod in meshes:
        if dist.is_initialized():
            dist.destroy_process_group()
        fake_world(512 if multi_pod else 256, args.device)
        mesh = make_production_mesh(multi_pod=multi_pod, device=args.device)
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, multi_pod, mesh=mesh,
                               rules=preset or None)
                results.append(rec)
                tag = "multi" if multi_pod else "single"
                path = os.path.join(
                    args.out, f"{arch}_{shape}_{tag}.json".replace("-", "_"))
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1, default=str)
    dist.destroy_process_group()
    ok = sum(r["status"] == "ok" for r in results)
    skipped = sum(r["status"] == "skipped" for r in results)
    err = sum(r["status"] == "error" for r in results)
    print(f"[dryrun] done: {ok} ok, {skipped} skipped, {err} errors "
          f"of {len(results)} cells")
    if err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
