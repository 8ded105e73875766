"""Logical-axis sharding rules (MaxText-style) for DP/FSDP/TP/SP/EP.

Port of ``repro/parallel/sharding.py`` onto DTensor.  Model code
annotates tensors with *logical* axis names ("batch", "embed", "heads",
"mlp", "experts", "kv_seq", ...).  A rules table maps logical axes to
mesh axes; ``shard(x, ...names)`` redistributes a DTensor to those
placements when a mesh is active (the reference's
``with_sharding_constraint``) and is the identity otherwise, so the same
model code runs in unit tests, on one card and in the dry run's fake
256- or 512-rank mesh.

A spec is a tuple with one entry a tensor dimension: ``None``, a mesh
axis name, or a tuple of them (the reference's ``PartitionSpec``).  A
mesh is a ``torch.distributed`` ``DeviceMesh`` (``mesh_dim_names``,
``shape``) or any object with ``axis_names`` and ``devices.shape`` (the
reference's duck-typed test mesh); ``to_placements`` needs the former.

Parallelism dimensions expressed through the default rules:
  DP    batch           -> ('pod', 'data')
  FSDP  embed (d_model) -> 'data'     (weights + optimizer state sharded)
  TP    heads/mlp/vocab -> 'model'
  SP    kv_seq          -> 'model'    (decode-time KV cache / long context)
  EP    experts         -> 'model'
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

AxisRules = dict  # logical axis name -> mesh axis | tuple | None

# Default production rules (single- and multi-pod meshes share these; the
# 'pod' axis only exists in the multi-pod mesh and is dropped otherwise).
DEFAULT_RULES: AxisRules = {
    "batch": ("pod", "data"),
    "seq": None,
    "mlp_seq": None,
    "act_embed": None,
    "embed": "data",        # FSDP: weight d_model dim sharded over data
    "heads": "model",       # TP
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",         # TP: d_ff
    "vocab": "model",       # TP: embedding/logits vocab dim
    "experts": "model",     # EP
    "expert_mlp": None,
    "kv_seq": "model",      # SP for decode KV caches
    "ssm_heads": "model",   # TP for Mamba/SSD head dim
    "seq_chunks": None,     # SSD chunk index (maps to 'model' under SP)
    "layers": None,
    "conv": None,
    "state": None,
    "stage": "pod",         # pipeline stage (when PP enabled)
}

# Sequence-parallel attention / SSM (the reference's hillclimbed preset).
SP_RULES: AxisRules = {
    "seq": "model", "seq_chunks": "model",
    "heads": None, "kv_heads": None, "ssm_heads": None,
}

# Serving-time rules: weights TP-resident + DP-replicated (no FSDP weight
# all-gather per decode step).
DECODE_RULES: AxisRules = {"embed": None}

PRESETS = {"default": {}, "sp": SP_RULES, "decode": DECODE_RULES}


class _Ctx:
    """The active rules and mesh.  Process-wide, where the reference's are
    thread-local: on the card the autograd engine recomputes a
    checkpointed forward (``models.blocks.remat_wrap``) on its own device
    thread, which must see the forward's mesh."""

    def __init__(self):
        self.mesh = None
        self.rules: AxisRules = dict(DEFAULT_RULES)


_CTX = _Ctx()


@contextlib.contextmanager
def axis_rules(rules: Optional[AxisRules] = None, mesh=None):
    """Activate sharding rules (+ optionally a mesh) for model code."""
    old_rules, old_mesh = _CTX.rules, _CTX.mesh
    if rules is not None:
        _CTX.rules = {**DEFAULT_RULES, **rules}
    if mesh is not None:
        _CTX.mesh = mesh
    try:
        yield
    finally:
        _CTX.rules, _CTX.mesh = old_rules, old_mesh


def current_rules() -> AxisRules:
    return _CTX.rules


def current_mesh():
    return _CTX.mesh


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or a duck-typed mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _resolve(logical, rules, mesh_axes):
    """Logical name -> physical mesh axis entry, dropping absent axes."""
    phys = rules.get(logical, None) if logical is not None else None
    if phys is None:
        return None
    if isinstance(phys, (tuple, list)):
        kept = tuple(a for a in phys if a in mesh_axes)
        return kept if kept else None
    return phys if phys in mesh_axes else None


def logical_to_spec(logical_axes, rules: Optional[AxisRules] = None,
                    mesh=None) -> tuple:
    """Tuple of logical axis names (or None) -> spec.

    A mesh axis may appear at most once in a spec; when two logical axes of
    one tensor map to the same mesh axis (e.g. kv_seq and kv_heads both ->
    'model' on a KV cache), the FIRST occurrence wins and later ones are
    replicated."""
    rules = rules or current_rules()
    mesh = mesh or current_mesh()
    mesh_axes = set(mesh_sizes(mesh)) if mesh is not None else set()
    used = set()
    out = []
    for a in logical_axes:
        phys = _resolve(a, rules, mesh_axes)
        if phys is None:
            out.append(None)
            continue
        cand = list(phys) if isinstance(phys, (tuple, list)) else [phys]
        kept = [p for p in cand if p not in used]
        used.update(kept)
        out.append(tuple(kept) if len(kept) > 1 else (kept[0] if kept
                                                      else None))
    return tuple(out)


def to_placements(spec, mesh) -> tuple:
    """A spec as DTensor placements on ``mesh`` (a DeviceMesh): ``Shard(d)``
    on each mesh dimension that shards tensor dimension ``d``,
    ``Replicate()`` on the others and on every axis of size 1 (which
    splits nothing: a mesh of one runs the plain program).  A dimension
    sharded over several mesh axes takes them in the mesh's order (major
    first, as the reference's ``('pod', 'data')``)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} of dimension {d} is not "
                             f"in the mesh's axis order {tuple(names)}")
        for i in idx:
            if mesh.shape[i] > 1:
                out[i] = Shard(d)
    return tuple(out)


def shard(x, *logical_axes):
    """Annotate an activation with logical axes: a DTensor is redistributed
    to the axes' placements under an active mesh; anything else (and
    everything without a mesh) is returned as it is."""
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    placements = _rule_placements(x, logical_axes)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def placed_by_rules(x, *logical_axes) -> bool:
    """Whether ``x`` lies where ``shard(x, *logical_axes)`` would put it
    (True off a mesh, and for anything but a DTensor).  An argument that
    the shape-aware rules placed does not where an axis does not divide
    its dimension (mamba2's 50280-row vocabulary over a 16-way axis)."""
    if current_mesh() is None or getattr(x, "device_mesh", None) is None:
        return True
    return tuple(x.placements) == _rule_placements(x, logical_axes)


def _rule_placements(x, logical_axes) -> tuple:
    return to_placements(logical_to_spec(logical_axes), x.device_mesh)


def split_counts(x) -> dict:
    """{tensor dim: ranks it is split over} of a DTensor ({} otherwise)."""
    counts = {}
    for i, p in enumerate(getattr(x, "placements", ())):
        if p.is_shard():
            counts[p.dim] = counts.get(p.dim, 1) * x.device_mesh.size(i)
    return counts


def reshape_last(x, *sizes):
    """``x.reshape(*x.shape[:-1], *sizes)``.  A DTensor split along its
    last dim over more ranks than ``sizes[0]`` divides is first gathered
    along it: DTensor splits no uneven unflatten (GQA's 8 kv heads over a
    16-way axis)."""
    n = split_counts(x).get(x.dim() - 1, 1)
    if sizes[0] % n:
        from torch.distributed.tensor import Replicate

        x = x.redistribute(x.device_mesh, [
            Replicate() if p.is_shard(x.dim() - 1) else p
            for p in x.placements])
    return x.reshape(*x.shape[:-1], *sizes)


def placed_like(x, ref):
    """``x`` redistributed to ``ref``'s placements where both are DTensors
    placed otherwise (partial sums reduced, splits moved); ``x`` itself
    else."""
    if getattr(x, "device_mesh", None) is None or \
            tuple(x.placements) == tuple(ref.placements):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def grad_placed(x):
    """``x`` itself; on a DTensor that requires a gradient, an identity
    whose gradient arrives placed as ``x`` is (DTensor's planner may split
    it otherwise, e.g. unevenly along a dim a view then unflattens)."""
    if getattr(x, "device_mesh", None) is None or not x.requires_grad:
        return x
    return _GradTo.apply(x, x.placements)


class _GradTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != tuple(ctx.placements):
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def zeros(shape, dtype, device, *logical_axes):
    """``torch.zeros``; under an active mesh a DTensor of zeros placed by
    the axes (each rank allocates its shard only), for buffers a model
    creates whole, such as a decode cache."""
    mesh = current_mesh()
    if mesh is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import zeros as dzeros

    spec = _shape_aware(tuple(shape), logical_axes, current_rules(), mesh)
    return dzeros(*shape, dtype=dtype, device_mesh=mesh,
                  placements=to_placements(spec, mesh))


def _is_axes(x) -> bool:
    return x is None or (isinstance(x, tuple) and all(
        a is None or isinstance(a, str) for a in x))


def _map(fn, tree, *rest, leaf=_is_axes):
    """``fn`` over the leaves of ``tree`` (dicts, lists and tuples of
    leaves), with the matching subtrees of ``rest``."""
    if leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest), leaf=leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(r[i] for r in rest), leaf=leaf)
                          for i, v in enumerate(tree))
    raise TypeError(f"not a spec tree node: {type(tree).__name__}")


def spec_tree(logical_tree, rules: Optional[AxisRules] = None, mesh=None):
    """Map a tree of logical-axes tuples to specs."""
    mesh = mesh or current_mesh()
    return _map(lambda axes: logical_to_spec(axes or (), rules, mesh),
                logical_tree)


def _shape_aware(shp, axes, rules, mesh):
    sizes = mesh_sizes(mesh)
    axes = tuple(axes or ())
    axes = axes + (None,) * (len(shp) - len(axes))
    used: set = set()

    def resolve_dim(dim, logical):
        phys = _resolve(logical, rules, set(sizes))
        if phys is None:
            return None
        cand = list(phys) if isinstance(phys, (tuple, list)) else [phys]
        kept = []
        prod = 1
        for a in cand:
            if a not in used and dim % (prod * sizes[a]) == 0:
                kept.append(a)
                used.add(a)
                prod *= sizes[a]
            else:
                break
        if not kept:
            return None
        return tuple(kept) if len(kept) > 1 else kept[0]

    return tuple(resolve_dim(d, a) for d, a in zip(shp, axes))


def shape_aware_spec_tree(shapes_tree, logical_tree,
                          rules: Optional[AxisRules] = None, mesh=None):
    """Specs for argument placements: like spec_tree, but any mesh axis
    whose size does not divide the corresponding tensor dim is DROPPED
    (replicated) for that tensor, e.g. kv_heads=8 cannot shard over
    model=16 (GQA decode replicates KV heads; the roofline then reflects
    that honestly), and a 50280 vocab does not split 16 ways.

    For tuple mappings (('pod','data') on batch) a divisible prefix is
    kept.  ``shapes_tree``'s leaves are tensors (meta, fake or real); its
    dicts, lists and tuples match ``logical_tree``'s."""
    rules = rules or current_rules()
    mesh = mesh or current_mesh()
    return _map(lambda t, axes: _shape_aware(tuple(t.shape), axes, rules,
                                             mesh),
                shapes_tree, logical_tree,
                leaf=lambda t: hasattr(t, "shape"))
