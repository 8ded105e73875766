"""Named leaves of the port's parameter and state trees, and their keys in
the reference's trees.

The port holds a model's parameters as a module (``models.lm.to_module``:
``ModuleDict`` / ``ParameterDict``, with the layer axis an
``nn.ModuleList`` of pattern instances) or as nested dicts of tensors
(the gain heads), and an optimizer's per-parameter state as dicts keyed
by the parameters' dotted names, as ``named_parameters`` gives them.  The
reference stacks a layer stack's leaves on a leading axis and names each
leaf by its tree path ("blocks/sub0/mixer/wq"; a dataclass field as
".params").  ``ref_key`` maps a dotted name onto that path: a numeric
component (a module-list index) is dropped from the path and becomes the
leaf's index along the stacked axis.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


def named_leaves(params) -> dict:
    """{dotted name: tensor} of a module's parameters, or of a nested
    dict / list of tensors ("mamba.w_in"; list items by index)."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    out = {}

    def walk(t, prefix):
        if isinstance(t, torch.Tensor):
            out[prefix] = t
        elif isinstance(t, dict):
            for k in t:
                walk(t[k], f"{prefix}.{k}" if prefix else str(k))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{prefix}.{i}" if prefix else str(i))
        else:
            raise TypeError(f"not a tensor tree leaf: {type(t).__name__}")

    walk(params, "")
    return out


def ref_key(parts) -> tuple:
    """(reference path, stacked index) of a leaf named by path ``parts``:
    numeric parts leave the path and form the index (() when none)."""
    path = [p for p in parts if not p.isdigit()]
    index = tuple(int(p) for p in parts if p.isdigit())
    return "/".join(path), index


def leaf_axes(params, specs) -> dict:
    """{dotted name: logical axes} of ``params``' leaves, read from the
    reference-shaped ``specs`` tree (a model's ``init`` gives both): a
    leaf of a layer list (one pattern instance) takes its stacked leaf's
    axes without the leading "layers" axis."""
    out = {}
    for name in named_leaves(params):
        path, index = ref_key(name.split("."))
        axes = specs
        for part in path.split("/"):
            axes = axes[part]
        out[name] = tuple(axes)[len(index):]
    return out


def flat_state(tree, prefix=()) -> list:
    """[(path parts, leaf)] of a state tree: a dataclass (fields as
    ".name", as jax names a registered dataclass's fields), a parameter
    module, a dict (a dotted key splits into parts), a list, or a leaf.
    Dict keys are visited in sorted order, so the leaves come in the
    reference's flattening order."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = []
        for f in dataclasses.fields(tree):
            out += flat_state(getattr(tree, f.name), prefix + ("." + f.name,))
        return out
    if isinstance(tree, nn.Module):
        return flat_state(_module_tree(tree), prefix)
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flat_state(tree[k], prefix + tuple(str(k).split(".")))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flat_state(v, prefix + (str(i),))
        return out
    return [(prefix, tree)]


def map_state(tree, fn, prefix=()):
    """The state tree with each leaf replaced by ``fn(parts, leaf)``: the
    same dataclasses, dicts and lists; a module is rebuilt by
    ``models.lm.to_module`` with its parameters' ``requires_grad``."""
    from repro_torch.models.lm import to_module

    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_state(getattr(tree, f.name), fn,
                              prefix + ("." + f.name,))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, nn.Module):
        trainable = any(p.requires_grad for p in tree.parameters())
        return to_module(map_state(_module_tree(tree), fn, prefix),
                         trainable)
    if isinstance(tree, dict):
        return {k: map_state(v, fn, prefix + tuple(str(k).split(".")))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_state(v, fn, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _module_tree(mod: nn.Module):
    """A ``to_module`` module as the nested dicts / lists it was built
    from (empty parameter dicts kept: a model indexes them)."""
    if isinstance(mod, nn.ModuleList):
        return [_module_tree(m) for m in mod]
    if isinstance(mod, nn.ParameterDict):
        return dict(mod.items())
    if isinstance(mod, nn.ModuleDict):
        return {k: _module_tree(m) for k, m in mod.items()}
    raise TypeError(f"not a parameter module of to_module: "
                    f"{type(mod).__name__}")
