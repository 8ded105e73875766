"""Collective ops, FLOPs, bytes and peak memory of a traced step (port of
``repro/analysis/hlo_stats.py``; the file name is kept so that a reader
finds the counterpart).

The reference compiles each cell and reads XLA's output: collectives from
the optimized post-SPMD HLO text, FLOPs and bytes from
``cost_analysis()``, sizes from ``memory_analysis()``.  The port runs no
compiler between the program and the card, and there is no HLO: the dry
run traces the step eagerly (``FakeTensorMode`` over DTensor on a fake
mesh) under ``CostTrace``, which reads DTensor's collectives (the
``_c10d_functional`` / ``_dtensor`` ops it issues) and every op the step
runs on the local (one rank's) tensors:

  flops            per partition: the ops' FLOPs on the local tensors
                   (``torch.utils.flop_counter``'s formulas), replicated
                   work included, as ``cost_analysis()``'s;
  bytes_accessed   each op's local operand and result bytes (views
                   excluded): what an eager program moves without fusion;
  temp             the peak of live local bytes the step allocates (the
                   arguments, allocated before, not counted).

Per-chip wire-byte multipliers follow the standard ring model:

  all-reduce       2x payload   (reduce-scatter + all-gather phases)
  all-gather       1x result    (each chip receives the full result)
  reduce-scatter   1x result
  all-to-all       1x payload
  collective-permute 1x payload
"""

from __future__ import annotations

import sys
import weakref
from collections import defaultdict

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

_WIRE_MULT = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# a traced collective op's name -> the reference's (HLO) op name
COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}


def _op_name(op) -> str:
    """"all_gather_into_tensor" of the op (or of its printed name,
    "_c10d_functional.all_gather_into_tensor.default")."""
    parts = str(op).split(".")
    return parts[1] if len(parts) > 1 else parts[0]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def collective_stats(calls) -> dict:
    """Returns {op_type: {"count": int, "bytes": int}, "total_wire_bytes"}.

    calls: (op, result) pairs of a trace, ``op`` a collective op (or its
    name, or the reference's name of its kind), ``result`` its local
    result tensor(s) or their bytes.  Ops that are no collective
    (``wait_tensor``, the twin that completes an async collective, or any
    other) are skipped, so nothing is counted twice."""
    stats = defaultdict(lambda: {"count": 0, "bytes": 0})
    for op, result in calls:
        name = _op_name(op)
        kind = COLLECTIVE_OPS.get(name, name if name in _WIRE_MULT else None)
        if kind is None:
            continue
        stats[kind]["count"] += 1
        stats[kind]["bytes"] += result if isinstance(result, int) else sum(
            _nbytes(t) for t in pytree.tree_leaves(result)
            if isinstance(t, torch.Tensor))
    total = sum(_WIRE_MULT[op] * s["bytes"] for op, s in stats.items())
    out = {op: dict(s) for op, s in stats.items()}
    out["total_wire_bytes"] = int(total)
    return out


# the ops FlopCounterMode leaves to the tensors (metadata queries)
_METADATA = {
    torch.ops.aten.sym_is_contiguous.default,
    torch.ops.aten.is_contiguous.default,
    torch.ops.aten.is_contiguous.memory_format,
    torch.ops.aten.is_strides_like_format.default,
    torch.ops.aten.is_non_overlapping_and_dense.default,
    torch.ops.aten.size.default,
    torch.ops.aten.sym_size.default,
    torch.ops.aten.stride.default,
    torch.ops.aten.sym_stride.default,
    torch.ops.aten.storage_offset.default,
    torch.ops.aten.sym_storage_offset.default,
    torch.ops.aten.numel.default,
    torch.ops.aten.sym_numel.default,
    torch.ops.aten.dim.default,
    torch.ops.prim.layout.default,
}
# allocations that write nothing
_ALLOC_ONLY = {torch.ops.aten.empty, torch.ops.aten.empty_strided,
               torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided}


def _in_shape_propagation() -> bool:
    """Whether the op runs inside DTensor's output-shape propagation (it
    runs the op once on fake tensors of the GLOBAL shape): no rank's work."""
    f = sys._getframe(2)
    for _ in range(16):
        if f is None:
            return False
        if f.f_code.co_name == "_propagate_tensor_meta_non_cached":
            return True
        f = f.f_back
    return False


class CostTrace(TorchDispatchMode):
    """The per-rank costs of the ops run under it.

    An op with a DTensor argument is left to DTensor (NotImplemented),
    which runs it as ops on the local tensors (and its redistributions as
    collectives on them); those come back here and are counted.  FLOPs
    are counted as ``FlopCounterMode`` counts them (the same formulas and
    decompositions), so on a mesh of one the count equals
    ``FlopCounterMode``'s of the same step on plain tensors.

    Attributes: ``flops``, ``bytes_accessed`` (``bytes_written`` of it
    by results), ``collectives`` ((op, result bytes) pairs for
    ``collective_stats``: no tensor is held, so none outlives its use),
    ``live`` and ``peak`` (bytes of the storages the traced ops
    allocated, alive now and at most)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = self.bytes_written = 0
        self.collectives = []
        self.live = self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return NotImplemented
        from torch.distributed.tensor import DTensor

        ins = [a for a in pytree.arg_tree_leaves(*args, **kwargs)
               if isinstance(a, torch.Tensor)]
        if any(isinstance(a, DTensor) for a in ins):
            return NotImplemented
        if func not in flop_registry and \
                func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        if not _in_shape_propagation():
            self._count(func, args, kwargs, ins, out)
        return out

    def _count(self, func, args, kwargs, ins, out):
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        if not outs:
            return
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if _op_name(func) in COLLECTIVE_OPS:
            self.collectives.append((func, sum(map(_nbytes, outs))))
        if func.is_view or packet is torch.ops._c10d_functional.wait_tensor:
            return  # returns (a view of) its input
        if packet not in _ALLOC_ONLY:
            written = sum(map(_nbytes, outs))
            self.bytes_written += written
            self.bytes_accessed += sum(map(_nbytes, ins)) + written
        held = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            if st._cdata in held:
                continue  # in place, or an alias of an input
            held.add(st._cdata)
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)

    def _free(self, n):
        self.live -= n


def _local_leaves(tree) -> list:
    """The local tensors (a DTensor's shard) of a state tree's leaves,
    one per storage."""
    from torch.distributed.tensor import DTensor

    from repro_torch.train.tree import flat_state

    out, seen = [], set()
    for _, leaf in flat_state(tree):
        if not isinstance(leaf, torch.Tensor):
            continue
        t = leaf._local_tensor if isinstance(leaf, DTensor) else leaf
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            out.append(t)
    return out


def cost_summary(trace: CostTrace, args, outputs) -> dict:
    """The reference's cost / memory keys of a traced step: ``trace`` the
    step's CostTrace, ``args`` its arguments, ``outputs`` what it returned
    (trees of tensors or DTensors; one rank's shards counted)."""
    arg = _local_leaves(args)
    arg_keys = {t.untyped_storage()._cdata for t in arg}
    out = _local_leaves(outputs)
    return {
        "flops": float(trace.flops),
        "bytes_accessed": float(trace.bytes_accessed),
        "bytes_detail": {"bytes accessed": float(trace.bytes_accessed),
                         "bytes accessedout{}": float(trace.bytes_written)},
        "generated_code_size_in_bytes": 0,  # eager: no program is generated
        "argument_size_in_bytes": sum(map(_nbytes, arg)),
        "output_size_in_bytes": sum(map(_nbytes, out)),
        "temp_size_in_bytes": trace.peak,
        "alias_size_in_bytes": sum(_nbytes(t) for t in out
                                   if t.untyped_storage()._cdata in arg_keys),
    }
