"""The fleet's collectives over a mesh axis (torch.distributed).

The sharded engines run SPMD, one process per shard: every rank calls the
same entry point with the same global inputs, works on its own device
columns ``[index * N / count, (index + 1) * N / count)``, and the ranks
meet only in the collectives here.  ``all_reduce`` is the reference's
``jax.lax.psum`` (the slot's capacity load: the paper's one collective a
slot) and, with ``op="max"``, its ``jax.lax.pmax`` (the common scale of
``train.compression``'s int8 all-reduce); ``gather_cols`` concatenates the shards' columns, where the
reference's ``shard_map`` assembles its sharded outputs.

Each counts its calls in a plain int attribute (``all_reduce.calls``), as
the kernel wrappers count their launches, so a run can show how many
collectives it issued.  A world of one issues and counts them too.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Shards:
    """This rank's place on a mesh axis: the axis's process group, this
    rank's index along it and the number of shards."""

    group: dist.ProcessGroup
    index: int
    count: int

    def cols(self, n: int) -> slice:
        """This shard's slice of ``n`` device columns (a multiple of
        ``count``, see ``fleet._validate_shards``)."""
        size = n // self.count
        return slice(self.index * size, (self.index + 1) * size)


def shards_of(mesh, device_axis: str, device: torch.device) -> Shards:
    """(group, index, count) of ``mesh``'s axis ``device_axis`` for this
    rank; the mesh must live on the run's device type."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError("mesh must be a torch.distributed DeviceMesh "
                        f"(launch.mesh builds one), got {type(mesh).__name__}")
    if mesh.device_type != device.type:
        raise ValueError(f"the mesh is on {mesh.device_type!r} devices but "
                         f"the run is on {device.type!r}")
    names = mesh.mesh_dim_names or ()
    if device_axis not in names:
        raise ValueError(f"mesh has no axis {device_axis!r} (axes {names})")
    return Shards(group=mesh.get_group(device_axis),
                  index=mesh.get_local_rank(device_axis),
                  count=mesh[device_axis].size())


def _group(axis_name) -> dist.ProcessGroup:
    if not isinstance(axis_name, dist.ProcessGroup):
        raise TypeError("axis_name takes the mesh axis's ProcessGroup "
                        "(mesh.get_group(axis)), got "
                        f"{type(axis_name).__name__}")
    return axis_name


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, axis_name, op: str = "sum") -> torch.Tensor:
    """The sum (``op="max"``: the maximum) of ``x`` over the shards of
    ``axis_name`` (a ProcessGroup); every rank gets the same bits.  It
    reduces in place: into ``x`` itself when ``x`` is contiguous (else
    into a contiguous copy), so pass a tensor whose local value is not
    needed afterwards.  On the card the collective is enqueued on the
    stream and nothing waits."""
    group = _group(axis_name)
    x = x.contiguous()
    dist.all_reduce(x, op=_OPS[op], group=group)
    all_reduce.calls += 1
    return x


all_reduce.calls = 0


def gather_cols(x: torch.Tensor, shards: Shards, dim: int = -1
                ) -> torch.Tensor:
    """The shards' ``x`` concatenated along ``dim`` in shard order (a
    ``(T, N / S)`` block becomes ``(T, N)``).  Bool tensors travel as
    uint8."""
    group = _group(shards.group)
    src = x.to(torch.uint8) if x.dtype == torch.bool else x
    src = src.contiguous()
    parts = [torch.empty_like(src) for _ in range(shards.count)]
    dist.all_gather(parts, src, group=group)
    gather_cols.calls += 1
    out = torch.cat(parts, dim=dim)
    return out.bool() if x.dtype == torch.bool else out


gather_cols.calls = 0

COLLECTIVES = {"all_reduce": all_reduce, "all_gather": gather_cols}


def reset_collective_counts():
    """Set every collective's call count to 0."""
    for fn in COLLECTIVES.values():
        fn.calls = 0


def collective_counts() -> dict:
    """{collective: calls since the last reset}."""
    return {name: fn.calls for name, fn in COLLECTIVES.items()}
