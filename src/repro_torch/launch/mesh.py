"""Device meshes on torch.distributed (port of ``repro/launch/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the current process group, one process per shard.  The port's sharded
engines take one (``fleet.simulate_sharded(mesh=...)``,
``GatewayCore(mesh=...)``) and read a named axis of it through
``core.collectives.shards_of``.

Single pod: (data=16, model=16) = 256 ranks.  Multi-pod: (pod=2, data=16,
model=16) = 512 ranks; the 'pod' axis carries data parallelism across
pods.

The backend follows the run's device, never what the machine has: NCCL
for ``cuda`` (raising when this torch lacks it), gloo for ``cpu``.  The
caller starts the process group (``torch.distributed.init_process_group``
with its own store, address, rank and world size), or asks for
``world_of_one``, or, for the dry run, ``fake_world``: one process that
stands for every rank of a 256- or 512-rank world.  Importing this module
touches no process group.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


def backend_for(device=None) -> str:
    """The process-group backend of a run on ``device`` (None -> cuda):
    ``"nccl"`` for CUDA (raises when this torch has no NCCL), ``"gloo"``
    for the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a cuda run's collectives need NCCL, which "
                               "this torch build lacks")
        return "nccl"
    if dev.type == "cpu":
        return "gloo"
    raise ValueError(f"no collective backend for device {dev}")


def world_of_one(device=None) -> bool:
    """Start a process group of one rank for a run on ``device`` when none
    exists (an in-process ``HashStore``, no rendezvous); returns whether
    it started one.  Its collectives are still issued (NCCL on ``cuda``,
    eagerly initialized on the current card)."""
    if dist.is_initialized():
        return False
    dev = resolve_device(device)
    kw = {}
    if dev.type == "cuda":
        index = torch.cuda.current_device() if dev.index is None else dev.index
        kw["device_id"] = torch.device("cuda", index)
    dist.init_process_group(backend_for(dev), store=dist.HashStore(),
                            rank=0, world_size=1, **kw)
    return True


def fake_world(world_size: int, device=None):
    """Start a process group of ``world_size`` fake ranks in this one
    process, as its rank 0 (``torch.testing``'s fake backend: collectives
    issue nothing and return at once), for the dry run's traces on a
    production mesh of ``device``'s type (None -> cuda, which must
    exist).  A real process group cannot live beside it: the dry run
    runs in a process of its own."""
    resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("a process group already exists; the fake world "
                           "needs a process of its own")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _make_mesh(shape, axes, device):
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if not dist.is_initialized():
        raise RuntimeError("no process group: start one (torch.distributed."
                           "init_process_group, or world_of_one) first")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; "
                         f"the process group has {world}")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The (data=16, model=16) pod mesh, or (pod=2, data=16, model=16)
    with ``multi_pod``, over a process group of 256 / 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), *, device=None):
    """A small mesh over the current process group (whose world size must
    be the product of ``shape``), for tests and CPU worlds."""
    return _make_mesh(shape, axes, device)


def default_mesh(device_axis: str = "data", device=None):
    """The current world's 1-D mesh over ``device_axis`` (a world of one
    started when no process group exists): the reference's "all local
    devices"."""
    world_of_one(device)
    return _make_mesh((dist.get_world_size(),), (device_axis,), device)
