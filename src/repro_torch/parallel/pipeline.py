"""GPipe-style pipeline parallelism over a mesh axis (designed for 'pod').

Port of ``repro/parallel/pipeline.py`` onto ``torch.distributed``.  When
inter-pod links are much slower than intra-pod ones, pure DP over pods
pays a full gradient all-reduce per step; pipelining the layer stack
across pods sends only activations (one microbatch per tick) over the
slow links.

``pipeline_apply`` runs the canonical GPipe schedule, one process a
stage: stage s (this rank's index along the axis) owns its slice of the
layer stack; each tick, activations hop to the next stage by
point-to-point send / recv (the reference's ``lax.ppermute``) while new
microbatches stream into stage 0.  M microbatches over S stages take
M + S - 1 ticks (bubble fraction (S-1)/(M+S-1)).  The collectives run on
the mesh's process group: NCCL for a ``cuda`` mesh, gloo for a ``cpu``
one (``launch.mesh.backend_for``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch.core.collectives import all_reduce, shards_of


def pipeline_apply(stage_fn, stage_params, microbatches, mesh,
                   axis: str = "pod"):
    """Run microbatches through S pipeline stages.

    stage_fn: (params_slice, h) -> h  (one stage's computation, shape
      preserving)
    stage_params: tensor tree with leading dim S (= the mesh's ``axis``
      size); this rank takes its stage's slice
    microbatches: (M, *batch_shape), the same on every rank; all enter
      stage 0 in order.
    Returns (M, *batch_shape), replicated across the axis (the last
    stage's outputs, all-reduced: the reference's ``psum``)."""
    shards = shards_of(mesh, axis, microbatches.device)
    S, sid = shards.count, shards.index
    M = microbatches.shape[0]
    local = pytree.tree_map(lambda p: p[sid], stage_params)
    peer = lambda i: dist.get_global_rank(shards.group, i)
    h_in = torch.zeros_like(microbatches[0])
    outputs = torch.zeros_like(microbatches)
    for t in range(M + S - 1):
        # stage 0 pulls the next microbatch; the others use the received act
        inp = microbatches[min(t, M - 1)] if sid == 0 else h_in
        h_out = stage_fn(local, inp)
        # ship to the next stage (stage S-1 sends nowhere)
        ops = []
        if sid < S - 1:
            ops.append(dist.P2POp(dist.isend, h_out.contiguous(),
                                  peer(sid + 1), shards.group))
        if sid > 0:
            h_in = torch.empty_like(h_out)
            ops.append(dist.P2POp(dist.irecv, h_in, peer(sid - 1),
                                  shards.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        # last stage retires microbatch t - (S-1)
        m_out = t - (S - 1)
        if sid == S - 1 and 0 <= m_out < M:
            outputs[m_out] = h_out
    # only the last stage holds real outputs; the all-reduce replicates
    return all_reduce(outputs, shards.group)


def bubble_fraction(num_microbatches: int, num_stages: int) -> float:
    return (num_stages - 1) / (num_microbatches + num_stages - 1)
