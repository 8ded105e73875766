"""Gradient compression for data parallelism on torch.distributed.

Port of ``repro/train/compression.py``: an int8 quantized all-reduce with
error feedback.  Each shard quantizes its local gradient plus its
residual to int8 with a scale common to every shard (a MAX all-reduce of
the local max |g| first), sums the int8 payloads in int32 accumulators (a
SUM all-reduce), dequantizes the mean, and keeps the quantization error
as its next residual.  Both all-reduces go through
``core.collectives.all_reduce`` (counted), over the mesh axis's process
group (``axis_name``), as the reference's psums run over its mesh axis.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.collectives import all_reduce
from repro_torch.train.tree import named_leaves


def quantize_int8(x: torch.Tensor):
    """Per-tensor symmetric int8 quantization. Returns (q, scale)."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(grads: dict, residual: dict, axis_name):
    """Quantize (grad + residual), sum the int8 payloads over the shards
    of ``axis_name`` (a ProcessGroup), dequantize; returns (mean_grads,
    new_residual), dicts keyed as ``grads``.

    The scales are MAX-reduced first, so every shard uses a common scale:
    the int8 sum then fits int32 exactly for <= 2^23 shards.  Two
    all-reduces a leaf."""
    n = dist.get_world_size(axis_name)

    def one(g, r):
        g32 = g.float() + r
        amax = all_reduce(torch.max(torch.abs(g32)), axis_name, op="max")
        scale = torch.clamp_min(amax, 1e-12) / 127.0
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int32)
        total = all_reduce(q.clone(), axis_name)  # q stays local
        mean = total.float() * scale / n
        new_r = g32 - q.float() * scale  # local residual
        return mean.to(g.dtype), new_r

    out = {k: one(g, residual[k]) for k, g in grads.items()}
    return ({k: t[0] for k, t in out.items()},
            {k: t[1] for k, t in out.items()})


def init_residual(params) -> dict:
    """Zero float32 residuals, keyed by the parameters' names."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in named_leaves(params).items()}
