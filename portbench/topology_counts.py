"""The counted least work of a service call over K cloudlets: the single
cloudlet's (``counts.service_call``) and what the topology adds.

  walk     a mobility walk drawn on the device needs one uniform per
           (slot, device): the handover test (the candidate cloudlet,
           drawn only where a device hands over, is left out, as
           ``counts`` leaves out the candidate rate), ``counts.
           OPS_PER_UNIFORM`` operations each;
  gather   a device's price mu[k] is a read of its cloudlet's dual: no
           operation;
  scatter  its row load added onto its cloudlet's load: one operation per
           (slot, device); each cloudlet's ascent: 4 per (slot, cloudlet)
           (the load less the capacity, the step, the add, the clamp).

Bytes: the capacities in and the final duals out, float32 each.  The
association itself is an intermediate a fused program draws where it
needs it, and is not counted.
"""

from __future__ import annotations

from portbench import counts

WALK_UNIFORMS_PER_SLOT = 1
SCATTER_OPS_PER_DEVICE = 1
ASCENT_OPS_PER_CLOUDLET = 4


def topology_ops(T: int, N: int, K: int, *, walk: bool) -> int:
    walk_ops = (WALK_UNIFORMS_PER_SLOT * counts.OPS_PER_UNIFORM * T * N
                if walk else 0)
    return (walk_ops + SCATTER_OPS_PER_DEVICE * T * N
            + ASCENT_OPS_PER_CLOUDLET * T * K)


def service_call(T: int, N: int, M: int, S: int, K: int, *,
                 draws_in_engine: bool, walk: bool,
                 walk_in_engine: bool) -> dict:
    """``counts.service_call``'s figures of one call over K cloudlets:
    the whole call and the engine's part.  ``walk``: the association is
    a mobility walk drawn on the device, its draws in the engine where
    the engine regenerates its slabs (``walk_in_engine``: a streamed
    walk), else outside."""
    base = counts.service_call(T, N, M, S, draws_in_engine=draws_in_engine)
    duals = topology_ops(T, N, K, walk=False)
    draws = topology_ops(T, N, K, walk=walk) - duals
    ops = base["ops"] + duals + draws
    engine_ops = base["engine_ops"] + duals + (draws if walk_in_engine
                                                else 0)
    nbytes = base["bytes"] + 2 * 4 * K
    return {"ops": ops, "bytes": nbytes,
            "call_s": counts.least_s(ops, nbytes),
            "engine_ops": engine_ops,
            "engine_s": counts.least_s(engine_ops, nbytes)}
