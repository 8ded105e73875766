"""The counted least work of a service call and the H100's published peaks.

Derived from ``chip_smoke.py::rollout_cost``: the rollout needs 10
float32 operations per (slot, device, state) (rho, the price's three,
two compares, two products, two adds of the row sums) and 12 per (slot,
device) (the decision and the dual's step).  Where the workload is drawn
on the device, its threefry work counts too: three uniforms per (slot,
device) (the arrival chain, the image, the channel flip; the candidate
rate, drawn only where the channel flips, is left out), each 72 integer
operations of threefry-2x32 (20 rounds of add, rotate and xor, the key
injections, the counter's first add) and 4 to make the float.  Integer
operations are priced at the float32 peak, which only lowers the bound.

Bytes count only what a call must move: the pool's per-image tables in
(cycles, phi_hat, sigma and the two correctness flags, float32), the
per-device budget in, the final per-device state out (lam and the (N, M)
visit counts, float32) and the metrics out.  The (T, N) trace, the raw
overlay and the slabs are intermediates a fused program need not write,
and are not counted, so a share of the bound stays under 1 whatever the
program fuses.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

ROLLOUT_OPS_PER_STATE = 10
ROLLOUT_OPS_PER_DEVICE = 12
UNIFORMS_PER_SLOT = 3
OPS_PER_UNIFORM = 72 + 4
METRICS = 8


def rollout_ops(T: int, N: int, M: int) -> int:
    return (ROLLOUT_OPS_PER_STATE * T * N * M
            + ROLLOUT_OPS_PER_DEVICE * T * N)


def draws_ops(T: int, N: int) -> int:
    return UNIFORMS_PER_SLOT * OPS_PER_UNIFORM * T * N


def call_bytes(N: int, M: int, S: int) -> int:
    """Pool tables and budgets in, final state and metrics out."""
    return 5 * 4 * S + 4 * N + (4 * N + 4 * N * M) + 8 * METRICS


def least_s(ops: int, nbytes: int) -> float:
    """The least time of ``ops`` float32 operations over ``nbytes`` bytes:
    the larger of the two at the peaks."""
    return max(ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def service_call(T: int, N: int, M: int, S: int, *,
                 draws_in_engine: bool) -> dict:
    """The counted work of one ``simulate_service`` call over N devices,
    T slots, M states and S images: the whole call's ops and bytes (the
    draws and the rollout) and the part inside the engine's call
    (``simulate_chunked``, or ``simulate_chunked_stream``, which draws
    its slabs itself where ``draws_in_engine``)."""
    roll, draws, nbytes = rollout_ops(T, N, M), draws_ops(T, N), \
        call_bytes(N, M, S)
    engine_ops = roll + (draws if draws_in_engine else 0)
    return {"ops": roll + draws, "bytes": nbytes,
            "call_s": least_s(roll + draws, nbytes),
            "engine_ops": engine_ops,
            "engine_s": least_s(engine_ops, nbytes)}
