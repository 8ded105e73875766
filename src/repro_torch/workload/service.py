"""Counter-based generation of the service tier's workload processes.

Port of ``repro/workload/service.py``: bursty ON/OFF arrivals, the
per-slot image stream and the Markov channel, each slot (t, n) a pure
function of ``(seed, stream_id, t, n)`` and bit-identical to the JAX
package's draws.  The scalar probabilities are rounded to float32 the
way the reference computes them (float32 arithmetic on the mean gap).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.workload import streams
from repro_torch.workload.streams import RNG_COUNTER, RNG_LEGACY_HOST


@dataclasses.dataclass
class ServiceWorkload:
    """Realized service workload: (T, N) arrival mask, image ids, rates."""

    on: torch.Tensor  # (T, N) bool arrivals
    img: torch.Tensor  # (T, N) int32 image-pool indices
    rates: torch.Tensor  # (T, N) int32 channel-rate indices


def arrival_chain_probs(burst_len: Tuple[int, int], mean_gap):
    """(p_on, p_stay, p_init) of the Markov ON/OFF chain matching the
    legacy renewal arrivals in the mean (bursts average (lo + hi)/2 slots,
    gaps 1 + mean_gap slots; p_init is the stationary ON share).

    ``mean_gap`` enters as float32 and the arithmetic runs in float32, as
    in the reference (which traces it as a float32 scalar)."""
    mean_gap = np.float32(mean_gap)
    mean_on = max((burst_len[0] + burst_len[1]) / 2.0, 1.0)
    mean_off = np.float32(1.0) + mean_gap
    p_stay = np.float32(1.0 - 1.0 / mean_on)
    p_on = np.float32(1.0) / mean_off
    p_init = np.float32(mean_on) / (np.float32(mean_on) + mean_off)
    return float(p_on), float(p_stay), float(p_init)


def service_process(seed, N: int, pool_size: int, num_rates: int,
                    burst_len: Tuple[int, int] = (5, 10), mean_gap=8.0,
                    channel_stay=0.9):
    """The ``draws.ServiceProcess`` of ``(seed, N)``: the chain
    probabilities and the channel-change probability as float32 values,
    rounded as the reference computes them."""
    from repro_torch.kernels.draws import ServiceProcess

    p_on, p_stay, p_init = arrival_chain_probs(burst_len, mean_gap)
    p_change = float(np.float32(1.0) - np.float32(channel_stay))
    return ServiceProcess(seed=int(seed), N=N, pool_size=pool_size,
                          num_rates=num_rates, p_on=p_on, p_stay=p_stay,
                          p_init=p_init, p_change=p_change)


def generate_service_workload(seed, T: int, N: int, pool_size: int,
                              num_rates: int,
                              burst_len: Tuple[int, int] = (5, 10),
                              mean_gap=8.0, channel_stay=0.9, *,
                              device) -> ServiceWorkload:
    """Materialize the v1 service workload for ``(seed, T, N)`` on
    ``device``: one draws call over blocks [0, ceil(T / ROW_BLOCK)) feeds
    the four per-slot channels (arrival chain, image draw, channel flip,
    candidate rate) and keeps slots [0, T) (the draws kernel on the card,
    its plain version, the eager streams code, on the CPU)."""
    from repro_torch.kernels import ops

    proc = service_process(seed, N, pool_size, num_rates, burst_len,
                           mean_gap, channel_stay)
    on, img, rates = ops.draws(proc, 0, -(-T // streams.ROW_BLOCK),
                               length=T, device=device)
    return ServiceWorkload(on=on, img=img, rates=rates)


def validate_rng_version(rng_version: int) -> int:
    if rng_version == RNG_LEGACY_HOST:
        raise ValueError(
            "rng_version=0 (legacy host draw order) is retired: the pinned "
            "golden fixture (tests/golden/service_legacy_fig5.json) and its "
            "frozen sampler (tests/legacy_workload.py) are its only "
            "residue — use the counter-based v1 contract")
    if rng_version != RNG_COUNTER:
        raise ValueError(
            f"unknown rng_version {rng_version!r}; the only live contract "
            f"is {RNG_COUNTER} (counter-based streams)")
    return rng_version
