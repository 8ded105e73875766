"""Streaming (slab-addressable) lowering of the service workload.

Port of ``repro/workload/streaming.py``.  ``generate_service_workload``
materializes the whole (T, N) horizon; at fleet scale those arrays, not
the kernels, are the memory ceiling.  The counter-addressed v1 contract
makes any slab [t0, t0 + L) of the workload an O(L * N) function of
counters, so the engines generate the workload slab by slab inside their
rollout loop and peak memory does not grow with T.

Two of the three processes carry state across slots: the arrival chain
and the held channel rate.  One pass over the horizon's ROW_BLOCK-aligned
blocks (``lower_service_workload``) records the state ENTERING every
block (``on_entry`` / ``rate_entry``, (n_blocks, N), 64x smaller than the
horizon); a slab then resumes from the boundary state of its first
block.  Both the pass and a slab are one call of the draws kernel
(``kernels/draws.py``; its plain version on CPU tensors), so every slab
equals the same slots of ``generate_service_workload`` bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.workload import streams
from repro_torch.workload.service import ServiceWorkload, service_process


@dataclasses.dataclass
class StreamingWorkload:
    """The service workload lowered to a slab-addressable form.

    ``slab(t0, length)`` yields slots [t0, t0 + length) of the realization
    ``generate_service_workload(seed, T, N, ...)`` materializes, from
    O(length * N) device work and memory."""

    on_entry: torch.Tensor  # (n_blocks, N) bool: chain state entering b
    rate_entry: torch.Tensor  # (n_blocks, N) int32: held rate entering b
    proc: object  # the draws.ServiceProcess (seed, N, levels, p_*)
    T: int

    @property
    def N(self) -> int:
        return self.proc.N

    @property
    def n_blocks(self) -> int:
        return self.on_entry.shape[0]

    @property
    def seed(self) -> int:
        return self.proc.seed

    def _finish_slab(self, t0: int, length: int, n0: int,
                     n_cols: int) -> ServiceWorkload:
        """Resume the chain and the hold from the boundary states of t0's
        block over the blocks covering [t0, t0 + length) and keep those
        rows, device columns [n0, n0 + n_cols): one draws call."""
        from repro_torch.kernels import ops

        RB = streams.ROW_BLOCK
        t0, length = int(t0), int(length)
        if not (0 <= t0 and length >= 1 and t0 + length <= self.T):
            raise ValueError(f"slab [{t0}, {t0} + {length}) outside the "
                             f"horizon [0, {self.T})")
        b0, off = divmod(t0, RB)
        nb = (off + length - 1) // RB + 1
        cols = slice(n0, n0 + n_cols)
        on, img, rates = ops.draws(
            self.proc, b0, nb, (self.on_entry[b0, cols],
                                self.rate_entry[b0, cols]),
            off=off, length=length, n0=n0, n_cols=n_cols,
            device=self.on_entry.device)
        return ServiceWorkload(on=on, img=img, rates=rates)

    def slab(self, t0: int, length: int) -> ServiceWorkload:
        """Slots [t0, t0 + length) of the realized workload.  Any t0: the
        reference's ``aligned=`` fast path for block-aligned starts has no
        counterpart, since the draws kernel walks only the rows up to the
        slab's end whatever the alignment."""
        return self._finish_slab(t0, length, 0, self.N)

    def slab_cols(self, t0: int, length: int, n0: int,
                  n_cols: int) -> ServiceWorkload:
        """Device columns [n0, n0 + n_cols) of ``slab(t0, length)``,
        bit-identical to slicing it: each device is drawn at its absolute
        column counter, from O(length * n_cols) work."""
        return self._finish_slab(t0, length, int(n0), int(n_cols))


def lower_service_workload(seed, T: int, N: int, pool_size: int,
                           num_rates: int,
                           burst_len: Tuple[int, int] = (5, 10),
                           mean_gap=8.0, channel_stay=0.9, *,
                           device) -> StreamingWorkload:
    """Lower the ``(seed, T, N)`` service workload to streaming form on
    ``device``: one draws call in boundary form walks every block of the
    horizon and writes only the chain and rate states entering each
    block, (ceil(T / ROW_BLOCK), N), never the (T, N) horizon."""
    from repro_torch.kernels import ops

    proc = service_process(seed, N, pool_size, num_rates, burst_len,
                           mean_gap, channel_stay)
    n_blocks = -(-T // streams.ROW_BLOCK)
    on_entry, rate_entry = ops.draws(proc, 0, n_blocks, boundary=True,
                                     device=device)
    return StreamingWorkload(on_entry=on_entry, rate_entry=rate_entry,
                             proc=proc, T=T)
