"""Compile-mode knobs threaded through model code via a context (port of
``repro/parallel/compile_mode.py``).

``unrolled_scans()``: the reference emits every model-side ``lax.scan``
fully unrolled inside it, because XLA's cost analysis counts a while
body once.  The port's models run eagerly: a scan is a Python loop, and
an eager trace (the dry run's) sees every iteration, so the flag changes
nothing here.  It is kept, with ``scan``, so that code written against
the reference's knobs runs unchanged.

``flash_block``: KV block size of the plain chunked-flash attention
(``models.attention.flash_attention``); the dry run traces at 2048, as
the reference's does.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils import _pytree as pytree


class _Mode:
    """The active knobs, process-wide (see ``sharding._Ctx``: a
    checkpointed forward is recomputed on the autograd engine's thread)."""

    def __init__(self):
        self.unroll = False
        self.flash_block = 512


_MODE = _Mode()


@contextlib.contextmanager
def compile_options(unroll_scans: bool = None, flash_block: int = None):
    old = (_MODE.unroll, _MODE.flash_block)
    if unroll_scans is not None:
        _MODE.unroll = unroll_scans
    if flash_block is not None:
        _MODE.flash_block = flash_block
    try:
        yield
    finally:
        _MODE.unroll, _MODE.flash_block = old


def unrolled_scans() -> contextlib.AbstractContextManager:
    return compile_options(unroll_scans=True)


def scan_unroll_flag() -> bool:
    return _MODE.unroll


def flash_block_size() -> int:
    return _MODE.flash_block


def scan(body, init, xs, length=None):
    """``lax.scan``'s contract as a Python loop: ``body(carry, x) ->
    (carry, y)`` over the leading axis of ``xs`` (a tensor tree, or None
    with ``length``); returns (final carry, the ys stacked on a new
    leading axis, or None when the body returns no y)."""
    leaves, spec = pytree.tree_flatten(xs)
    n = length if length is not None else leaves[0].shape[0]
    carry, ys = init, []
    for i in range(n):
        x = None if xs is None else pytree.tree_unflatten(
            [leaf[i] for leaf in leaves], spec)
        carry, y = body(carry, x)
        ys.append(y)
    if not ys or all(y is None for y in ys):
        return carry, None
    return carry, pytree.tree_map(lambda *a: torch.stack(a), *ys)
