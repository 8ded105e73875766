"""Fault-tolerant training loop and the train step.

Port of ``repro/train/trainer.py``:

  * auto-resume from the latest valid checkpoint (``CheckpointManager``);
  * preemption handling: SIGTERM sets a flag, and the loop saves and stops
    at the next step boundary;
  * straggler mitigation at the input layer: the prefetching iterator has
    a per-batch deadline; on timeout the previous batch is reused (and
    counted) instead of stalling the loop;
  * gradient accumulation over microbatches in float32.

A batch is host data (numpy arrays, in a dict or a tuple) until the step
moves it to the parameters' device.  The loop reads the step counter
back once a step (``int(state.step)``), a host synchronization, as the
reference's loop does.  Under a mesh (DTensor parameters) each gradient
is placed as its parameter before the update: the FSDP reduce-scatter.
"""

from __future__ import annotations

import dataclasses
import queue
import signal
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.parallel.sharding import placed_like
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.tree import named_leaves


@dataclasses.dataclass
class TrainState:
    params: object  # a parameter module, or nested dicts of tensors
    opt_state: dict
    step: torch.Tensor  # () int32 on the parameters' device

    @staticmethod
    def create(params, opt_spec: opt_lib.OptimizerSpec):
        """The initial state of ``params``, which become trainable
        (``requires_grad``) in place."""
        leaves = named_leaves(params)
        for p in leaves.values():
            p.requires_grad_(True)
        dev = next(iter(leaves.values())).device
        return TrainState(params=params,
                          opt_state=opt_lib.init_opt_state(opt_spec, params),
                          step=torch.zeros((), dtype=torch.int32, device=dev))


def to_device(batch, device):
    """A host batch (numpy arrays or tensors, in dicts / tuples / lists) on
    ``device``."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(to_device(v, device) for v in batch)
    if isinstance(batch, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(batch)).to(device)
    if isinstance(batch, torch.Tensor):
        return batch.to(device)
    return batch


def _split(batch, n: int, i: int):
    """Microbatch i of n along every leaf's leading axis."""
    if isinstance(batch, dict):
        return {k: _split(v, n, i) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_split(v, n, i) for v in batch)
    size = batch.shape[0] // n
    return batch[i * size:(i + 1) * size]


def make_train_step(loss_fn: Callable, opt_spec: opt_lib.OptimizerSpec,
                    lr_fn: Callable, accum_steps: int = 1):
    """loss_fn(params, batch) -> (loss, metrics dict).

    Returns train_step(state, batch) -> (new state, metrics): the loss and
    its gradients under autograd (the parameters must require grad:
    ``TrainState.create``), then ``optimizer.apply_update``, which writes
    the parameters and moments in place.  With accum_steps > 1 the batch's
    leading axis is split into microbatches and the gradients (float32)
    and losses summed over them, then divided by accum_steps, as the
    reference's scan does.  The metrics stay tensors on the device."""

    def grads_of(params, batch):
        leaves = named_leaves(params)
        with torch.enable_grad():
            loss, metrics = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        grads = {k: (torch.zeros_like(p) if g is None else placed_like(g, p))
                 for (k, p), g in zip(leaves.items(), grads)}
        return loss.detach(), metrics, grads

    def train_step(state: TrainState, batch):
        dev = state.step.device
        batch = to_device(batch, dev)
        if accum_steps == 1:
            loss, metrics, grads = grads_of(state.params, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                     for k, p in named_leaves(state.params).items()}
            for i in range(accum_steps):
                mb_loss, _, mb_grads = grads_of(
                    state.params, _split(batch, accum_steps, i))
                loss = loss + mb_loss
                for k, g in mb_grads.items():
                    grads[k] += g.float()
            loss = loss / accum_steps
            grads = {k: g / accum_steps for k, g in grads.items()}
            metrics = {}

        lr = lr_fn(state.step)
        params, opt_state, gnorm = opt_lib.apply_update(
            opt_spec, state.params, grads, state.opt_state, lr)
        new_state = TrainState(params=params, opt_state=opt_state,
                               step=state.step + 1)
        out = {"loss": loss, "grad_norm": gnorm, "lr": lr,
               **{k: (v.detach() if isinstance(v, torch.Tensor) else v)
                  for k, v in metrics.items()}}
        return new_state, out

    return train_step


class PrefetchIterator:
    """Background-thread prefetch with a straggler deadline.

    On a slow fetch (deadline exceeded) the previous batch is reused and
    the event is counted: a slow data worker never stalls the step loop."""

    def __init__(self, it: Iterator, depth: int = 2,
                 deadline_s: Optional[float] = None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._deadline = deadline_s
        self._last = None
        self.stragglers = 0
        self._done = False

        def work():
            try:
                for item in it:
                    self._q.put(item)
            finally:
                self._q.put(None)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        try:
            item = self._q.get(timeout=self._deadline)
        except queue.Empty:
            if self._last is None:
                item = self._q.get()  # nothing to reuse yet: block
            else:
                self.stragglers += 1
                return self._last
        if item is None:
            self._done = True
            raise StopIteration
        self._last = item
        return item


def _scalar(v) -> float:
    return float(v.item()) if isinstance(v, torch.Tensor) else float(v)


@dataclasses.dataclass
class TrainLoop:
    """Checkpointed, preemption-safe loop around a train step."""

    train_step: Callable
    manager: CheckpointManager
    ckpt_every: int = 100
    log_every: int = 10
    log_fn: Callable = print

    def __post_init__(self):
        self._preempted = threading.Event()

    def install_signal_handler(self):
        def handler(signum, frame):
            self._preempted.set()

        signal.signal(signal.SIGTERM, handler)

    def preempt(self):  # for tests
        self._preempted.set()

    def run(self, state: TrainState, batches: Iterator, num_steps: int):
        """Resumes from the latest checkpoint if one exists; returns
        (state, history list)."""
        restored, step0 = self.manager.restore(like=state)
        if restored is not None:
            state = restored
            self.log_fn(f"[trainer] resumed from step {step0}")
        history = []
        t0 = time.time()
        start = int(state.step)
        for i, batch in enumerate(batches):
            if start + i >= num_steps:
                break
            state, metrics = self.train_step(state, batch)
            step = int(state.step)
            if step % self.log_every == 0:
                m = {k: _scalar(v) for k, v in metrics.items()}
                history.append({"step": step, **m})
                self.log_fn(f"[trainer] step {step} "
                            f"loss {m.get('loss', float('nan')):.4f} "
                            f"({(time.time()-t0):.1f}s)")
            if step % self.ckpt_every == 0:
                self.manager.save(step, state)
            if self._preempted.is_set():
                self.log_fn(f"[trainer] preempted at step {step}; saving")
                self.manager.save(step, state)
                self.manager.wait()
                break
        self.manager.save(int(state.step), state)
        self.manager.wait()
        return state, history
