"""Training entrypoint: ``python -m repro_torch.launch.train --arch olmo-1b``.

Port of ``repro/launch/train.py``: the fault-tolerant loop (auto-resume,
preemption-safe checkpoints, prefetch with a straggler deadline) over the
synthetic token stream, with the reference's flags and lines.  It runs on
the card unless ``--device cpu`` is given:

    python -m repro_torch.launch.train --arch olmo-1b --reduced \\
        --steps 20 --device cpu --ckpt-dir /tmp/ckpt
"""

from __future__ import annotations

import argparse
import signal

import torch

from repro_torch.configs import get_config
from repro_torch.data.lm_data import (LMStreamSpec, conditional_entropy,
                                      token_stream)
from repro_torch.device import resolve_device
from repro_torch.models.api import ModelAPI
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.trainer import (PrefetchIterator, TrainLoop,
                                       TrainState, make_train_step)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the loop; returns (state, history)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    api = ModelAPI(cfg)
    print(f"[train] arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"devices=1")

    params, _ = api.init(torch.Generator(device=dev).manual_seed(args.seed))
    spec = opt_lib.OptimizerSpec(name=cfg.optimizer, lr=args.lr)
    lr_fn = opt_lib.cosine_schedule(args.lr, warmup=max(args.steps // 20, 5),
                                    total=args.steps)
    step_fn = make_train_step(api.loss, spec, lr_fn, accum_steps=args.accum)
    state = TrainState.create(params, spec)

    stream = LMStreamSpec(vocab_size=cfg.vocab_size, batch=args.batch,
                          seq_len=args.seq_len, seed=args.seed)
    print(f"[train] synthetic stream loss floor ~"
          f"{conditional_entropy(stream):.3f} nats")
    batches = PrefetchIterator(token_stream(stream), depth=2, deadline_s=30.0)

    mgr = CheckpointManager(args.ckpt_dir, keep=3)
    loop = TrainLoop(step_fn, mgr, ckpt_every=args.ckpt_every, log_every=10)
    previous = signal.getsignal(signal.SIGTERM)
    loop.install_signal_handler()
    try:
        state, history = loop.run(state, batches, num_steps=args.steps)
    finally:  # a caller in the same process gets its handler back
        signal.signal(signal.SIGTERM, previous)
    if batches.stragglers:
        print(f"[train] straggler batches skipped: {batches.stragglers}")
    print(f"[train] finished at step {int(state.step)}; "
          f"final loss {history[-1]['loss']:.4f}" if history else "")
    return state, history


if __name__ == "__main__":
    main()
