"""CPU rehearsal of chip_smoke phase 13b's loss curve: olmo-1b's widths
and vocabulary (d_model 2048, V = 50304) at one layer, in float32, six
AdamW steps of launch.train's schedule (lr 1e-3, warmup 15 of 300) on
token_stream(batch=8, seq_len=128); then the first batch's loss again.

The head starts random (N(0, 0.02^2) over a unit-RMS hidden state), so the
first loss sits near ln V + d_model * 0.02^2 / 2, above ln V.

    PYTHONPATH=src python scripts/train_loss_rehearsal_cpu.py   (~1 min)
"""

import dataclasses
import math
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.lm_data import LMStreamSpec, token_stream
from repro_torch.models.api import ModelAPI
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import TrainState, make_train_step, to_device


def main():
    torch.set_num_threads(4)
    cfg = dataclasses.replace(get_config("olmo-1b"), num_layers=1,
                              dtype_name="float32", remat="none")
    api = ModelAPI(cfg)
    params, _ = api.init(torch.Generator().manual_seed(0))
    spec = opt.OptimizerSpec(name="adamw", lr=1e-3)
    state = TrainState.create(params, spec)
    step = make_train_step(api.loss, spec,
                           opt.cosine_schedule(1e-3, warmup=15, total=300))
    stream = token_stream(LMStreamSpec(vocab_size=cfg.vocab_size, batch=8,
                                       seq_len=128, seed=0))
    first = next(stream)
    print(f"ln V = {math.log(cfg.vocab_size):.4f}, ln V + D*0.02^2/2 = "
          f"{math.log(cfg.vocab_size) + cfg.d_model * 4e-4 / 2:.4f}")
    batch = first
    for i in range(6):
        t = time.time()
        state, m = step(state, batch)
        print(f"step {i + 1}: loss {float(m['loss']):.6f} "
              f"({time.time() - t:.1f} s)", flush=True)
        batch = next(stream)
    with torch.no_grad():
        loss, _ = api.loss(state.params, to_device(first, "cpu"))
    print(f"the first batch after 6 steps: loss {float(loss):.6f}")


if __name__ == "__main__":
    main()
