"""Calibrate chip_smoke phase 12c's bf16 bar on the CPU.

Phase 12c holds each configuration's kernel route (use_kernel=True)
against its plain route in bf16: prefill 4 prompts of 16 tokens, then 8
decode steps on the same tokens, and compares the last-position logits
within BF16_PATH_BAR of max(max |logit|, 1).  On CPU tensors the kernel
route runs the kernels' plain versions, which round as the kernels do
(K6 keeps its probabilities in float32; the plain decode attention rounds
them to the cache's dtype, as the reference does), so this measures the
rounding gap that the bar has to hold, at the published depths and head
layouts and narrower widths than the card's (d_model and d_ff cut,
vocab 4096).  The comparison is phase 12c's own
(``chip_smoke.zoo_route_gap``): an MoE model's row is held up to its
first routing flip.

    PYTHONPATH=src python scripts/zoo_bf16_bar_cpu.py [arch ...]

Prints, per architecture, max |diff| as a share of max(|logit|, 1).
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.api import ModelAPI  # noqa: E402

# the widths cut for the CPU; depth, heads, KV heads and head size stay
NARROW = {
    "yi-9b": dict(d_model=512, d_ff=1024),
    "command-r-35b": dict(d_model=512, d_ff=1024),
    "deepseek-67b": dict(d_model=1024, d_ff=2752),
    "internvl2-1b": dict(d_model=448, d_ff=1024),
    "seamless-m4t-medium": dict(d_model=512, d_ff=1024),
    "arctic-480b": dict(d_model=512, d_ff=512, moe_d_ff=256),
}


def share(arch: str, layers) -> float:
    full = get_config(arch)
    cfg = dataclasses.replace(full, vocab_size=4096, **NARROW[arch])
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    api = ModelAPI(cfg)
    params, _ = api.init(torch.Generator().manual_seed(0))
    B, S, steps = cs.ZOO_B, cs.ZOO_PROMPT, cs.ZOO_STEPS
    gen = torch.Generator().manual_seed(1)
    batch = cs.zoo_inputs(cfg, B, S, gen, "cpu")
    feed = torch.randint(0, cfg.vocab_size, (B, steps), generator=gen,
                         dtype=torch.int32)
    max_len = cs.zoo_max_len(cfg, S, steps)
    gap = cs.zoo_route_gap(api, params, batch, feed, max_len)
    return gap["err"] / gap["scale"]


def main(archs):
    for arch, layers in cs.ZOO_ON_CARD:
        if not archs or arch in archs:
            print(f"{arch} ({layers or 'all'} layers, narrow widths, CPU, "
                  f"bf16): max |diff| {share(arch, layers):.5f} of "
                  f"max(|logit|, 1) (bar {cs.BF16_PATH_BAR})", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
