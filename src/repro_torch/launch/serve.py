"""Serving entrypoint: OnAlgo-gated edge serving against a cloudlet LM.

``python -m repro_torch.launch.serve --arch olmo-1b --reduced --slots 50``

Port of ``repro/launch/serve.py``.  Each slot: the device fleet produces
analytics tasks; the admission controller (the paper's algorithm) decides
which are offloaded, pricing the cloudlet's FLOP budget through the
congestion dual mu; admitted requests are batched into the serving
engine.  Both run with ``use_kernel=True``: on the card the admission
step launches K3, every decode step K6 in each attention layer, and every
prefill K4 in each SSM layer (``--arch mamba2-370m``, Jamba's Mamba
layers); on CPU tensors (``--device cpu``) the same calls run the
kernels' plain versions.  Any decoder-only architecture of the registry
serves (a VLM on its text tokens, as the reference's engine does); an
encoder-decoder takes ``ModelAPI`` with its source frames.  Prints the
reference's lines.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.onalgo import OnAlgoParams, StepRule
from repro_torch.core.state_space import StateSpace
from repro_torch.device import resolve_device
from repro_torch.models.api import ModelAPI
from repro_torch.serve.admission import AdmissionController, flops_per_request
from repro_torch.serve.engine import Batcher, ServingEngine


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--slots", type=int, default=50)
    ap.add_argument("--devices", type=int, default=32)
    ap.add_argument("--budget-mw", type=float, default=60.0)
    ap.add_argument("--pod-flops-frac", type=float, default=0.3,
                    help="fraction of always-offload load the pod can serve")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build_model(args):
    """(cfg, params): the architecture and its random weights from
    ``args.seed``, drawn on ``args.device``."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    params, _ = ModelAPI(cfg).init(torch.Generator(device=dev).manual_seed(
        args.seed))
    return cfg, params


def serve(args, cfg, params, *, on_wave=None, log=print):
    """The serving loop of ``main``: ``args.slots`` slots of admission +
    waves through the engine, on ``args.device`` with ``params`` there.
    ``on_wave(tokens, out)`` sees each wave's prompt tokens and generated
    ids.  Returns (engine, controller, served, offered).  The engine
    serves token batches, as the reference's: an encoder-decoder, which
    needs source frames, is served through ``ModelAPI`` instead."""
    if cfg.family == "encdec":
        raise ValueError(
            f"{cfg.name} is an encoder-decoder: the serving engine takes "
            "token batches; call ModelAPI.prefill_step with src_embeds")
    dev = resolve_device(args.device)
    engine = ServingEngine(cfg, params,
                           max_len=args.prompt_len + args.gen_steps + 1,
                           use_kernel=True, device=dev)

    N = args.devices
    h_req = flops_per_request(cfg, args.prompt_len, "prefill") \
        + args.gen_steps * flops_per_request(cfg, 1, "decode")
    H = args.pod_flops_frac * N * h_req
    rng = np.random.default_rng(args.seed)

    space = StateSpace(o_levels=(0.03, 0.06, 0.09),
                       h_levels=(0.8 * h_req, h_req, 1.2 * h_req),
                       w_levels=tuple(np.linspace(0, 0.4, 8).tolist()))
    params_oa = OnAlgoParams(
        B=torch.full((N,), np.float32(args.budget_mw * 1e-3),
                     dtype=torch.float32, device=dev),
        H=torch.tensor(np.float32(H), device=dev))
    ctrl = AdmissionController(space, params_oa, StepRule.inv_sqrt(0.5), N,
                               use_kernel=True, device=dev)
    batcher = Batcher(max_batch=16)

    served = offered = 0
    for t in range(args.slots):
        task = rng.random(N) < 0.7
        o = rng.choice([0.03, 0.06, 0.09], N)
        h = np.clip(rng.normal(h_req, 0.1 * h_req, N), 0.5 * h_req, None)
        w = np.clip(rng.normal(0.15, 0.1, N), 0, 1)
        admit = ctrl.admit(o, h, w, task)
        offered += int(task.sum())
        for _ in np.nonzero(admit)[0]:
            batcher.submit(rng.integers(0, cfg.vocab_size,
                                        args.prompt_len).tolist())
        wave = batcher.next_wave()
        if wave:
            toks = Batcher.pad_tokens(wave, args.prompt_len)
            out = engine.generate(toks, steps=args.gen_steps)
            if on_wave is not None:
                on_wave(toks, out)
            served += len(wave)
        if (t + 1) % 10 == 0:
            log(f"[serve] slot {t+1}: served {served}/{offered} tasks, "
                f"mu={ctrl.mu:.3f}, queue={len(batcher)}")
    log(f"[serve] done: served {served} of {offered} offered tasks; "
        f"decode calls {engine.stats.decode_calls}, "
        f"tokens {engine.stats.tokens_decoded}")
    return engine, ctrl, served, offered


def main(argv=None):
    args = parse_args(argv)
    cfg, params = build_model(args)
    serve(args, cfg, params)


if __name__ == "__main__":
    main()
