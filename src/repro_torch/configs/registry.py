"""Architecture registry: --arch <id> resolves through here.

The port lists the architectures it runs; every other architecture of
the reference's registry raises ``NotImplementedError`` naming the
ROADMAP item that brings it."""

from __future__ import annotations

import importlib

ARCHS = ["olmo_1b", "mamba2_370m"]

# the reference's other architectures -> the ROADMAP item that ports them
NOT_PORTED = {
    "jamba_v01_52b": "A12 (model zoo: MoE and hybrid blocks)",
    "command_r_35b": "A12 (model zoo)",
    "deepseek_67b": "A12 (model zoo)",
    "yi_9b": "A12 (model zoo)",
    "seamless_m4t_medium": "A12 (model zoo: encoder-decoder)",
    "internvl2_1b": "A12 (model zoo: VLM prefix embeddings)",
    "arctic_480b": "A12 (model zoo: MoE blocks)",
    "olmoe_1b_7b": "A12 (model zoo: MoE blocks)",
}


def _key(name: str) -> str:
    return name.replace("-", "_").replace(".", "")  # jamba-v0.1-52b etc.


def get_config(name: str):
    key = _key(name)
    if key in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet: ROADMAP.md, queue "
            f"{NOT_PORTED[key]}")
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{key}").CONFIG


def list_archs():
    return list(ARCHS)
