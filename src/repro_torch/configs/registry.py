"""Architecture registry: --arch <id> resolves through here (port of
``repro/configs/registry.py``: the same ten architectures and aliases)."""

from __future__ import annotations

import importlib

ARCHS = [
    "jamba_v01_52b",
    "command_r_35b",
    "deepseek_67b",
    "olmo_1b",
    "yi_9b",
    "seamless_m4t_medium",
    "internvl2_1b",
    "mamba2_370m",
    "arctic_480b",
    "olmoe_1b_7b",
]

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def get_config(name: str):
    key = _ALIASES.get(name, name)
    key = key.replace("-", "_").replace(".", "")  # jamba-v0.1-52b etc.
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{key}").CONFIG


def list_archs():
    return list(ARCHS)
