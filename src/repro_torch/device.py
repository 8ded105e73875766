"""Device selection for the port's entry points.

Every entry point takes ``device=None``, which means the card (``cuda``).
A caller that wants the CPU says so (``device="cpu"``), as the tests do.
There is no silent fallback: asking for ``cuda`` on a machine without a
CUDA device raises.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The torch.device an entry point runs on (None -> ``cuda``).

    Raises RuntimeError when a CUDA device is asked for (explicitly or by
    default) and ``torch.cuda.is_available()`` is False."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"repro_torch: device {str(dev)!r} requested but no CUDA device "
            "is available; pass device='cpu' to run the plain PyTorch path")
    return dev
