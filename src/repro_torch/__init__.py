"""PyTorch/CUDA port of the OnAlgo selective edge-computing system.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``workload``, ``core``, ``kernels``, ``serve``) and runs on the
card by default (``device=None`` means ``cuda``).  It imports neither
``jax`` nor ``repro``.  ``interop`` builds its objects from the
reference's state handed over as numpy arrays.
"""

__version__ = "0.1.0"
