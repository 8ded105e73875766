"""Host ms of a call of the engine (``core/fleet.py::simulate_chunked`` or
``simulate_chunked_stream``), synchronize-bracketed: the median over the
window's calls."""

import numpy as np


def compute(record):
    s = record["spans"].get("engine")
    return 1e3 * float(np.median(s)) if s else None
