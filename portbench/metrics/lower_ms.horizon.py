"""Host ms of a call of the materialized lowering (``serve/compile.py::
compile_service``: the workload draws, the gathers, the quantization),
synchronize-bracketed: the median over the window's calls.  Nothing where
the cell lowers by slabs."""

import numpy as np


def compute(record):
    s = record["spans"].get("lower")
    return 1e3 * float(np.median(s)) if s else None
