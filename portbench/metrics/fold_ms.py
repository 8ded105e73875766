"""Host ms of a call of the accounting fold (``serve/compile.py::
service_metrics``), synchronize-bracketed: the median over the window's
calls."""

import numpy as np


def compute(record):
    s = record["spans"].get("fold")
    return 1e3 * float(np.median(s)) if s else None
