"""The 95th percentile of the latency of every request in the window,
submission to its result after a synchronize (host clock, ms)."""

import numpy as np


def compute(record):
    lat = [1e3 * (r[1] - r[0]) for r in record["requests"]]
    return float(np.percentile(lat, 95)) if lat else None
