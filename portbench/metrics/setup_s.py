"""Process start to the window's first request: imports, CUDA, the
kernels' libraries (built on a checkout's first run), the pool and the
warm-up of the cell's own shapes (host clock, s)."""


def compute(record):
    return record["setup_s"]
