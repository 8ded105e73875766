"""Requests completed in the window: a per-layer metric added by a file
of its own, read from the harness's record."""


def compute(record):
    return sum(1 for r in record["requests"] if r[3])
