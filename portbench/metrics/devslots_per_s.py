"""Device-slots a second: N * T of every request completed in the window
over the window's seconds (host clock, first submission to last result)."""


def compute(record):
    done = sum(r[2] for r in record["requests"] if r[3])
    return done / record["window_s"] if record["window_s"] > 0 else None
