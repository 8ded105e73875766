"""The whole call's share of the card's peak, %: the counted least time of
a call (``counts.service_call``: rollout and draws, at the float32 peak
and the HBM rate) over its mean host-clock wall in the window."""


def compute(record):
    walls = [r[1] - r[0] for r in record["requests"] if r[3]]
    if not walls:
        return None
    return 100.0 * record["cost"]["call_s"] * len(walls) / sum(walls)
