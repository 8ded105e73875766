"""The counted least work against hand counts."""

import pytest

from portbench import counts


@pytest.mark.parametrize("T, N, M, S, ops, nbytes", [
    # 10 T N M + 12 T N;  5*4 S + 4 N + 4 N + 4 N M + 64
    (2, 3, 5, 7, 10 * 30 + 12 * 6, 140 + 12 + 12 + 60 + 64),
    (4, 8, 73, 16, 10 * 2336 + 12 * 32, 320 + 32 + 32 + 2336 + 64),
])
def test_hand_counts(T, N, M, S, ops, nbytes):
    assert counts.rollout_ops(T, N, M) == ops
    assert counts.call_bytes(N, M, S) == nbytes
    assert counts.draws_ops(T, N) == 3 * 76 * T * N
    c = counts.service_call(T, N, M, S, draws_in_engine=False)
    assert c["engine_ops"] == ops
    assert c["ops"] == ops + 3 * 76 * T * N
    assert c["call_s"] == max(c["ops"] / 67e12, nbytes / 3.35e12)
    assert counts.service_call(T, N, M, S, draws_in_engine=True)[
        "engine_ops"] == c["ops"]


def test_bytes_hold_no_horizon():
    """No (T, N) trace, overlay or slab is counted: the bytes do not grow
    with the horizon, so a fully fused call cannot read over 100%."""
    a = counts.service_call(16, 1000, 73, 64, draws_in_engine=True)
    b = counts.service_call(4096, 1000, 73, 64, draws_in_engine=True)
    assert a["bytes"] == b["bytes"]
    # a trace alone (int32 j and five float32 streams) would exceed them
    assert 24 * 4096 * 1000 > b["bytes"]
