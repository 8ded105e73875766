"""The port's own tracing (``repro_torch.obs``) on the CPU.

A service call under a CPU-only ``torch.profiler`` records its span tree
(materialized: ``service > {lower > {draws, quantize, on_copy}, engine >
{rollout, series}, fold, release}``; streamed: a ``slab`` a slab, each
with draws, quantize, rollout and series), every span of a call under
the call's id and inside its parent, and ``host_syncs`` the places on
the path where a card would make the host wait.  With the profiler off
nothing is recorded: no clock, no event, no profiler range.  The metrics
a call returns are the same bits either way.
"""

import contextlib
import dataclasses
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.serve.simulator import (SimConfig, simulate_service,
                                         synthetic_pool)

SIM = SimConfig(num_devices=24, T=200, B_n=0.06, H=6 * 441e6, seed=5)
MATERIALIZED = dict(engine="chunked", chunk=8)
STREAMED = dict(engine="chunked", chunk=8, materialize=False, slab=64)
# the sites a CPU call passes, a call: the uploads are the pool's tables
# (5), H, the gain tables (2) and the state tables (3); the stream's
# rollout run uploads its step tables (2), reads max(counts) once and,
# on the CPU, checks each slab's state indices at once
SITES = {"materialized": {"upload": 11, "on_copy": 1, "fold": 7},
         "streamed": {"upload": 13, "counts_max": 1, "check_ranges": 4,
                      "fold": 7}}
CALLS = {"materialized": MATERIALIZED, "streamed": STREAMED}


@pytest.fixture
def pool():
    p = synthetic_pool(S=128, seed=2)
    simulate_service(SIM, p, device="cpu", **STREAMED)  # the cached grids
    obs.reset()
    yield p
    obs.reset()


def _traced(pool, kw, seed=5):
    with profile(activities=[ProfilerActivity.CPU]):
        return simulate_service(dataclasses.replace(SIM, seed=seed), pool,
                                device="cpu", **kw)


def _children(recs, parent):
    return [r["name"] for r in recs if r["parent"] == parent["id"]]


def test_materialized_call_records_its_tree(pool):
    _traced(pool, MATERIALIZED)
    recs = obs.records()
    (svc,) = [r for r in recs if r["parent"] is None]
    assert svc["name"] == "service"
    assert _children(recs, svc) == ["lower", "engine", "fold", "release"]
    by = {r["name"]: r for r in recs}
    assert _children(recs, by["lower"]) == ["draws", "quantize", "on_copy"]
    assert _children(recs, by["engine"]) == ["rollout", "series"]
    assert {r["name"] for r in recs} == {
        "service", "lower", "draws", "quantize", "on_copy", "engine",
        "rollout", "series", "fold", "release"}


def test_streamed_call_records_a_slab_a_slab(pool):
    _traced(pool, STREAMED)
    recs = obs.records()
    by = {r["name"]: r for r in recs}
    assert _children(recs, by["service"]) == ["lower", "engine", "fold"]
    assert _children(recs, by["lower"]) == ["draws"]  # the boundary pass
    slabs = [r for r in recs if r["name"] == "slab"]
    assert len(slabs) == math.ceil(SIM.T / STREAMED["slab"])
    assert all(r["parent"] == by["engine"]["id"] for r in slabs)
    for s in slabs:
        assert _children(recs, s) == ["draws", "quantize", "rollout",
                                      "series"]


@pytest.mark.parametrize("path", ["materialized", "streamed"])
def test_spans_share_the_call_and_nest(pool, path):
    _traced(pool, CALLS[path], seed=5)
    _traced(pool, CALLS[path], seed=6)
    recs = obs.records()
    by_id = {r["id"]: r for r in recs}
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["service", "service"]
    for r in recs:
        if r["parent"] is None:
            assert r["call"] == r["id"]
            continue
        p = by_id[r["parent"]]
        assert r["call"] == p["call"]
        assert p["start"] <= r["start"] <= r["end"] <= p["end"]
        assert r["device_ms"] == pytest.approx(1e3 * (r["end"] - r["start"]))
    rep = obs.report()
    assert rep["calls"] == 2 and rep["spans"]["service"]["calls"] == 1
    assert rep["dropped"] == 0


@pytest.mark.parametrize("path", ["materialized", "streamed"])
def test_host_syncs_count_the_known_sites(pool, path):
    _traced(pool, CALLS[path])
    rep = obs.report()
    assert rep["host_syncs_by_site"] == pytest.approx(SITES[path])
    assert rep["host_syncs"] == sum(SITES[path].values())
    assert rep["host_sync_bytes"] > 0


@pytest.mark.parametrize("path", ["materialized", "streamed"])
def test_metrics_bit_identical_with_the_profiler_on(pool, path):
    off = simulate_service(SIM, pool, device="cpu", **CALLS[path])
    on = _traced(pool, CALLS[path], seed=SIM.seed)
    assert on == off
    assert obs.records()


def test_report_splits_device_ms_by_children(pool):
    _traced(pool, STREAMED)
    recs = obs.records()
    rep = obs.report()["spans"]
    slabs = [r for r in recs if r["name"] == "slab"]
    own = sum(s["device_ms"] - sum(r["device_ms"] for r in recs
                                   if r["parent"] == s["id"])
              for s in slabs)
    assert rep["slab"]["calls"] == 4 and rep["quantize"]["calls"] == 4
    assert rep["slab"]["self_device_ms"] == pytest.approx(own)
    assert rep["slab"]["device_ms"] == pytest.approx(
        sum(s["device_ms"] for s in slabs))
    for name in ("draws", "quantize", "rollout", "series", "fold"):
        assert rep[name]["self_device_ms"] == pytest.approx(
            rep[name]["device_ms"])


def test_nothing_recorded_with_the_profiler_off(pool, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("obs touched the clock, an event or a range")
    monkeypatch.setattr(obs, "_clock", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    for kw in CALLS.values():
        simulate_service(SIM, pool, device="cpu", **kw)
    assert obs.span("service") is obs.span("lower")
    assert isinstance(obs.span("service"), contextlib.nullcontext)
    obs.host_sync(8, "fold")
    assert obs.records() == [] and obs._syncs == []
    assert obs.report()["calls"] == 0


def test_spans_past_the_cap_are_dropped(pool, monkeypatch):
    monkeypatch.setattr(obs, "MAX_SPANS", 5)
    _traced(pool, MATERIALIZED)
    assert len(obs.records()) == 5
    assert obs.report()["dropped"] == 5  # of the call's ten spans
    obs.reset()
    assert obs.report()["dropped"] == 0 and not obs.records()
