"""The benchmark's multi-cloudlet cell on the CPU: its plain reference
(``portbench/references/onalgo_topology_service.py``) against the
program's topology route at a small size, and the cell's check against
the control and the planted faults.

The size stands in for ``metro-1m-k1024``: N = 512 devices, T = 128
slots, K = 16 cloudlets under a streamed walk at p_handover = 0.05, the
capacity tight enough (0.05 tasks a slot per device, the cell's) that
the duals end above 0.  The limits are the committed configuration's.
"""

import json
import time
from pathlib import Path

import pytest
import torch

from portbench import faults, harness
from portbench.clients.service_batch import gaps
from portbench.clients.topology_batch import TopologyBatch
from portbench.references import onalgo_service
from portbench.references import onalgo_topology_service as ref

ROOT = Path(__file__).resolve().parents[1]
CELL = ROOT / "portbench" / "tests" / "cell"
METRO = json.loads((ROOT / "portbench" / "configs" / "metro-1m-k1024.json")
                   .read_text())
WALK = {"kind": "mobility_walk", "K": 16, "p_handover": 0.05,
        "streaming": True}
CALLS = {
    "streamed": {"engine": "chunked", "chunk": 16, "block_n": 32,
                 "materialize": False, "slab": 64, "topo_binned": True},
    "materialized": {"engine": "chunked", "chunk": 16, "materialize": True},
}
SEED = 2**33 + 5


@pytest.fixture(autouse=True)
def one_thread():
    """Ops this small gain nothing from intra-op threads, and under the
    suite's workers those threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small(topology=WALK) -> dict:
    """The metro configuration at the tests' size."""
    tiny = json.loads((CELL / "configs" / "tiny.json").read_text())
    return dict(tiny, num_devices=512, T=128,
                H_tasks_per_device=METRO["H_tasks_per_device"],
                reference=METRO["reference"], topology=topology,
                limits=METRO["limits"])


def client(call, topology=WALK, check=2):
    traffic = {"client": "topology_batch", "call": call,
               "warmup_requests": 0, "check_requests": check}
    return TopologyBatch(small(topology), traffic, SEED, "cpu")


@pytest.mark.parametrize("route", sorted(CALLS))
def test_reference_equals_program(route):
    d = client(CALLS[route])
    answers = {i: d.request(i) for i in range(2)}
    numbers, checked = d.check(answers)
    assert checked == 2
    assert numbers["count_gap"][0] == 0.0
    assert numbers["value_gap"][0] <= METRO["limits"]["value_gap"]
    assert numbers["duals_idle"][0] == 0.0  # some mu_k ends above 0
    assert all(a["mu_final"] > 0 for a in answers.values())


@pytest.mark.parametrize("topology", [{"kind": "hotspot", "K": 4},
                                      {"kind": "uniform", "K": 1}],
                         ids=["hotspot4", "uniform1"])
def test_static_topologies_equal_program(topology):
    """A static skewed placement, and K = 1, where the reference is the
    scalar reference exactly."""
    d = client(CALLS["streamed"], topology, check=1)
    answers = {0: d.request(0)}
    numbers, _ = d.check(answers)
    assert numbers["count_gap"][0] == 0.0
    assert numbers["value_gap"][0] <= METRO["limits"]["value_gap"]
    if topology["K"] == 1:
        scalar = {k: v for k, v in d.sim.items() if k != "topology"}
        assert ref.service_reference(d.sim, d.pool, d.seeds[0],
                                     device="cpu") == \
            onalgo_service.service_reference(scalar, d.pool, d.seeds[0],
                                             device="cpu")


def test_reference_walk_equals_program_walk():
    """The reference's walk, slot by slot, is the program's, bit for
    bit (its own counter stream, started at n % K)."""
    from repro_torch.topology import Topology
    N, T, K = 40, 150, 6
    want = Topology.mobility_walk(K, N, T, 1.0, p_handover=0.1, seed=11,
                                  device="cpu").assoc
    a = ref.placement({"kind": "mobility_walk", "K": K}, N, "cpu")
    for b in range(3):
        v = ref.walk_uniforms(11, b, N, "cpu")
        for r in range(min(64, T - 64 * b)):
            a = torch.where(v[0, r] < 0.1, ref.levels(v[1, r], K), a)
            assert torch.equal(a.int(), want[64 * b + r])


def test_control_is_not_correct():
    """The reference in bfloat16 answering for the program parts from
    the float32 reference by more than the cell's limits."""
    d = client(CALLS["streamed"], check=1)
    want = ref.service_reference(d.sim, d.pool, SEED, device="cpu")
    got = ref.service_reference(d.sim, d.pool, SEED, device="cpu",
                                dtype=torch.bfloat16)
    g = gaps(got, want)
    assert (g["count_gap"] > METRO["limits"]["count_gap"]
            or g["value_gap"] > METRO["limits"]["value_gap"])


def _tiny_walk_cell(tmp_path):
    """A BENCHMARK.json of one cell: the small walk configuration under
    the streamed call."""
    (tmp_path / "small.json").write_text(json.dumps(small()))
    (tmp_path / "walk.json").write_text(json.dumps({
        "client": "topology_batch", "call": CALLS["streamed"],
        "warmup_requests": 1, "check_requests": 1,
        "profile_seconds": 0.3}))
    bench = json.loads((CELL / "BENCHMARK.json").read_text())
    bench["configs"] = [dict(bench["configs"][0], name="small",
                             file=str(tmp_path / "small.json"))]
    bench["workloads"] = [{"name": "small.walk", "config": "small",
                           "traffic": "walk", "chips": 1, "why": "-"}]
    bench["per_layer"] = [
        {"name": f"{m}.small", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "-", "moves": "devslots_per_s",
         "workloads": ["small.walk"]}
        for m in ("assoc_ms", "admit_ms", "kernel_ms", "series_ms")]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


@pytest.fixture(autouse=True)
def jax_loaded_elsewhere(monkeypatch):
    """The suite's workers load the JAX package for other tests, which a
    benchmark run refuses (``harness.refuse_forbidden_modules``; that
    refusal is held in ``portbench/tests``, in a process of its own)."""
    monkeypatch.setattr(harness, "refuse_forbidden_modules", lambda: None)


def _run(bench, trace, control=False):
    return harness.run_cell(
        bench, "small.walk", 2**31 + 41, 0.3, trace, "cpu",
        t_start=time.perf_counter(), root=ROOT,
        traffic_dir=bench.parent,
        metric_dirs=[ROOT / "portbench" / "metrics"], control=control)


@pytest.mark.parametrize("kind", ["sound", "control", *sorted(faults.FAULTS)])
def test_cell_check_reads_each_fault(tmp_path, kind):
    """Through the harness's own check: a sound run is correct, the
    control and every planted fault are not (``half_fleet`` cuts the
    fleet under a topology built for all of it, which the program
    refuses: every request fails)."""
    bench = _tiny_walk_cell(tmp_path)
    if kind in faults.FAULTS:
        with faults.planted(kind):
            try:
                result, lines = _run(bench, False)
            except ValueError:  # raised in the warm-up
                assert kind == "half_fleet"
                return
    else:
        result, lines = _run(bench, False, control=kind == "control")
    assert result["correct"] is (kind == "sound"), lines


def test_traced_run_reads_the_topology_spans(tmp_path):
    """A traced run reads the walk's slabs and the admission from the
    program's spans (device ms on the card, host ms here)."""
    result, lines = _run(_tiny_walk_cell(tmp_path), True)
    assert result["correct"] is True, lines
    for m in ("assoc_ms", "admit_ms", "kernel_ms", "series_ms"):
        assert result["metrics"][f"{m}.small"]["value"] > 0
