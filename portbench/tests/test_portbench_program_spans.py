"""The readers of the program's own spans and counter (``metrics/
on_copy_ms.py``, ``quantize_ms.py``, ``kernel_ms.py``, ``series_ms.py``,
``host_syncs.py``) through the harness's traced run, on the CPU: the tiny
cell's benchmark plus nine per-layer entries, each read in the cells
whose calls open its span.  A program without the recorder gives the
readers nothing, and they return None without raising."""

import json
import sys
import time
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
CELL = Path(__file__).resolve().parent / "cell"
HORIZON, STREAM = "tiny.horizon", "tiny.stream"
# name -> (layer, the cells that read it)
NEW = {
    "on_copy_ms.horizon": ("lowering", [HORIZON]),
    "quantize_ms.horizon": ("lowering", [HORIZON]),
    "kernel_ms.horizon": ("engine rollout and OnAlgo kernels", [HORIZON]),
    "series_ms.horizon": ("admission and accounting series", [HORIZON]),
    "host_syncs.horizon": ("whole call", [HORIZON]),
    "quantize_ms": ("streaming lowering", [STREAM]),
    "kernel_ms": ("engine rollout and OnAlgo kernels", [STREAM]),
    "series_ms": ("admission and accounting series", [STREAM]),
    "host_syncs": ("whole call", [STREAM]),
}
READERS = ("on_copy_ms", "quantize_ms", "kernel_ms", "series_ms",
           "host_syncs")


def _bench(tmp_path):
    bench = json.loads((CELL / "BENCHMARK.json").read_text())
    for name, (layer, cells) in NEW.items():
        bench["per_layer"].append({
            "name": name, "unit": "syncs" if "syncs" in name else "ms",
            "better": "lower",
            "source": ("program_counter" if "syncs" in name
                       else "program_span"),
            "layer": layer, "moves": "devslots_per_s", "workloads": cells})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


@pytest.mark.parametrize("workload", [HORIZON, STREAM])
def test_every_new_reader_reads_a_number(tmp_path, workload):
    from repro_torch import obs
    obs.reset()
    result, _ = harness.run_cell(
        _bench(tmp_path), workload, 2**31 + 17, 0.5, True, "cpu",
        t_start=time.perf_counter(), root=ROOT,
        traffic_dir=CELL / "traffic",
        metric_dirs=[CELL / "metrics", ROOT / "portbench" / "metrics"])
    obs.reset()
    assert result["correct"]
    names = [n for n, (_, cells) in NEW.items() if workload in cells]
    for name in names:
        value = result["metrics"][name]["value"]
        assert isinstance(value, float) and value > 0, name
    syncs = result["metrics"][names[-1]]["value"]
    assert syncs == int(syncs) >= 8  # the fold's seven reads and more


@pytest.mark.parametrize("reader", READERS)
def test_a_program_without_the_recorder_reads_nothing(monkeypatch, reader):
    import repro_torch
    from repro_torch import obs
    from repro_torch.serve.simulator import (SimConfig, simulate_service,
                                             synthetic_pool)
    from torch.profiler import ProfilerActivity, profile
    obs.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        simulate_service(SimConfig(num_devices=8, T=32), synthetic_pool(),
                         engine="chunked", chunk=8, device="cpu")
    mod = harness.load_reader(reader, [ROOT / "portbench" / "metrics"])
    assert mod.compute({}) is not None  # with the recorder
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    monkeypatch.delattr(repro_torch, "obs")
    assert mod.compute({}) is None
    obs.reset()


@pytest.mark.parametrize("reader", READERS)
def test_nothing_recorded_reads_nothing(reader):
    from repro_torch import obs
    obs.reset()
    mod = harness.load_reader(reader, [ROOT / "portbench" / "metrics"])
    assert mod.compute({}) is None
