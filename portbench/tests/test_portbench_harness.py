"""The harness's own CPU rehearsal: a tiny cell defined by files under
``tests/cell`` (a configuration, two traffic mixes and a per-layer metric
added by a file of its own) goes from its files to the result line, on
the CPU through the test hook (``run_cell(..., device="cpu")``); the
real command refuses a machine with no card.  ``fold_ms.tiny`` is a
metric added with no file: ``fold_ms.py`` reads it."""

import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
CELL = Path(__file__).resolve().parent / "cell"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _run(workload, trace):
    return harness.run_cell(
        CELL / "BENCHMARK.json", workload, 2**31 + 11, 1.0, trace, "cpu",
        t_start=time.perf_counter(), root=ROOT,
        traffic_dir=CELL / "traffic",
        metric_dirs=[CELL / "metrics", ROOT / "portbench" / "metrics"])


@pytest.mark.parametrize("workload", ["tiny.horizon", "tiny.stream"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(workload, trace):
    result, lines = _run(workload, trace)
    line = json.loads(json.dumps(result))
    assert list(line)[-1] == "check"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    for name, m in line["metrics"].items():
        assert NAME.match(name) and UNIT.match(m["unit"])
        assert isinstance(m["value"], float)
    bench = json.loads((CELL / "BENCHMARK.json").read_text())
    if trace:
        assert "requests_done" in line["metrics"]  # the added reader
        assert "fold_ms.tiny" in line["metrics"]  # read by fold_ms.py
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        # no device memory to read on the CPU
        assert set(line["metrics"]) == {m["name"] for m in bench[
            "end_to_end"]} - {"peak_gib"}
    for name, c in line["check"].items():
        assert NAME.match(name) and set(c) == {"value", "limit"}
    assert lines[-len(line["check"]):] == [
        f"check {n} {c['value']!r} limit {c['limit']!r}"
        for n, c in line["check"].items()]


def test_command_refuses_a_machine_with_no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "fig5-100k.horizon", "--seed", "3", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_command_refuses_a_checkout_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "fig5-100k.horizon", "--seed", "3", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.requires_cuda
def test_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "fig5-100k.horizon", "--seed", str(2**31 + 5), "--seconds", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"


def test_a_listed_metric_that_reads_nothing_ends_the_run(tmp_path):
    bench = json.loads((CELL / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "nothing_here", "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "whole call",
        "moves": "devslots_per_s", "workloads": ["tiny.horizon"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "nothing_here.py").write_text(
        "def compute(record):\n    return None\n")
    with pytest.raises(SystemExit, match="nothing_here"):
        harness.run_cell(
            tmp_path / "BENCHMARK.json", "tiny.horizon", 2**31 + 13, 0.3,
            True, "cpu", t_start=time.perf_counter(), root=ROOT,
            traffic_dir=CELL / "traffic",
            metric_dirs=[tmp_path, CELL / "metrics",
                         ROOT / "portbench" / "metrics"])


def test_an_entry_point_never_called_ends_the_run():
    from repro_torch.serve import compile as sc

    from portbench.spans import Spans
    fn = sc.compile_service_streaming
    with pytest.raises(SystemExit, match="compile_service_streaming"):
        with Spans("cpu").around([("lower_stream", "repro_torch.serve."
                                   "compile", "compile_service_streaming")]):
            pass
    assert sc.compile_service_streaming is fn
