"""A run with the timed path broken underneath comes out not correct,
judged against each committed cell's own limits: once for each fault of
``portbench.faults`` (a step that leaves its state unchanged, half of the
fleet left out with the means taken over the rest, an answer altered
where it is produced), and for the control, the plain reference in the
precision below the configuration's answering in the program's place.
``calibrate.py`` reads the same at the cells' own sizes on the card."""

import json
import time
from pathlib import Path

import pytest
import torch

from portbench import calibrate, faults, harness

ROOT = Path(__file__).resolve().parents[2]
CELL = Path(__file__).resolve().parent / "cell"
CELLS = ["fig5-100k", "fleet-1m"]


def tiny_cell(tmp_path, config):
    """The tiny cell's BENCHMARK.json, its configuration holding the
    limits of the committed configuration ``config``."""
    limits = json.loads((ROOT / "portbench" / "configs" / f"{config}.json")
                        .read_text())["limits"]
    tiny = json.loads((CELL / "configs" / "tiny.json").read_text())
    (tmp_path / "tiny.json").write_text(json.dumps(dict(tiny,
                                                        limits=limits)))
    bench = json.loads((CELL / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        c["file"] = str(tmp_path / "tiny.json")
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


def run_tiny(bench, workload, seed, *, control=False):
    return harness.run_cell(
        bench, workload, seed, 0.5, False, "cpu",
        t_start=time.perf_counter(), root=ROOT,
        traffic_dir=CELL / "traffic",
        metric_dirs=[CELL / "metrics", ROOT / "portbench" / "metrics"],
        control=control)


@pytest.mark.parametrize("config", CELLS)
@pytest.mark.parametrize("workload", ["tiny.horizon", "tiny.stream"])
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_not_correct(tmp_path, fault, workload, config):
    bench = tiny_cell(tmp_path, config)
    with faults.planted(fault):
        result, lines = run_tiny(bench, workload, 2**31 + 23)
    assert result["correct"] is False, lines
    assert torch.get_default_dtype() == torch.float32


@pytest.mark.parametrize("config", CELLS)
def test_sound_run_is_correct_at_the_cells_limits(tmp_path, config):
    result, lines = run_tiny(tiny_cell(tmp_path, config), "tiny.horizon",
                             2**31 + 29)
    assert result["correct"] is True, lines


def test_planted_fault_is_taken_out_again():
    from repro_torch.serve import compile as sc
    fn = sc.service_metrics
    with faults.planted("answer_altered"):
        assert sc.service_metrics is not fn
    assert sc.service_metrics is fn


def test_calibrate_reads_the_control_and_a_fault(tmp_path, capsys):
    bench = tiny_cell(tmp_path, "fig5-100k")
    assert calibrate.main([
        "--workload", "tiny.horizon", "--seeds", str(2**31 + 31),
        "--kinds", "sound,control,half_fleet", "--seconds", "0.3",
        "--device", "cpu", "--bench", str(bench),
        "--traffic-dir", str(CELL / "traffic")]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(x["kind"], x["correct"]) for x in lines] == [
        ("sound", True), ("control", False), ("half_fleet", False)]
    assert lines[1]["count_gap"] > lines[1]["limits"]["count_gap"]
