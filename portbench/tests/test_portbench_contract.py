"""BENCHMARK.json holds to the benchmark's contract, and every name in it
finds its file: configurations, traffic mixes, clients, references and
metric readers."""

import importlib
import json
import re
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert all(LINE.match(w) for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_name_finds_its_file():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/") and LINE.match(c["source"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        importlib.import_module(f"portbench.references.{cfg['reference']}")
        # every number of the source is the file's, but where a cut is
        # listed; a cut only ever makes the deployment smaller
        src = cfg["source_values"]
        assert set(c["reduced"]) <= set(src) and len(c["reduced"]) <= 16
        for k, v in src.items():
            if k in c["reduced"]:
                assert NAME.match(k) and cfg[k] < v, k
            else:
                assert cfg[k] == v, k
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert LINE.match(w["why"])
        t = json.loads((ROOT / "portbench" / "traffic"
                        / f"{w['traffic']}.json").read_text())
        importlib.import_module(f"portbench.clients.{t['client']}")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        reader = harness.load_reader(m["name"],
                                     [ROOT / "portbench" / "metrics"])
        assert callable(reader.compute)


def test_metrics_of_the_cells():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and LINE.match(m["layer"])
        assert set(m["workloads"]) <= cells
    for c in cells:
        assert any(c in m["workloads"] for m in BENCH["per_layer"])


def test_run_seconds_fit_a_full_check():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
