"""One run of one cell: set-up, warm-up, the measured window, the traced
reading, the check against the plain reference, and the result line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``'s
``workloads``; its configuration at the ``file`` its entry names; its
traffic mix at ``<traffic_dir>/<traffic>.json``, which names the client
(``portbench/clients/<client>.py``, a ``setup(config, traffic, seed,
device)``); and each metric's reader at ``<metric_dir>/<name>.py`` (or
that of its name less the last ``.<part>``), a ``compute(record)`` that
returns a number or None where it finds nothing to read.  A metric that
the cell lists and whose reader finds nothing ends the run, naming it;
only on the CPU (the tests' hook) is a metric of the device's trace left
out of the line.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from portbench import devtrace
from portbench.spans import Spans

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names


def refuse_forbidden_modules():
    """Exit, naming them, where JAX or the JAX package is loaded."""
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        raise SystemExit(f"portbench: {found} loaded in this process")


def load_cell(bench: dict, workload: str, root: Path, traffic_dir: Path):
    """(cell, configuration, traffic) of ``workload``."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r} in "
                         f"BENCHMARK.json (have {sorted(cells)})")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((traffic_dir / f"{cell['traffic']}.json")
                         .read_text())
    return cell, config, traffic


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metric entries the cell reports: its end-to-end metrics in an
    untraced run, its per-layer metrics in a traced one."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"]
                                 in moved else [])]


def load_reader(name: str, dirs):
    """The reader of metric ``name``: ``<name>.py`` in the first of
    ``dirs`` that has it; where none has, the reader of the name less its
    last ``.<part>`` (``rollout_ms.horizon`` is read as ``rollout_ms``,
    in the cells it lists)."""
    for d in dirs:
        path = Path(d) / f"{name}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                "portbench_metric_" + name.replace(".", "_").replace("-", "_"),
                path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    if "." in name:
        return load_reader(name.rsplit(".", 1)[0], dirs)
    raise SystemExit(f"portbench: no reader for metric {name!r} in "
                     f"{[str(d) for d in dirs]}")


def power_limit_w():
    """The card's power limit (W) from nvidia-smi, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _profile_requests(run_one, seconds, device):
    """Run requests for ``seconds`` under torch.profiler; returns the
    Profile (the profiler's record lands in a temporary file, read back
    and deleted)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=acts, acc_events=True) as prof:
            t_end = time.perf_counter() + seconds
            while time.perf_counter() < t_end:
                run_one()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            time.sleep(0.1)  # let the tracer deliver the last records
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return devtrace.from_chrome_trace(path)


def run_cell(bench_path: Path, workload: str, seed: int, seconds: float,
             trace: bool, device, *, t_start: float, root: Path,
             traffic_dir: Path, metric_dirs, control: bool = False):
    """Run the cell; returns (result dict, stderr lines).  ``device`` is
    the card ("cuda"); tests pass "cpu".  With ``control`` the client's
    control answers in the program's place (``calibrate.py`` and the
    tests: it has to come out not correct)."""
    marks = [("imports", time.perf_counter())]  # set-up's stages
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.init()
        marks.append(("cuda", time.perf_counter()))
    bench = json.loads(Path(bench_path).read_text())
    cell, config, traffic = load_cell(bench, workload, root, traffic_dir)
    if (device.type == "cuda"
            and torch.cuda.device_count() < int(cell["chips"])):
        raise SystemExit(f"portbench: {workload} needs {cell['chips']} "
                         f"cards, {torch.cuda.device_count()} visible")
    entries = cell_metrics(bench, workload, trace)
    readers = {m["name"]: load_reader(m["name"], metric_dirs)
               for m in entries}
    client = importlib.import_module(
        f"portbench.clients.{traffic['client']}").setup(
            config, traffic, seed, device)
    if control:
        client.use_control()
    marks.append(("inputs", time.perf_counter()))
    limit_w = power_limit_w() if device.type == "cuda" else None
    marks.append(("nvidia-smi", time.perf_counter()))
    client.warmup()
    marks.append(("warm-up", time.perf_counter()))
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    spans = Spans(device)
    requests, answers, errors = [], {}, []

    def run_one(log=requests):
        i = len(answers) + len(errors)
        t0 = time.perf_counter()
        try:
            with (spans.span("request") if trace
                  else contextlib.nullcontext()):
                answers[i] = client.request(i)
            ok = True
        except Exception as exc:  # a failed request counts as failed
            errors.append(f"request {i}: {type(exc).__name__}: {exc}")
            ok = False
        log.append((t0, time.perf_counter(), client.devslots, ok))

    profile, profiled = None, []
    with spans.around(client.spans if trace else ()):
        t_first = time.perf_counter()
        setup_s = t_first - t_start
        while time.perf_counter() < t_first + seconds:
            run_one()
        window_s = requests[-1][1] - t_first
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        # the profiled stretch follows the window; it is made again, twice
        # at most, where the tracer delivered no device operation
        for _ in range(3 if trace else 0):
            profile = _profile_requests(
                lambda: run_one(profiled),
                float(traffic.get("profile_seconds", 5)), device)
            if not cuda or (profile.device
                            and devtrace.spans_named(profile, "request")):
                break
    refuse_forbidden_modules()  # once the window has closed

    if cuda:
        torch.cuda.empty_cache()
    numbers, checked = client.check(answers)
    record = {"cell": cell, "config": config, "traffic": traffic,
              "requests": requests, "window_s": window_s,
              "setup_s": setup_s, "peak_bytes": peak,
              "spans": spans.seconds, "profile": profile,
              "cost": client.cost()}
    metrics = {}
    for m in entries:
        v = readers[m["name"]].compute(record)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    silent = [m["name"] for m in entries if m["name"] not in metrics
              and (cuda or m["source"] != "device_trace")]
    if silent:
        raise SystemExit(f"portbench: {workload} lists {silent}, and their "
                         "readers found nothing to read")
    correct = (not errors and checked > 0
               and all(math.isfinite(v) and v <= lim
                       for v, lim in numbers.values()))
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak),
           "power_limit_w": limit_w}
    result = {"correct": bool(correct), "attempted": len(requests),
              "failed": sum(1 for r in requests if not r[3]),
              "metrics": metrics, "device": dev}
    if profile is not None:
        dev["busy_s"] = devtrace.busy_s(profile)
        dev["window_s"] = profile.window_s
        result["breakdown"] = {"device_ops": devtrace.device_ops(profile),
                               "idle_gaps": devtrace.labelled_gaps(profile)}
    result["check"] = {name: {"value": v, "limit": lim}
                       for name, (v, lim) in numbers.items()}
    t = [t_start] + [m[1] for m in marks] + [t_first]
    lines = errors[:5] + ["set-up s: " + ", ".join(
        f"{name} {b - a:.3f}" for name, a, b in zip(
            [m[0] for m in marks] + ["to the window"], t, t[1:]))]
    lines.append(f"checked {checked} requests of {len(requests)}")
    if profile is not None:
        lines.append(f"profiled {len(profiled)} requests after the window, "
                     f"{profile.window_s:.3f} s")
    lines += [f"check {name} {v!r} limit {lim!r}"
              for name, (v, lim) in numbers.items()]
    refuse_forbidden_modules()  # and after the check
    return result, lines
