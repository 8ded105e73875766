"""Nothing the benchmark runs imports JAX, the JAX package or the JAX
package's benchmarks, compared by whole top-level names (``repro_torch``
begins with ``repro``); the references import nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    return [p for p in PB.rglob("*.py") if "tests" not in p.parts]


def test_no_forbidden_import_in_the_sources():
    for p in _sources():
        bad = set(_imports(p)) & FORBIDDEN
        assert not bad, f"{p}: {bad}"


def test_references_import_nothing_of_the_program():
    for p in (PB / "references").glob("*.py"):
        assert "repro_torch" not in set(_imports(p)), p
    assert "repro_torch" not in set(_imports(PB / "pool.py"))


def test_a_run_loads_no_forbidden_module():
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from pathlib import Path\n"
        "from portbench import harness\n"
        f"C = Path({str(PB / 'tests' / 'cell')!r})\n"
        "harness.run_cell(C / 'BENCHMARK.json', 'tiny.stream', 7, 0.5, "
        "True, 'cpu', t_start=time.perf_counter(), root=Path("
        f"{str(ROOT)!r}), traffic_dir=C / 'traffic', metric_dirs=["
        f"C / 'metrics', Path({str(PB / 'metrics')!r})])\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        f"set({sorted(FORBIDDEN)!r})))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_with_the_jax_package_loaded_is_refused(monkeypatch):
    import time
    import types

    import pytest

    from portbench import harness
    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    cell = PB / "tests" / "cell"
    with pytest.raises(SystemExit, match="repro"):
        harness.run_cell(cell / "BENCHMARK.json", "tiny.horizon", 7, 0.2,
                         False, "cpu", t_start=time.perf_counter(), root=ROOT,
                         traffic_dir=cell / "traffic",
                         metric_dirs=[PB / "metrics"])
