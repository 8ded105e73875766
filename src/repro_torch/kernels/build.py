"""Build the port's CUDA sources with nvcc at first use; load with ctypes.

Each ``csrc/<name>.cu`` compiles into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), named by a
digest of the flags, that source and the shared ``csrc/*.cuh`` headers,
so a changed source never loads a stale library and an edit to one
source rebuilds only its own library.  Libraries go to
``build/repro_torch/`` at the repository root.  Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# -fmad=false: no a * b + c contraction, so the kernels round exactly as
# the eager plain versions do (see the note in csrc/onalgo_step.cu).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

_LIBS: dict = {}
PTXAS_LOG: dict = {}  # source name -> nvcc/ptxas output of this process's build


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("repro_torch: nvcc not found (needed to build the "
                       "CUDA kernels under src/repro_torch/kernels/csrc)")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: the digest covers the flags,
    that source and the shared headers, not the other sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names) -> dict:
    """Compile every ``csrc/<name>.cu`` in ``names`` that has no library of
    the same sources yet, one nvcc each, all started together; returns
    {name: library path}.  Raises with nvcc's output on any failure."""
    out = {name: library_path(name) for name in names}
    todo = [name for name, path in out.items() if not path.exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = out[name].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (cmd, tmp, proc) in procs.items():
        PTXAS_LOG[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) building {name}:"
                          f"\n{' '.join(cmd)}\n{PTXAS_LOG[name]}")
        else:
            os.replace(tmp, out[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same sources
    exists; returns its path."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build(name)))
    return lib
