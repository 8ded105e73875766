"""Fault-tolerant checkpointing in the reference's on-disk format.

Port of ``repro/train/checkpoint.py``:

  * every checkpoint is written to ``<dir>/step_<n>.tmp-*`` and renamed to
    ``<dir>/step_<n>`` (atomic): a preempted writer never corrupts the
    latest checkpoint, and ``latest_step`` skips torn writes;
  * ``arrays.npz`` holds one array per leaf under the reference's tree
    path (".params/blocks/sub0/mixer/wq", ".opt_state/m/...", ".step"), a
    layer stack's instances stacked on a leading axis as the reference
    holds them (``train.tree.ref_key``); bfloat16 is stored as its uint16
    bits, and ``MANIFEST.json`` records each leaf's key, shape and true
    dtype.  So either package restores the other's checkpoint;
  * ``CheckpointManager`` copies the state to the host on the caller's
    thread, writes it on a background thread, keeps the newest ``keep``
    checkpoints and finds the latest valid one.

bfloat16 crosses through ``Tensor.view`` (no ``ml_dtypes``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.train.tree import flat_state, map_state, ref_key

MANIFEST = "MANIFEST.json"


def _host(leaf: torch.Tensor):
    """(numpy array, dtype name) of a leaf as the reference stores it."""
    if not isinstance(leaf, torch.Tensor):
        raise TypeError(f"a checkpoint leaf must be a tensor, got "
                        f"{type(leaf).__name__}")
    # a copy: the optimizer writes the state's tensors in place
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _decode(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    arr = np.ascontiguousarray(arr).reshape(arr.shape)  # keeps a 0-d shape
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def host_leaves(tree) -> dict:
    """{reference key: (numpy array, dtype name)} of a state tree, the
    instances of a stacked leaf stacked in index order (copied to the
    host: a synchronization on the card)."""
    groups: dict = {}
    for parts, leaf in flat_state(tree):
        key, index = ref_key(parts)
        groups.setdefault(key, []).append((index, _host(leaf)))
    out = {}
    for key, items in groups.items():
        if len(items) == 1 and items[0][0] == ():
            out[key] = items[0][1]
            continue
        if any(len(i) != 1 for i, _ in items):
            raise ValueError(f"leaf {key!r}: expected one stacked axis")
        items.sort(key=lambda it: it[0])
        if [i[0] for i, _ in items] != list(range(len(items))):
            raise ValueError(f"leaf {key!r}: stacked indices are not 0..n-1")
        out[key] = (np.stack([a for _, (a, _) in items]), items[0][1][1])
    return out


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict] = None):
    """Atomic checkpoint write: <dir>/step_<n>.tmp-* -> <dir>/step_<n>."""
    return _write(ckpt_dir, step, host_leaves(tree), extra)


def _write(ckpt_dir: str, step: int, leaves: dict, extra: Optional[dict]):
    """``save`` of leaves already on the host (``host_leaves``)."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + f".tmp-{os.getpid()}-{int(time.time() * 1e6)}"
    os.makedirs(tmp, exist_ok=True)
    arrays = {}
    manifest = {"step": step, "leaves": [], "extra": extra or {},
                "format": 1}
    for key, (arr, dtype_name) in leaves.items():
        arrays[key] = arr
        manifest["leaves"].append({
            "key": key, "shape": list(arr.shape), "dtype": dtype_name})
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _valid(path: str) -> bool:
    return (os.path.isdir(path)
            and os.path.exists(os.path.join(path, MANIFEST))
            and os.path.exists(os.path.join(path, "arrays.npz")))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and ".tmp" not in name:
            if _valid(os.path.join(ckpt_dir, name)):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Any):
    """Restore into the structure of ``like`` (a state tree: dataclasses,
    dicts, lists, parameter modules; tensor leaves): a new tree whose
    tensors take the dtype, device and ``requires_grad`` of ``like``'s (a
    module is rebuilt; ``like`` is not changed)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not _valid(path):
        raise FileNotFoundError(path)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    with open(os.path.join(path, MANIFEST)) as f:
        man = json.load(f)
    dtypes = {le["key"]: le["dtype"] for le in man["leaves"]}

    def leaf(parts, like_leaf):
        key, index = ref_key(parts)
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = arrays[key][index] if index else arrays[key]
        t = _decode(arr, dtypes.get(key, str(arrays[key].dtype)))
        if tuple(t.shape) != tuple(like_leaf.shape):
            raise ValueError(f"leaf {key}{list(index)}: checkpoint shape "
                             f"{tuple(t.shape)}, expected "
                             f"{tuple(like_leaf.shape)}")
        return t.to(device=like_leaf.device,
                    dtype=like_leaf.dtype).requires_grad_(
            like_leaf.requires_grad)

    return map_state(like, leaf)


def manifest(ckpt_dir: str, step: int) -> dict:
    with open(os.path.join(ckpt_dir, f"step_{step:08d}", MANIFEST)) as f:
        return json.load(f)


@dataclasses.dataclass
class CheckpointManager:
    """Rotation + async writes + latest-valid discovery."""

    ckpt_dir: str
    keep: int = 3
    async_write: bool = True

    def __post_init__(self):
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        """Copy ``tree`` to the host now (the caller may change its tensors
        in place afterwards), write it on the background thread."""
        self.wait()  # never more than one outstanding write
        leaves = host_leaves(tree)

        def work():
            try:
                _write(self.ckpt_dir, step, leaves, extra)
                self._rotate()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        if self.async_write:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self.wait()

    def _rotate(self):
        steps = sorted(s for s in (
            int(n.split("_")[1]) for n in os.listdir(self.ckpt_dir)
            if n.startswith("step_") and ".tmp" not in n))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def latest(self) -> Optional[int]:
        self.wait()
        return latest_step(self.ckpt_dir)

    def restore(self, like, step: Optional[int] = None):
        step = step if step is not None else self.latest()
        if step is None:
            return None, None
        return restore(self.ckpt_dir, step, like), step
