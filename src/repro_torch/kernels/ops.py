"""Public entry points of the kernels (port of ``repro/kernels/ops.py``).

Dispatch is by the tensors' device and nothing else: CPU tensors run the
plain PyTorch version, CUDA tensors launch the hand-written kernel (which
raises if it cannot build or launch).  There is no fallback between the
two and no environment switch.

No hand-written kernel has a backward (nor has any Pallas kernel of the
reference).  A kernel's outputs are fresh tensors written through
``data_ptr()``, outside autograd, so a kernel route inside a graph that
needs a gradient would silently cut the gradient of everything upstream.
The kernel route therefore raises RuntimeError when grad mode is on and
an input requires grad; it never falls back to the plain version.
Training takes the plain routes (``use_kernel=False``), as the
reference's loss does.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import draws as dr
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lower_values as lv
from repro_torch.kernels import onalgo_step as k
from repro_torch.kernels import ssd_chunk as sc


def _on_cuda(x, what: str, inputs=()) -> bool:
    """Whether tensor (or device) ``x`` takes the kernel route; raises on
    the kernel route when grad mode is on and one of ``inputs`` requires
    grad (the kernel has no backward)."""
    dev = x if isinstance(x, torch.device) else x.device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{what}: no kernel route for device {dev}")
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{what}: an input requires grad, and the CUDA kernel has no "
            "backward (its outputs would carry no gradient); take the plain "
            "route (use_kernel=False) under autograd, or call it under "
            "torch.no_grad()")
    return True


def onalgo_duals(lam, mu, rho, o_tab, h_tab, w_tab, B):
    """Single-slot fused policy + dual subgradients -> (g_pow (N,), load ())
    (see ``onalgo_step.onalgo_duals_plain``)."""
    if _on_cuda(rho, "onalgo_duals", (lam, mu, rho, o_tab, h_tab, w_tab, B)):
        return k.onalgo_duals_cuda(lam, mu, rho, o_tab, h_tab, w_tab, B)
    return k.onalgo_duals_plain(lam, mu, rho, o_tab, h_tab, w_tab, B)


def check_topo_binned(topo_binned):
    """``topo_binned`` names the reference's TPU reduction layout (None
    auto, True binned (hi, lo), False one-hot).  On the card one kernel
    serves both layouts, so the value is checked and changes nothing."""
    if topo_binned is not None and not isinstance(topo_binned, bool):
        raise TypeError("topo_binned must be None, True or False, got "
                        f"{topo_binned!r}")


def _rollout_contract(T, chunk, assoc, H_k, topo_binned):
    if T % chunk != 0:
        raise ValueError(f"T={T} must be a multiple of chunk={chunk}")
    if (assoc is None) != (H_k is None):
        raise ValueError("assoc and H_k must be passed together")
    check_topo_binned(topo_binned)
    return {} if assoc is None else dict(assoc=assoc, H_k=H_k)


def onalgo_chunked(j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab, B, H,
                   a, beta, *, chunk=8, t0=0, slot_values=None,
                   assoc=None, H_k=None, topo_binned=None, run=None):
    """Fused multi-slot OnAlgo rollout (K1; see
    ``onalgo_step.onalgo_chunked_plain`` for the contract).  ``chunk``
    keeps the reference's contract (T a multiple of it); the CUDA kernel
    runs the whole horizon in one launch whatever its value.  On CUDA,
    ``lam0`` / ``counts0`` are updated in place.  ``assoc`` ((N,) or
    (T, N) int32) with ``H_k`` (K,) runs the topology form (K1-topo; mu0
    and the mu outputs (K,) / (T, K)); ``topo_binned`` see
    ``check_topo_binned``; ``run`` a walk's ``onalgo_step.RolloutRun``
    (the per-call checks made once per run)."""
    topo = _rollout_contract(j_seq.shape[0], chunk, assoc, H_k, topo_binned)
    args = (j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab, B, H, a, beta)
    if _on_cuda(j_seq, "onalgo_chunked", args):
        kern = k.onalgo_chunked_topo_cuda if topo else k.onalgo_chunked_cuda
        return kern(*args, t0=t0, slot_values=slot_values, run=run, **topo)
    return k.onalgo_chunked_plain(*args, t0=t0, slot_values=slot_values,
                                  run=run, **topo)


def onalgo_tiled(j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab, B, H,
                 a, beta, *, chunk=8, block_n=256, t0=0, slot_values=None,
                 assoc=None, H_k=None, topo_binned=None, run=None):
    """Device-tiled fused rollout (K2, and K2-topo with ``assoc`` /
    ``H_k``): same results as ``onalgo_chunked`` for fleets of any size.
    Tiling does not change the math, so on CPU this is the same plain
    version."""
    topo = _rollout_contract(j_seq.shape[0], chunk, assoc, H_k, topo_binned)
    args = (j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab, B, H, a, beta)
    if _on_cuda(j_seq, "onalgo_tiled", args):
        kern = k.onalgo_tiled_topo_cuda if topo else k.onalgo_tiled_cuda
        return kern(*args, block_n=block_n, t0=t0, slot_values=slot_values,
                    run=run, **topo)
    return k.onalgo_chunked_plain(*args, t0=t0, slot_values=slot_values,
                                  run=run, **topo)


def onalgo_chunked_cells(j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab, B,
                         H, a, beta, *, chunk=8, t0=0):
    """K1 with a cell axis: G cells of a sweep grid over one trace in one
    call (see ``onalgo_step.onalgo_cells_plain`` for the contract); on
    CUDA the whole grid is one launch of the resident kernel with a cell
    axis, or the visible groups of ``onalgo_step.cells_plan``, and
    ``lam0`` / ``counts0`` are updated in place."""
    _rollout_contract(j_seq.shape[0], chunk, None, None, None)
    args = (j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab, B, H, a, beta)
    if _on_cuda(j_seq, "onalgo_chunked_cells", args):
        return k.onalgo_chunked_cells_cuda(*args, t0=t0)
    return k.onalgo_cells_plain(*args, t0=t0)


def onalgo_tiled_cells(j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab, B,
                       H, a, beta, *, chunk=8, block_n=256, t0=0):
    """K2 with a cell axis (``block_n`` devices a tile): the same results as
    ``onalgo_chunked_cells`` for fleets of any size; on CUDA one launch a
    slot for the whole grid."""
    _rollout_contract(j_seq.shape[0], chunk, None, None, None)
    args = (j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab, B, H, a, beta)
    if _on_cuda(j_seq, "onalgo_tiled_cells", args):
        return k.onalgo_tiled_cells_cuda(*args, block_n=block_n, t0=t0)
    return k.onalgo_cells_plain(*args, t0=t0)


def draws(proc, b0, nb, entry=None, *, device, **kw):
    """The workload draws of ``proc`` (a ``draws.ServiceProcess`` or
    ``WalkProcess``) over blocks [b0, b0 + nb), resumed from ``entry``
    (see ``draws.draws_plain`` for the forms and keywords).  Dispatch by
    the device of the entry tensors, or of ``device`` for a fresh start,
    which carries none; the two must agree."""
    dev = torch.device(device)
    if entry is not None and any(x.device.type != dev.type for x in entry):
        raise ValueError(f"draws: entry tensors are not on {dev}")
    if _on_cuda(dev if entry is None else entry[0].device, "draws",
                entry or ()):
        return dr.draws_cuda(proc, b0, nb, entry, device=dev, **kw)
    return dr.draws_plain(proc, b0, nb, entry, device=dev, **kw)


def lower_values(on, img, rates, tables):
    """The value lowering of a realized workload through ``tables`` (a
    ``lower_values.ValueTables`` on the tensors' device): (j int32,
    o, h, w, correct_local, correct_cloud, d_local float32), each of
    ``img``'s shape (see ``lower_values.lower_values_plain``)."""
    if _on_cuda(img, "lower_values"):
        return lv.lower_values_cuda(on, img, rates, tables)
    return lv.lower_values_plain(on, img, rates, tables)


def flash_attention(q, k, v, *, causal=True, block_q=128, block_k=128):
    """GQA attention, causal or full (K5; see
    ``flash_attention.flash_attention_plain``).  q: (B, Sq, Hq, D);
    k, v: (B, Skv, Hkv, D).  Returns (B, Sq, Hq, D) in q's dtype."""
    kw = dict(causal=causal, block_q=block_q, block_k=block_k)
    if _on_cuda(q, "flash_attention", (q, k, v)):
        return fa.flash_attention_cuda(q, k, v, **kw)
    return fa.flash_attention_plain(q, k, v, **kw)


def decode_attention(q, k_cache, v_cache, cache_len, *, block_k=128):
    """One query token against a KV cache masked by the scalar
    ``cache_len`` (K6; see ``decode_attention.decode_attention_plain``).
    q: (B, 1, Hq, D); caches (B, S, Hkv, D).  Returns (B, 1, Hq, D)."""
    if _on_cuda(q, "decode_attention", (q, k_cache, v_cache)):
        return da.decode_attention_cuda(q, k_cache, v_cache, cache_len,
                                        block_k=block_k)
    return da.decode_attention_plain(q, k_cache, v_cache, cache_len,
                                     block_k=block_k)


def ssd_chunk(x, dt, A, B, C):
    """The SSD within-chunk dual form and terminal chunk states (K4; see
    ``ssd_chunk.ssd_chunk_plain``).  x: (b, nc, Q, h, p); dt: (b, nc, Q,
    h); A: (h,); B, C: (b, nc, Q, h, n) head-expanded or (b, nc, Q, g, n)
    per group.  Returns (y_diag (b, nc, Q, h, p), states (b, nc, h, p,
    n))."""
    if _on_cuda(x, "ssd_chunk", (x, dt, A, B, C)):
        return sc.ssd_chunk_cuda(x, dt, A, B, C)
    return sc.ssd_chunk_plain(x, dt, A, B, C)


# name -> CUDA wrapper of every kernel of the port, for the launch counts
KERNELS = {**k.KERNELS, **dr.KERNELS, **lv.KERNELS,
           "flash_attention": fa.flash_attention_cuda,
           "decode_attention": da.decode_attention_cuda,
           "ssd_chunk": sc.ssd_chunk_cuda}


def reset_launch_counts():
    """Set every kernel wrapper's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {name: fn.launches for name, fn in KERNELS.items()}
