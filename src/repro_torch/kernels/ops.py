"""Public entry points of the kernels (port of ``repro/kernels/ops.py``).

Dispatch is by the tensors' device and nothing else: CPU tensors run the
plain PyTorch version, CUDA tensors launch the hand-written kernel (which
raises if it cannot build or launch).  There is no fallback between the
two and no environment switch.
"""

from __future__ import annotations

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import onalgo_step as k

_TOPOLOGY = ("multi-cloudlet duals (assoc / H_k) in the rollout kernels are "
             "not ported yet: ROADMAP.md, queue B item 4 (topology reducers) "
             "and queue A item 6 (topology tier)")


def _on_cuda(x, what: str) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel route for device {x.device}")


def onalgo_duals(lam, mu, rho, o_tab, h_tab, w_tab, B):
    """Single-slot fused policy + dual subgradients -> (g_pow (N,), load ())
    (see ``onalgo_step.onalgo_duals_plain``)."""
    if _on_cuda(rho, "onalgo_duals"):
        return k.onalgo_duals_cuda(lam, mu, rho, o_tab, h_tab, w_tab, B)
    return k.onalgo_duals_plain(lam, mu, rho, o_tab, h_tab, w_tab, B)


def _rollout_contract(T, chunk, assoc, H_k, topo_binned):
    if T % chunk != 0:
        raise ValueError(f"T={T} must be a multiple of chunk={chunk}")
    if assoc is not None or H_k is not None or topo_binned is not None:
        raise NotImplementedError(_TOPOLOGY)


def onalgo_chunked(j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab, B, H,
                   a, beta, *, chunk=8, t0=0, slot_values=None,
                   assoc=None, H_k=None, topo_binned=None):
    """Fused multi-slot OnAlgo rollout (K1; see
    ``onalgo_step.onalgo_chunked_plain`` for the contract).  ``chunk``
    keeps the reference's contract (T a multiple of it); the CUDA kernel
    runs the whole horizon in one launch whatever its value.  On CUDA,
    ``lam0`` / ``counts0`` are updated in place.  ``assoc`` / ``H_k`` /
    ``topo_binned`` (topology) raise NotImplementedError."""
    _rollout_contract(j_seq.shape[0], chunk, assoc, H_k, topo_binned)
    args = (j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab, B, H, a, beta)
    if _on_cuda(j_seq, "onalgo_chunked"):
        return k.onalgo_chunked_cuda(*args, t0=t0, slot_values=slot_values)
    return k.onalgo_chunked_plain(*args, t0=t0, slot_values=slot_values)


def onalgo_tiled(j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab, B, H,
                 a, beta, *, chunk=8, block_n=256, t0=0, slot_values=None,
                 assoc=None, H_k=None, topo_binned=None):
    """Device-tiled fused rollout (K2): same results as ``onalgo_chunked``
    for fleets of any size.  Tiling does not change the math, so on CPU
    this is the same plain version."""
    _rollout_contract(j_seq.shape[0], chunk, assoc, H_k, topo_binned)
    args = (j_seq, lam0, mu0, counts0, o_tab, h_tab, w_tab, B, H, a, beta)
    if _on_cuda(j_seq, "onalgo_tiled"):
        return k.onalgo_tiled_cuda(*args, block_n=block_n, t0=t0,
                                   slot_values=slot_values)
    return k.onalgo_chunked_plain(*args, t0=t0, slot_values=slot_values)


def flash_attention(q, k, v, *, causal=True, block_q=128, block_k=128):
    """GQA attention, causal or full (K5; see
    ``flash_attention.flash_attention_plain``).  q: (B, Sq, Hq, D);
    k, v: (B, Skv, Hkv, D).  Returns (B, Sq, Hq, D) in q's dtype."""
    kw = dict(causal=causal, block_q=block_q, block_k=block_k)
    if _on_cuda(q, "flash_attention"):
        return fa.flash_attention_cuda(q, k, v, **kw)
    return fa.flash_attention_plain(q, k, v, **kw)


def decode_attention(q, k_cache, v_cache, cache_len, *, block_k=128):
    """One query token against a KV cache masked by the scalar
    ``cache_len`` (K6; see ``decode_attention.decode_attention_plain``).
    q: (B, 1, Hq, D); caches (B, S, Hkv, D).  Returns (B, 1, Hq, D)."""
    if _on_cuda(q, "decode_attention"):
        return da.decode_attention_cuda(q, k_cache, v_cache, cache_len,
                                        block_k=block_k)
    return da.decode_attention_plain(q, k_cache, v_cache, cache_len,
                                     block_k=block_k)


# name -> CUDA wrapper of every kernel of the port, for the launch counts
KERNELS = {**k.KERNELS,
           "flash_attention": fa.flash_attention_cuda,
           "decode_attention": da.decode_attention_cuda}


def reset_launch_counts():
    """Set every kernel wrapper's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {name: fn.launches for name, fn in KERNELS.items()}
