# Hand-written CUDA kernels (sm_90a), each beside its plain PyTorch version:
#   onalgo_step.py      — K1-K3, the OnAlgo hot loop
#   flash_attention.py  — K5, GQA flash attention (the LM's full forward)
#   decode_attention.py — K6, flash-decode (the LM's decode steps)
#   csrc/               — the CUDA sources, built by build.py at first use
#   ops.py              — public entry points, dispatching on the tensors'
#                         device, and the registry of launch counts
# ssd_chunk (K4) and the topology reducers of K1/K2 are not ported yet
# (ROADMAP.md queue B items 5 and 4).
