# Hand-written CUDA kernels (sm_90a) for the OnAlgo hot loop:
#   onalgo_step.py — the wrappers, each beside its plain PyTorch version
#   csrc/          — the CUDA sources, built by build.py at first use
#   ops.py         — public entry points, dispatching on the tensors' device
# The model-zoo kernels (ssd_chunk, flash/decode attention) are not ported
# yet (ROADMAP.md queue B items 5-7).
