# Hand-written CUDA kernels (sm_90a), each beside its plain PyTorch version:
#   onalgo_step.py      — K1-K3 (+ K1-topo, K2-topo), the OnAlgo hot loop
#   flash_attention.py  — K5, GQA flash attention (the LM's full forward)
#   decode_attention.py — K6, flash-decode (the LM's decode steps)
#   ssd_chunk.py        — K4, the Mamba2 / SSD within-chunk dual form
#                         (the SSM layers' prefill and full forward)
#   csrc/               — the CUDA sources, built by build.py at first use
#   ops.py              — public entry points, dispatching on the tensors'
#                         device, and the registry of launch counts
# K1 and K2 come in their scalar-mu and multi-cloudlet (topology) forms.
