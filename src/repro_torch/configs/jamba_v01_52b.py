"""Jamba-v0.1 52B [arXiv:2403.19887]: hybrid Mamba+attention 1:7 interleave,
MoE (16 experts, top-2) on every second layer.

32L, d_model 4096, 32 heads (GQA kv=8), d_ff 14336, vocab 65536.
Pattern of 8: [m m m m a m m m]; attention at in-pattern index 4.  MoE on odd
layers.  Jamba v0.1 uses Mamba-1 layers with d_state 16; we implement the
mixer with the Mamba-2/SSD formulation (the chunked matmul form, K4 on the
card) at the same state size, as the reference does.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    head_dim=128,
    norm_type="rmsnorm",
    num_experts=16,
    top_k=2,
    moe_period=2,
    moe_offset=1,
    attn_period=8,
    attn_offset=4,
    ssm_state=16,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=1,
    optimizer="adafactor",
)
