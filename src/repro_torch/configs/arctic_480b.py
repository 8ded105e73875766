"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base]: dense+MoE.

35L, d_model 7168, 56 heads (GQA kv=8), vocab 32000; MoE with 128 experts
(top-2, expert d_ff 4864) in PARALLEL with a dense residual MLP on every
layer (Arctic's dense-MoE hybrid).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    head_dim=128,
    norm_type="rmsnorm",
    num_experts=128,
    top_k=2,
    moe_d_ff=4864,
    dense_residual=True,
    optimizer="adafactor",
)
