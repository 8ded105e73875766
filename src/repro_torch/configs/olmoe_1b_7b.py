"""OLMoE-1B-7B [arXiv:2409.02060]: 64-expert top-8 MoE.

16L, d_model 2048, 16 heads (kv=16), expert d_ff 1024, vocab 50304.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    head_dim=128,
    norm_type="rmsnorm",
    num_experts=64,
    top_k=8,
)
