"""OLMo 1B [arXiv:2402.00838]: dense, non-parametric LayerNorm.

16L, d_model 2048, 16 heads (kv=16, i.e. MHA), d_ff 8192, vocab 50304.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    head_dim=128,
    norm_type="nonparam_ln",
    tie_embeddings=True,
)
