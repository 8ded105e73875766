"""DeepSeek 67B [arXiv:2401.02954]: llama-arch dense GQA.

95L, d_model 8192, 64 heads (GQA kv=8), d_ff 22016, vocab 102400.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    head_dim=128,
    norm_type="rmsnorm",
    optimizer="adafactor",
)
