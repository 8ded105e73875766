"""InternVL2-1B [arXiv:2404.16821]: InternViT frontend + InternLM2 backbone.

Backbone: 24L, d_model 896, 14 heads (GQA kv=2), d_ff 4864, vocab 151655.
The vision frontend (InternViT-300M + pixel-shuffle to 256 tokens/image) is
a STUB per the assignment: input_specs() provides precomputed patch
embeddings (batch, 256, d_model) consumed via ``prefix_embeds``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    head_dim=64,
    norm_type="rmsnorm",
    frontend_tokens=256,
)
