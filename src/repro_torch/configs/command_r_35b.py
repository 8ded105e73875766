"""Command-R 35B [hf:CohereForAI/c4ai-command-r-v01]: dense GQA, no biases.

40L, d_model 8192, 64 heads (GQA kv=8), d_ff 22528, vocab 256000.
Cohere uses LayerNorm (no bias) and a large vocab; logits are computed with
the chunked vocab-sharded cross entropy.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    head_dim=128,
    norm_type="layernorm",
    rope_theta=8e6,
    tie_embeddings=True,
    optimizer="adafactor",
)
