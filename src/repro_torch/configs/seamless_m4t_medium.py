"""SeamlessM4T-medium [arXiv:2308.11596]: encoder-decoder, audio frontend.

12L enc + 12L dec, d_model 1024, 16 heads (kv=16), d_ff 4096, vocab 256206.
The speech frontend (conformer feature extractor) is a STUB per the
assignment: input_specs() provides precomputed frame embeddings
(batch, frames, d_model); the transformer backbone is fully implemented.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,  # decoder layers
    enc_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    head_dim=64,
    norm_type="layernorm",
    gated_mlp=False,
    act="relu",
    frontend_tokens=512,  # default source-frame count for specs
)
