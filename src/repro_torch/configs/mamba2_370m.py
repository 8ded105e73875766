"""Mamba2-370M [arXiv:2405.21060]: attention-free SSD (state-space duality).

48L, d_model 1024, d_inner 2048 (expand 2), headdim 64 -> 32 SSM heads,
d_state 128, vocab 50280.  ``d_ff=0``: Mamba2 blocks have no separate FFN
sublayer — the mixer IS the layer; the dense FFN width is 0 and the block
skips it (``models/blocks.py``).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    norm_type="rmsnorm",
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=1,
    tie_embeddings=True,
)
