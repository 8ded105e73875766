"""Model configuration dataclass (port of ``repro/configs/base.py``).

One ``ModelConfig`` describes any architecture of the reference's pool:
dense / MoE / SSM / hybrid (Jamba) / encoder-decoder (audio) / VLM.
``reduced()`` derives the CPU smoke-test variant of the same family.
``dtype`` is a ``torch.dtype``.  Every field of the reference is kept
but ``scan_layers`` and ``use_bias``, which neither package's model code
reads.  ``remat`` wraps each pattern instance of a training forward
(``models.blocks.remat_wrap``); ``optimizer`` names the trainer's
update rule (``train.optimizer``).  ``ShapeConfig`` / ``SHAPES`` are the
dry run's input-shape cells (``launch.dryrun``).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # norms / mlp
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm | nonparam_ln
    gated_mlp: bool = True
    act: str = "silu"
    rope_theta: float = 10000.0
    tie_embeddings: bool = False

    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_period: int = 1  # layer i uses MoE iff i % moe_period == moe_offset
    moe_offset: int = 0
    moe_d_ff: int = 0  # expert hidden size (0 -> d_ff)
    dense_residual: bool = False  # Arctic: dense MLP in parallel with MoE
    # capacity: GShard dispatch einsums (the reference's default)
    # dropless: every routed token reaches its experts, whatever the batch
    #           (prefill / decode outputs independent of batch composition)
    moe_impl: str = "capacity"

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    ssm_conv_kernel: int = 4

    # hybrid (Jamba): layer i is attention iff i % attn_period == attn_offset
    attn_period: int = 0  # 0 -> all layers attention (or all SSM if family=ssm)
    attn_offset: int = 0

    # encoder-decoder
    enc_layers: int = 0

    # modality frontend stub (audio frames / vision patches)
    frontend_tokens: int = 0

    # numerics / training
    dtype_name: str = "bfloat16"
    remat: str = "full"  # none | full | dots

    # optimizer choice for training (adamw | adafactor); the big models
    # take adafactor, whose factored second moment needs far less memory.
    optimizer: str = "adamw"

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype_name)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // max(self.num_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def block_kind(self, i: int) -> str:
        """Sequence-mixer type of layer i: 'attn' or 'ssm'."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid":
            return ("attn" if i % self.attn_period == self.attn_offset
                    else "ssm")
        return "attn"

    def ffn_kind(self, i: int) -> str:
        """'moe' or 'dense' for layer i."""
        if self.num_experts and i % self.moe_period == self.moe_offset:
            return "moe"
        return "dense"

    @property
    def pattern_period(self) -> int:
        """Smallest repeating layer pattern."""
        p = 1
        if self.family == "hybrid":
            p = self.attn_period
        if self.num_experts:
            p = max(p, self.moe_period)
        return p

    def reduced(self) -> "ModelConfig":
        """Small same-family variant for CPU smoke tests."""
        period = self.pattern_period
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=max(period * 2, 2),
            d_model=128,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            d_ff=256,
            moe_d_ff=128 if self.moe_d_ff else 0,
            vocab_size=512,
            head_dim=32,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=32 if self.ssm_state else 64,
            enc_layers=2 if self.enc_layers else 0,
            frontend_tokens=8 if self.frontend_tokens else 0,
            dtype_name="float32",
            remat="none",
        )

    def param_count(self) -> int:
        """Analytic parameter count."""
        D, Dh = self.d_model, self.resolved_head_dim
        V = self.vocab_size
        n = V * D  # embedding
        if not self.tie_embeddings:
            n += D * V

        def attn_params():
            return D * Dh * (self.num_heads * 2 + self.num_kv_heads * 2)

        def mlp_params(dff):
            return D * dff * (3 if self.gated_mlp else 2)

        def ssm_params():
            di, ds, g = self.d_inner, self.ssm_state, self.ssm_ngroups
            nh = self.ssm_heads
            in_proj = D * (2 * di + 2 * g * ds + nh)
            out_proj = di * D
            conv = (di + 2 * g * ds) * self.ssm_conv_kernel
            return in_proj + out_proj + conv + 2 * nh + di

        for i in range(self.num_layers):
            n += attn_params() if self.block_kind(i) == "attn" else ssm_params()
            if self.ffn_kind(i) == "moe":
                dff = self.moe_d_ff or self.d_ff
                n += self.num_experts * mlp_params(dff) + D * self.num_experts
                if self.dense_residual:
                    n += mlp_params(self.d_ff)
            else:
                n += mlp_params(self.d_ff)
        if self.enc_layers:
            n += self.enc_layers * (attn_params() + mlp_params(self.d_ff))
            n += self.num_layers * attn_params()  # cross attention
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only top_k experts)."""
        if not self.num_experts:
            return self.param_count()
        full = self.param_count()
        dff = self.moe_d_ff or self.d_ff
        per_expert = self.d_model * dff * (3 if self.gated_mlp else 2)
        n_moe_layers = sum(1 for i in range(self.num_layers)
                           if self.ffn_kind(i) == "moe")
        inactive = n_moe_layers * (self.num_experts - self.top_k) * per_expert
        return full - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: what the dry run traces."""

    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode
    sub_quadratic_only: bool = False  # long_500k: skip pure-attention archs


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode",
                             sub_quadratic_only=True),
}
