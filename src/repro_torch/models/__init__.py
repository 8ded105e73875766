# The cloudlet LM (port of repro.models) for the dense decoder and SSM families:
#   layers.py    — norms, RoPE, MLP, embeddings
#   attention.py — GQA attention (plain flash / decode; K5 / K6 with use_kernel)
#   ssm.py       — the Mamba2 / SSD mixer (chunked scan; K4 with use_kernel)
#   blocks.py    — pre-norm attention / mamba + dense FFN layers
#   lm.py        — the decoder-only LM (forward, prefill, decode, loss)
#   api.py       — ModelAPI, the serving engine's interface
# MoE blocks (so Jamba's hybrid stack) and encoder-decoder models are not
# ported yet (ROADMAP.md A12).
