# The cloudlet LM zoo (port of repro.models):
#   layers.py    — norms, RoPE, MLP, embeddings
#   attention.py — GQA attention (plain flash / decode; K5 / K6 with use_kernel)
#   ssm.py       — the Mamba2 / SSD mixer (chunked scan; K4 with use_kernel)
#   moe.py       — the MoE FFN (GShard capacity dispatch, or dropless)
#   blocks.py    — pre-norm attention / mamba + dense / MoE FFN layers
#   lm.py        — the decoder-only LM (dense, MoE, SSM, hybrid, VLM prefix)
#   encdec.py    — the encoder-decoder backbone (audio frontend stub)
#   api.py       — ModelAPI, the serving engine's interface
