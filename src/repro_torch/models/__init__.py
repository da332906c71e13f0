"""Model zoo: the dense LM (training and serving) and the serving path of
the hybrid and SSM families.

  layers       - shared building blocks (norms, RoPE, attention, MLP)
  transformer  - decoder-only dense LM, chunked cross-entropy loss
  mamba2       - attention-free SSD (state-space duality)
  hybrid       - Zamba2-style Mamba2 stack + shared attention block
  api          - family dispatch: build / loss / prefill / decode
"""
