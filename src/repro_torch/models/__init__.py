"""Model zoo: the serving path of the hybrid and SSM families.

  layers       - shared building blocks (norms, RoPE, attention, MLP)
  mamba2       - attention-free SSD (state-space duality)
  hybrid       - Zamba2-style Mamba2 stack + shared attention block
  transformer  - ``unembed_matrix`` (the dense LM is still to port)
  api          - family dispatch: build / prefill / decode
"""
