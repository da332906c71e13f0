"""Model zoo: every family of the reference, trained and served.

  layers       - shared building blocks (norms, RoPE, attention, MLP, MoE)
  transformer  - decoder-only LM: dense, MoE and VLM families, chunked
                 cross-entropy loss
  mamba2       - attention-free SSD (state-space duality)
  hybrid       - Zamba2-style Mamba2 stack + shared attention block
  whisper      - encoder-decoder backbone (audio family)
  api          - family dispatch: build / loss / prefill / decode
"""
