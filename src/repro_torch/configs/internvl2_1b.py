"""internvl2-1b [vlm] - InternViT + InternLM2 (Qwen2-0.5B-like backbone);
vision frontend is a STUB: input_specs() provides 256 precomputed patch
embeddings [arXiv:2404.16821; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, kv_heads=2,
    d_ff=4864, vocab=151655,
    qkv_bias=True, vision_tokens=256,
)

SMOKE = ArchConfig(
    name="internvl2-smoke", family="vlm",
    n_layers=2, d_model=56, n_heads=4, kv_heads=2,
    d_ff=160, vocab=256, qkv_bias=True, vision_tokens=16, loss_chunk=64,
)
