"""chatglm3-6b [dense] - RoPE 2d (half-dim rotary), GQA kv=2
[arXiv:2406.12793; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, kv_heads=2,
    d_ff=13696, vocab=65024,
    rope_fraction=0.5, qkv_bias=True,
)

SMOKE = ArchConfig(
    name="chatglm3-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, kv_heads=2,
    d_ff=224, vocab=256, rope_fraction=0.5, qkv_bias=True, loss_chunk=64,
)
