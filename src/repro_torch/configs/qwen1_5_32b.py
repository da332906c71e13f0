"""qwen1.5-32b [dense] - QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, kv_heads=40,
    d_ff=27392, vocab=152064,
    qkv_bias=True,
)

SMOKE = ArchConfig(
    name="qwen1.5-smoke", family="dense",
    n_layers=2, d_model=80, n_heads=4, kv_heads=4,
    d_ff=224, vocab=256, qkv_bias=True, loss_chunk=64,
)
