"""deepseek-67b [dense] - llama-arch [arXiv:2401.02954; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, kv_heads=8,
    d_ff=22016, vocab=102400,
)

SMOKE = ArchConfig(
    name="deepseek-67b-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=8, kv_heads=1,
    d_ff=192, vocab=512, loss_chunk=64,
)
