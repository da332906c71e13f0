"""tinyllama-1.1b [dense] - llama2-arch small [arXiv:2401.02385; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, kv_heads=4,
    d_ff=5632, vocab=32000,
)

SMOKE = ArchConfig(
    name="tinyllama-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, kv_heads=2,
    d_ff=160, vocab=256, loss_chunk=64,
)
