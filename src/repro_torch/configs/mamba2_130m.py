"""mamba2-130m [ssm] - SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, kv_heads=0,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, kv_heads=0,
    d_ff=0, vocab=256,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=32,
    tie_embeddings=True, loss_chunk=64,
)
