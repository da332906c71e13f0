"""zamba2-2.7b [hybrid] - Mamba2 blocks + shared attention block
[arXiv:2411.15242; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, kv_heads=32,
    d_ff=10240, vocab=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    attn_every=6,
)

SMOKE = ArchConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, kv_heads=4,
    d_ff=256, vocab=256,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=32,
    attn_every=2, loss_chunk=64,
)
