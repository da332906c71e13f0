"""deepseek-moe-16b [moe] - 2 shared + 64 routed top-6, fine-grained,
first layer dense [arXiv:2401.06066; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, kv_heads=16,
    d_ff=1408, vocab=102400,
    moe_experts=64, moe_topk=6, moe_shared_experts=2, moe_d_ff=1408,
    moe_first_dense=1,
)

SMOKE = ArchConfig(
    name="deepseek-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, kv_heads=4,
    d_ff=96, vocab=256,
    moe_experts=8, moe_topk=2, moe_shared_experts=1, moe_d_ff=96,
    moe_first_dense=1, loss_chunk=64,
)
