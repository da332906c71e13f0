"""whisper-small [audio] - enc-dec transformer backbone; conv frontend
is a STUB: input_specs() provides 1500 precomputed mel-frame embeddings
[arXiv:2212.04356; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, kv_heads=12,
    d_ff=3072, vocab=51865,
    enc_layers=12, enc_seq=1500, norm="layernorm", rope_fraction=0.0,
)

SMOKE = ArchConfig(
    name="whisper-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, kv_heads=4,
    d_ff=192, vocab=256,
    enc_layers=2, enc_seq=32, norm="layernorm", rope_fraction=0.0,
    loss_chunk=64,
)
