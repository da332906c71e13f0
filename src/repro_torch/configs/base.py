"""Architecture/shape config schema for the framework.

Every assigned architecture gets one module in ``repro_torch.configs`` exporting
``CONFIG`` (the exact published configuration) and ``SMOKE`` (a reduced
same-family configuration for CPU smoke tests).  Input-shape cells follow
the assignment: train_4k / prefill_32k / decode_32k / long_500k.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

# the architectures this package has a config module for
ARCH_IDS = (
    "tinyllama_1_1b",
)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None       # defaults to d_model // n_heads
    qkv_bias: bool = False               # qwen1.5
    rope_fraction: float = 1.0           # chatglm3: rotary on half dims
    tie_embeddings: bool = False
    norm: str = "rmsnorm"
    # --- MoE ---
    moe_experts: int = 0
    moe_topk: int = 0
    moe_shared_experts: int = 0
    moe_d_ff: Optional[int] = None       # routed-expert hidden size
    moe_every: int = 1                   # MoE layer cadence (1 = all)
    moe_first_dense: int = 0             # leading dense layers (deepseek-moe)
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    attn_every: int = 0                  # zamba2: shared attn block cadence
    # --- enc-dec / multimodal ---
    enc_layers: int = 0                  # whisper encoder depth
    enc_seq: int = 0                     # fixed encoder length (1500 frames)
    vision_tokens: int = 0               # internvl2 stub patch embeddings
    # --- numerics / execution ---
    param_dtype: str = "bfloat16"
    remat: bool = True
    attn_impl: str = "ref"               # "ref" (XLA) | "flash" (Pallas)
    loss_chunk: int = 2048               # vocab-chunked CE block (tokens)
    # --- perf knobs (§Perf hillclimb; defaults = paper-faithful baseline)
    attn_probs_dtype: str = "float32"    # bf16 halves attention HBM traffic
    ce_recompute: bool = False           # recompute CE logits in backward
    moe_local_dispatch: bool = False     # per-DP-shard MoE dispatch (EP a2a)
    tp_bf16_reduce: bool = False         # bf16 TP partial-sum all-reduces
    save_proj_remat: bool = False        # remat policy: keep projection
    #   outputs so the backward replay skips the fwd TP all-reduces
    decode_inplace: bool = False         # thread the KV cache through the
    #   layer-scan carry with single-token DUS (no cache re-stacking)

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Approximate total parameters (embedding + blocks)."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        hd, H, KV = self.hd, self.n_heads, self.kv_heads
        attn = D * (H * hd) + 2 * D * (KV * hd) + (H * hd) * D
        dense_mlp = 3 * D * F
        p = 0
        if self.family == "ssm":
            d_in = self.ssm_expand * D
            nh = d_in // self.ssm_head_dim
            blk = D * (2 * d_in + 2 * self.ssm_state + nh) + d_in * D
            p += self.n_layers * (blk + 2 * D)
        elif self.family == "hybrid":
            d_in = self.ssm_expand * D
            nh = d_in // self.ssm_head_dim
            blk = D * (2 * d_in + 2 * self.ssm_state + nh) + d_in * D
            p += self.n_layers * (blk + 2 * D)
            p += attn + dense_mlp + 2 * D        # one shared attn+mlp block
        else:
            per_layer = attn + 2 * D
            if self.moe_experts:
                fe = self.moe_d_ff or F
                moe = (D * self.moe_experts
                       + self.moe_experts * 3 * D * fe
                       + self.moe_shared_experts * 3 * D * fe)
                n_moe = max(0, (self.n_layers - self.moe_first_dense)
                            // self.moe_every)
                n_dense = self.n_layers - n_moe
                p += n_moe * (per_layer + moe) + n_dense * (
                    per_layer + dense_mlp)
            else:
                p += self.n_layers * (per_layer + dense_mlp)
            if self.enc_layers:
                # encoder blocks + decoder cross-attention
                p += self.enc_layers * (attn + dense_mlp + 2 * D)
                p += self.n_layers * (attn + D)
        p += V * D * (1 if self.tie_embeddings else 2)
        return p

    def active_param_count(self) -> int:
        """Active parameters per token (MoE top-k accounting)."""
        if not self.moe_experts:
            return self.param_count()
        fe = self.moe_d_ff or self.d_ff
        D = self.d_model
        n_moe = max(0, (self.n_layers - self.moe_first_dense)
                    // self.moe_every)
        inactive = n_moe * (self.moe_experts - self.moe_topk) * 3 * D * fe
        return self.param_count() - inactive


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeCell) -> bool:
    """long_500k needs sub-quadratic attention (DESIGN.md §4)."""
    if shape.name == "long_500k":
        return cfg.subquadratic
    return True


def get_config(arch_id: str, smoke: bool = False) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.SMOKE if smoke else mod.CONFIG


def get_tuned_config(arch_id: str, smoke: bool = False) -> ArchConfig:
    """Config with the §Perf-confirmed optimizations applied
    (EXPERIMENTS.md): flash-recompute attention for attention families,
    shard_map expert-parallel MoE dispatch, projection-saving remat."""
    cfg = get_config(arch_id, smoke)
    overrides = {}
    if cfg.n_heads:
        overrides["attn_impl"] = "flashref"
        overrides["save_proj_remat"] = True
        overrides["tp_bf16_reduce"] = True
    if cfg.moe_experts:
        overrides["moe_local_dispatch"] = True
    return dataclasses.replace(cfg, **overrides)


def all_cells():
    """Every (arch, shape) cell, with applicability flag."""
    out = []
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES.values():
            out.append((a, s.name, shape_applicable(cfg, s)))
    return out
