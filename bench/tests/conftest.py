"""Shared fixtures of the benchmark's tests: smoke-size cells of each kind
that run on the CPU through the kernels' plain paths."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SERVE_MODEL = {"name": "zamba2-smoke", "family": "hybrid", "n_layers": 4,
               "d_model": 64, "n_heads": 4, "kv_heads": 4, "d_ff": 256,
               "vocab": 256, "ssm_state": 16, "ssm_head_dim": 16,
               "ssm_expand": 2, "ssm_chunk": 32, "attn_every": 2,
               "param_dtype": "bfloat16", "attn_impl": "flash"}
SERVE_TRAFFIC = {"kind": "serve_closed", "batch": 2,
                 "block": [40, 72, 40], "pool_batches": 60,
                 "check_requests": 8, "check_rows": 2, "trace_batches": 2}
TRAIN_MODEL = {"name": "deepseek-moe-smoke", "family": "moe", "n_layers": 2,
               "d_model": 32, "n_heads": 2, "kv_heads": 2, "d_ff": 48,
               "vocab": 128, "moe_experts": 8, "moe_topk": 2,
               "moe_shared_experts": 1, "moe_d_ff": 48, "moe_first_dense": 1,
               "loss_chunk": 32, "param_dtype": "bfloat16",
               "attn_impl": "flash", "remat": True}
TRAIN_TRAFFIC = {"kind": "train_steps", "batch": 2, "seq": 32,
                 "pool_steps": 400, "zipf": 1.3, "follow": 0.5,
                 "trace_steps": 2}


def smoke_cell(kind: str, limits: dict) -> dict:
    """A cell dict as ``harness.resolve_cell`` gives it, at smoke size."""
    if kind == "serve_closed":
        cfg = {"name": "zamba2_smoke", "reference": "zamba2",
               "model": dict(SERVE_MODEL)}
        traffic = dict(SERVE_TRAFFIC)
    else:
        cfg = {"name": "deepseek_moe_smoke", "reference": "moe_lm",
               "model": dict(TRAIN_MODEL)}
        traffic = dict(TRAIN_TRAFFIC)
    return {"workload": {"name": f"smoke.{kind}", "chips": 1}, "config": cfg,
            "traffic": traffic, "limits": dict(limits),
            "spec": {"end_to_end": [], "per_layer": []}}


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
