"""Matrix-product FLOPs of the models' forward and training steps, from the
configuration's widths (a multiply-add counts two).

Every product a token needs is counted: a hybrid's shared attention + MLP
block once for each of its applications, attention's QK^T and PV over the
causal half, the SSD scan's chunked products (as ``kernels.k5`` counts
them), MoE at its top-k routed experts plus its shared experts, and the
head where logits are computed.  The embedding lookup is no product and
counts nothing.  A training step is three times the forward (the backward
takes two products for each of the forward's).
"""

from __future__ import annotations

from bench.yardstick import kernels


def _hd(m):
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def _attention(m, B, S):
    """Projections and the causal QK^T, PV of one attention layer over B
    rows of S tokens."""
    D, H, KV, hd = m["d_model"], m["n_heads"], m["kv_heads"], _hd(m)
    proj = 2 * B * S * D * (2 * H * hd + 2 * KV * hd)
    return proj + kernels.k2(B, H, KV, S, S, hd, True)[1]


def _swiglu(B, S, D, F):
    return 3 * 2 * B * S * D * F


def hybrid_prefill(m: dict, B: int, S: int) -> int:
    """A hybrid (Mamba-2 + shared attention) prefill of B rows of S
    tokens, logits of the last position only."""
    D = m["d_model"]
    d_in = m["ssm_expand"] * D
    nh = d_in // m["ssm_head_dim"]
    n = m["ssm_state"]
    proj_dim = 2 * d_in + 2 * n + nh
    mamba = 2 * B * S * D * proj_dim + 2 * B * S * d_in * D \
        + kernels.k5(B, S, nh, m["ssm_head_dim"], n,
                     m.get("ssm_chunk", 256))[1]
    apps = m["n_layers"] // m["attn_every"]
    shared = _attention(m, B, S) + _swiglu(B, S, D, m["d_ff"])
    head = 2 * B * D * m["vocab"]
    return m["n_layers"] * mamba + apps * shared + head


def moe_forward(m: dict, B: int, S: int, logits_positions: int) -> int:
    """A transformer with leading dense layers and MoE layers (top-k
    routed experts plus shared experts), the router's product included;
    the head over ``logits_positions`` positions."""
    D = m["d_model"]
    n_dense = m.get("moe_first_dense", 0)
    n_moe = m["n_layers"] - n_dense
    fe = m.get("moe_d_ff") or m["d_ff"]
    dense = _attention(m, B, S) + _swiglu(B, S, D, m["d_ff"])
    routed = (m["moe_topk"] + m.get("moe_shared_experts", 0))
    moe = _attention(m, B, S) + routed * _swiglu(B, S, D, fe) \
        + 2 * B * S * D * m["moe_experts"]
    return n_dense * dense + n_moe * moe + 2 * logits_positions * D * m["vocab"]


def moe_train_step(m: dict, B: int, S: int) -> int:
    """Forward, backward: three times the forward, the loss's head over
    every position."""
    return 3 * moe_forward(m, B, S, B * S)
