"""The yardstick's operation and byte counts against numbers worked out
by hand."""

from __future__ import annotations

import pytest

from bench.yardstick import flops, kernels, peaks


def test_k2_serving_shape():
    # B 4, H = KV 32, S 1024, hd 80, causal: 4 * 32 * 1024 * 1025 / 2 pairs
    n_bytes, ops, rate = kernels.k2(4, 32, 32, 1024, 1024, 80, True)
    pairs = 4 * 32 * 1024 * 1025 // 2
    assert ops == 4 * 80 * pairs == 21_495_808_000
    assert n_bytes == 2 * (4 * 32 * 1024 * 80 * 2) * 2 + 4 * 4 * 32 * 1024
    assert rate == 989e12
    # chip_smoke's serving bound: 0.0252 ms (bytes)
    assert peaks.bound_s(n_bytes, ops, rate) * 1e3 == pytest.approx(
        0.02517, abs=1e-4)


def test_k3_k4_training_shape():
    # B 4, H 32, KV 4, S 2048, hd 64, causal (chip_smoke: 0.1043, 0.1390 ms)
    shape = (4, 32, 4, 2048, 64)
    b3, o3, _ = kernels.k3(*shape)
    b4, o4, _ = kernels.k4(*shape)
    pairs = 4 * 32 * 2048 * 2049 // 2
    assert (o3, o4) == (6 * 64 * pairs, 8 * 64 * pairs)
    assert b3 == b4 == 4 * (4 * 32 * 2048 * 64 * 2) \
        + 2 * (4 * 4 * 2048 * 64 * 2) + 8 * 4 * 32 * 2048
    assert o3 / 989e12 * 1e3 == pytest.approx(0.1043, abs=1e-4)
    assert o4 / 989e12 * 1e3 == pytest.approx(0.1390, abs=1e-4)


def test_k5_serving_shape():
    # b 4, l 1024, h 80, p 64, n 64, chunk 256 (chip_smoke: 0.0257 ms, bytes)
    n_bytes, ops, _ = kernels.k5(4, 1024, 80, 64, 64, 256)
    tri = 256 * 257 // 2
    assert ops == 4 * 4 * (tri * 128 + 80 * (tri * 128 + 2 * 256 * 2 * 64 * 64))
    assert n_bytes == 4 * 4 * 1024 * 80 * 64 + 4 * 4 * 1024 * 80 \
        + 4 * 4 * 1024 * 64 + 8 * 80
    assert peaks.bound_s(n_bytes, ops, 989e12) * 1e3 == pytest.approx(
        0.0257, abs=1e-4)
    # a length that is not a whole number of chunks is padded
    assert kernels.k5(1, 300, 80, 64, 64, 256) == kernels.k5(1, 512, 80, 64,
                                                             64, 256)


def test_b6():
    assert kernels.b6(1000, 8, 16) == (16_128, 40_000, 33.5e12)


def test_hybrid_prefill_flops():
    m = {"n_layers": 2, "d_model": 8, "n_heads": 2, "kv_heads": 2,
         "d_ff": 16, "vocab": 10, "ssm_state": 4, "ssm_head_dim": 4,
         "ssm_expand": 2, "ssm_chunk": 4, "attn_every": 2}
    B, S = 1, 4
    # Mamba-2: in_proj 8 -> 2*16 + 2*4 + 4 = 44, out_proj 16 -> 8
    mamba = 2 * 4 * 8 * 44 + 2 * 4 * 16 * 8 + kernels.k5(1, 4, 4, 4, 4, 4)[1]
    # one application: q, k, v, o (8 x 8 each), causal 10 pairs a head, MLP
    shared = 2 * 4 * 8 * 32 + 4 * 4 * (2 * 10) + 3 * 2 * 4 * 8 * 16
    head = 2 * 8 * 10
    assert flops.hybrid_prefill(m, B, S) == 2 * mamba + shared + head


def test_moe_train_step_flops():
    m = {"n_layers": 2, "d_model": 8, "n_heads": 2, "kv_heads": 2,
         "d_ff": 16, "vocab": 10, "moe_experts": 4, "moe_topk": 2,
         "moe_shared_experts": 1, "moe_d_ff": 6, "moe_first_dense": 1}
    B, S = 1, 4
    attn = 2 * 4 * 8 * 32 + 4 * 4 * (2 * 10)
    dense = attn + 3 * 2 * 4 * 8 * 16
    moe = attn + 3 * (3 * 2 * 4 * 8 * 6) + 2 * 4 * 8 * 4
    head = 2 * 4 * 8 * 10
    assert flops.moe_train_step(m, B, S) == 3 * (dense + moe + head)
