"""Operations and bytes of one call of each hand-written kernel, at the
shape it is called with: the arithmetic behind ``chip_smoke.py``'s
``bound_ms``, frozen with the benchmark.  Each input byte is counted once,
each output byte once, whatever the kernel reads again.

Each function returns ``(bytes, operations, operations_per_s)``; a
roofline share is ``peaks.bound_s(...)`` summed over the calls a trace
holds, over the device seconds of the kernel's launches there.
"""

from __future__ import annotations

from bench.yardstick.peaks import BF16_FLOPS_PER_S, INT_OPS_PER_S

# the names that start each kernel's device operations in a trace
# (``bench/timeline.py``): its CUDA kernels (K5 launches three a call, the
# backward K3's and K4's), and on the CPU its wrapper's span
K2_KERNELS = ("flash_fwd_", "K2 ")
K34_KERNELS = ("flash_bwd_", "K3+K4 ")
K5_KERNELS = ("ssd_", "K5 ")


def k2(B, H, KV, Sq, Skv, hd, causal=True):
    """Flash-attention forward (bf16): QK^T and PV over the (q, kv) pairs
    the mask keeps; q, k, v and o read or written once, the float32
    log-sum-exp written once."""
    qb, kvb = B * H * Sq * hd * 2, B * KV * Skv * hd * 2
    return (2 * qb + 2 * kvb + 4 * B * H * Sq,
            4 * hd * _pairs(B, H, Sq, Skv, causal), BF16_FLOPS_PER_S)


def _pairs(B, H, Sq, Skv, causal):
    """(q, kv) pairs the mask leaves (causal: top-left aligned)."""
    if not causal:
        return B * H * Sq * Skv
    if Sq <= Skv:
        return B * H * Sq * (Sq + 1) // 2
    return B * H * (Skv * (Skv + 1) // 2 + (Sq - Skv) * Skv)


def _bwd_bytes(B, H, KV, S, hd):
    """K3 reads q, o, dO, k, v, lse and writes dq, delta; K4 reads q, dO,
    k, v, lse, delta and writes dk, dv: counted alike."""
    qb, kvb = B * H * S * hd * 2, B * KV * S * hd * 2
    return 4 * qb + 2 * kvb + 2 * 4 * B * H * S


def k3(B, H, KV, S, hd, causal=True):
    """dq pass: 6 * hd operations a kept (q, kv) pair."""
    return (_bwd_bytes(B, H, KV, S, hd),
            6 * hd * _pairs(B, H, S, S, causal), BF16_FLOPS_PER_S)


def k4(B, H, KV, S, hd, causal=True):
    """dk/dv pass: 8 * hd operations a kept (q, kv) pair."""
    return (_bwd_bytes(B, H, KV, S, hd),
            8 * hd * _pairs(B, H, S, S, causal), BF16_FLOPS_PER_S)


def k5(b, l, h, p, n, chunk):
    """SSD scan (bf16 x, B, C; float32 dt): the chunked algorithm's matrix
    products (C B^T once per batch and chunk, (C B^T o decay) x per head,
    C state and the state update), over l padded to whole chunks."""
    L = -(-l // chunk) * chunk
    n_chunks = L // chunk
    tri = chunk * (chunk + 1) // 2
    flops = b * n_chunks * (tri * 2 * n + h * (
        tri * 2 * p + 2 * chunk * 2 * p * n))
    n_bytes = 2 * 2 * b * L * h * p + 4 * b * L * h + 2 * 2 * b * L * n \
        + 2 * 4 * h
    return n_bytes, flops, BF16_FLOPS_PER_S


def b6(accesses: int, n_sets: int, ways: int):
    """Cache replay: 8 B read and 8 B written an access, the sets' offsets
    and counts read once; a tag and a stamp compare a way and a few
    operations for the update, 2 * ways + 8 integer operations an
    access."""
    return (16 * accesses + 16 * n_sets, (2 * ways + 8) * accesses,
            INT_OPS_PER_S)
