"""int8 gradient compression with error feedback.

``compress_gradients`` quantizes each gradient leaf to int8 with a per-leaf
scale and carries the quantization error into the next step (error
feedback keeps the optimizer unbiased in expectation); it models the
numerics of a compressed data-parallel all-reduce.  The explicit int8
collective (the reference's ``compressed_psum``) waits for the distributed
port (ROADMAP A11).
"""

from __future__ import annotations

import torch


def _quantize(g):
    absmax = torch.max(torch.abs(g)) + 1e-12
    scale = absmax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_gradients(grads: dict, err_state: dict | None):
    """Quantize each gradient leaf to int8 (+ error feedback).

    Returns (dequantized grads in the leaves' dtypes, new float32 error
    state); ``err_state`` may be None on the first step."""
    if err_state is None:
        err_state = {n: torch.zeros(g.shape, dtype=torch.float32,
                                    device=g.device)
                     for n, g in grads.items()}
    deq, err = {}, {}
    for name, g in grads.items():
        g32 = g.float() + err_state[name]
        q, scale = _quantize(g32)
        d = q.float() * scale
        deq[name] = d.to(g.dtype)
        err[name] = g32 - d
    return deq, err
