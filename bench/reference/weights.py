"""Weights drawn from the seed, in the type they are served in.

A model's parameters are listed by ``specs``: (name, shape, dtype, init),
with init one of ``("normal", scale)``, ``("ones",)``, ``("zeros",)``,
``("a_log",)`` (Mamba-2's A = -exp(A_log), A uniform in [1, 16]) and
``("dt_bias",)`` (softplus^-1 of dt log-uniform in [1e-3, 1e-1]).  All
normal parameters of one dtype are views of one buffer filled by one
``torch.randn`` call on the device; the few float32 vectors by one
``torch.rand`` call.  The same seed and specs give the same weights, so
the plain reference draws them again after the program has been freed.
"""

from __future__ import annotations

import math

import torch

WEIGHT_STREAM = 1


def make_weights(specs, seed: int, device, dtype_override=None) -> dict:
    """{name: tensor} for ``specs``; ``dtype_override`` casts every
    parameter (the reference's float32) after the draw, so the values are
    those of the served type."""
    from bench.harness import seed_generator
    gen = seed_generator(seed, WEIGHT_STREAM, device)
    out = {}
    by_dtype: dict = {}
    for name, shape, dtype, init in specs:
        if init[0] == "normal":
            by_dtype.setdefault(dtype, []).append((name, shape, init[1]))
    for dtype, items in by_dtype.items():
        total = sum(math.prod(s) for _, s, _ in items)
        flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
        off = 0
        for name, shape, scale in items:
            n = math.prod(shape)
            w = flat[off:off + n].view(shape)
            w.mul_(scale)
            out[name] = w
            off += n
    small = [(n, s, d, i) for n, s, d, i in specs if i[0] in ("a_log",
                                                                "dt_bias")]
    total = sum(math.prod(s) for _, s, _, _ in small)
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    off = 0
    for name, shape, dtype, init in small:
        n = math.prod(shape)
        v = u[off:off + n].view(shape)
        off += n
        if init[0] == "a_log":
            out[name] = torch.log(1.0 + 15.0 * v).to(dtype)
        else:
            dt = torch.exp(math.log(1e-3) + v * (math.log(1e-1)
                                                 - math.log(1e-3)))
            out[name] = (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    for name, shape, dtype, init in specs:
        if init[0] == "ones":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        elif init[0] == "zeros":
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
    if dtype_override is not None:
        out = {k: v.to(dtype_override) for k, v in out.items()}
    return out

