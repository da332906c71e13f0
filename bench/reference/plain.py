"""Plain float32 building blocks of the references, and the lower
precision of the control.

Every product runs in float32 with TF32 off (``strict_float32``).  The
control computes the same model with the operands of every linear layer
rounded to float8 e4m3: weights scaled per tensor, activations per row,
each by its largest magnitude onto e4m3's 448, and the product accumulated
in float32, which is how an fp8 serving or training path computes its
projections.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


@contextlib.contextmanager
def strict_float32():
    """float32 products without TF32 (restored on exit)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8_round(t, dim=None):
    """``t`` rounded to e4m3 under a scale onto 448: per tensor
    (``dim`` None) or per slice along ``dim``; returned in float32.  The
    gradient passes the rounding unchanged, so a backward product takes
    the rounded operands and a float32 gradient."""
    t = t.float()
    if dim is None:
        amax = t.abs().amax()
    else:
        amax = t.abs().amax(dim=dim, keepdim=True)
    scale = (E4M3_MAX / torch.clamp_min(amax, 1e-30)).detach()
    rounded = (t * scale).to(torch.float8_e4m3fn).float() / scale
    return t + (rounded - t).detach()


def linear(x, w, precision="float32"):
    """``x @ w`` with w [in, out]; ``precision`` "fp8" is the control."""
    if precision == "fp8":
        return fp8_round(x, dim=-1) @ fp8_round(w)
    return x.float() @ w.float()


def rmsnorm(x, g, eps=1e-6):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * g


def rope(x, positions, base=10000.0):
    """Rotary embedding over the whole head, on interleaved pairs
    (x[..., 0::2], x[..., 1::2]); x [B, S, H, hd], positions [S]."""
    hd = x.shape[-1]
    inv = 1.0 / (base ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd))
    ang = positions[:, None].float() * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).reshape(x.shape)


def causal_attention(q, k, v, q_block=1024):
    """softmax(q k^T / sqrt(hd)) v under the causal mask, in blocks of
    query rows; q [B, S, H, hd], k and v [B, S, KV, hd] (H % KV == 0)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    k = k.repeat_interleave(G, dim=2) if G > 1 else k
    v = v.repeat_interleave(G, dim=2) if G > 1 else v
    out = torch.empty_like(q)
    kt = k.permute(0, 2, 3, 1)                      # [B, H, hd, S]
    vt = v.permute(0, 2, 1, 3)                      # [B, H, S, hd]
    for s0 in range(0, S, q_block):
        s1 = min(S, s0 + q_block)
        qb = q[:, s0:s1].permute(0, 2, 1, 3)        # [B, H, qb, hd]
        sc = (qb @ kt[..., :s1]) / math.sqrt(hd)
        rows = torch.arange(s0, s1, device=q.device)[:, None]
        cols = torch.arange(s1, device=q.device)[None, :]
        sc = sc.masked_fill(cols > rows, float("-inf"))
        p = torch.softmax(sc, dim=-1)
        out[:, s0:s1] = (p @ vt[:, :, :s1]).permute(0, 2, 1, 3)
    return out


def swiglu(x, wg, wu, wd, precision="float32"):
    return linear(F.silu(linear(x, wg, precision)) * linear(x, wu, precision),
                  wd, precision)


def gap_of(logits_ref, tokens):
    """How far below the reference's best logit each token's logit lies:
    logits_ref [N, V] (float32), tokens [N] -> [N]."""
    best = logits_ref.amax(dim=-1)
    return best - logits_ref.gather(-1, tokens[:, None].long())[:, 0]
