"""Plain float32 reference of the hybrid Mamba-2 + shared-attention model
as the configuration states it (the port's reading of Zamba2,
arXiv:2411.15242): ``n_layers`` Mamba-2 blocks, and after every
``attn_every`` of them one attention + SwiGLU block whose weights all its
applications share.

Mamba-2 block: RMSNorm, one input projection to (z, x, B, C, dt), a
depthwise causal convolution of width 4 over (x, B, C) with SiLU, the SSD
recurrence per head

    s_t = exp(dt_t A) s_{t-1} + dt_t B_t x_t,   y_t = C_t s_t + D x_t,

with dt = softplus(dt + dt_bias) and A = -exp(A_log), then y RMS-normed
after the gate SiLU(z), and the output projection, added to the residual.
The shared block: pre-norm causal attention with rotary embeddings over
the whole head, then a pre-norm SwiGLU MLP.  Norms are RMSNorm with eps
1e-6; the head is a separate [d_model, vocab] matrix.

Parameter names and shapes are the serving program's, so the benchmark
hands one set of weights to both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference.plain import (causal_attention, linear, rmsnorm, rope,
                                   swiglu)

CONV_K = 4


def dims(m: dict):
    d_in = m["ssm_expand"] * m["d_model"]
    nh = d_in // m["ssm_head_dim"]
    n = m["ssm_state"]
    return d_in, nh, n, d_in + 2 * n, 2 * d_in + 2 * n + nh


def specs(m: dict) -> list:
    """(name, shape, dtype, init) of every parameter."""
    bf16, f32 = getattr(torch, m["param_dtype"]), torch.float32
    D, V, F_ = m["d_model"], m["vocab"], m["d_ff"]
    H, KV = m["n_heads"], m["kv_heads"]
    hd = m.get("head_dim") or D // H
    d_in, nh, n, conv_dim, proj_dim = dims(m)
    out = [("embed", (V, D), bf16, ("normal", 0.02))]
    for i in range(m["n_layers"]):
        p = f"layers.{i}."
        out += [(p + "ln", (D,), bf16, ("ones",)),
                (p + "in_proj", (D, proj_dim), bf16, ("normal", D ** -0.5)),
                (p + "conv_w", (CONV_K, conv_dim), bf16, ("normal", 0.5)),
                (p + "conv_b", (conv_dim,), bf16, ("zeros",)),
                (p + "A_log", (nh,), f32, ("a_log",)),
                (p + "D", (nh,), f32, ("ones",)),
                (p + "dt_bias", (nh,), f32, ("dt_bias",)),
                (p + "norm_g", (d_in,), bf16, ("ones",)),
                (p + "out_proj", (d_in, D), bf16, ("normal", d_in ** -0.5))]
    out += [("shared.ln1", (D,), bf16, ("ones",)),
            ("shared.attn.wq", (D, H * hd), bf16, ("normal", D ** -0.5)),
            ("shared.attn.wk", (D, KV * hd), bf16, ("normal", D ** -0.5)),
            ("shared.attn.wv", (D, KV * hd), bf16, ("normal", D ** -0.5)),
            ("shared.attn.wo", (H * hd, D), bf16,
             ("normal", (H * hd) ** -0.5)),
            ("shared.ln2", (D,), bf16, ("ones",)),
            ("shared.mlp.w_gate", (D, F_), bf16, ("normal", D ** -0.5)),
            ("shared.mlp.w_up", (D, F_), bf16, ("normal", D ** -0.5)),
            ("shared.mlp.w_down", (F_, D), bf16, ("normal", F_ ** -0.5)),
            ("ln_f", (D,), bf16, ("ones",)),
            ("unembed", (D, V), bf16, ("normal", 0.02))]
    return out


def ssd(x, dt, A, B, C, D, chunk=256):
    """The SSD recurrence in chunks (exact in exact arithmetic):
    x [b, l, h, p], dt [b, l, h], A [h], B and C [b, l, n], D [h]."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, l, chunk):
        c1 = min(l, c0 + chunk)
        xc, dtc, Bc, Cc = x[:, c0:c1], dt[:, c0:c1], B[:, c0:c1], C[:, c0:c1]
        q = c1 - c0
        cum = torch.cumsum(dtc * A, dim=1)                     # [b, q, h]
        seg = cum[:, :, None, :] - cum[:, None, :, :]          # [b, i, j, h]
        tri = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                    device=x.device))
        decay = torch.exp(seg.masked_fill(~tri[None, :, :, None],
                                          float("-inf")))
        cb = torch.einsum("bin,bjn->bij", Cc, Bc)
        y = torch.einsum("bij,bijh,bjhp->bihp", cb, decay,
                         xc * dtc[..., None])
        y = y + torch.einsum("bin,bhpn->bihp", Cc, state) \
            * torch.exp(cum)[..., None]
        to_end = torch.exp(cum[:, -1:, :] - cum)
        state = state * torch.exp(cum[:, -1, :])[..., None, None] \
            + torch.einsum("bjh,bjn,bjhp->bhpn", to_end * dtc, Bc, xc)
        ys.append(y)
    return torch.cat(ys, dim=1) + x * D[None, None, :, None]


def mamba_block(w, p, m, u, precision):
    d_in, nh, n, _, _ = dims(m)
    hp = m["ssm_head_dim"]
    Bsz, S, _ = u.shape
    zxbcdt = linear(rmsnorm(u, w[p + "ln"]), w[p + "in_proj"], precision)
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:2 * d_in + 2 * n]
    dt = zxbcdt[..., 2 * d_in + 2 * n:]
    padded = F.pad(xbc, (0, 0, CONV_K - 1, 0))
    conv = sum(padded[:, i:i + S] * w[p + "conv_w"][i] for i in range(CONV_K))
    xbc = F.silu(conv + w[p + "conv_b"])
    x = xbc[..., :d_in].reshape(Bsz, S, nh, hp)
    Bm, Cm = xbc[..., d_in:d_in + n], xbc[..., d_in + n:]
    dt = F.softplus(dt + w[p + "dt_bias"])
    y = ssd(x, dt, -torch.exp(w[p + "A_log"]), Bm, Cm, w[p + "D"],
            m.get("ssm_chunk", 256))
    y = rmsnorm(y.reshape(Bsz, S, d_in) * F.silu(z), w[p + "norm_g"])
    return u + linear(y, w[p + "out_proj"], precision)


def shared_block(w, m, x, precision):
    H, KV = m["n_heads"], m["kv_heads"]
    hd = m.get("head_dim") or m["d_model"] // H
    B, S, _ = x.shape
    h = rmsnorm(x, w["shared.ln1"])
    pos = torch.arange(S, device=x.device)
    q = rope(linear(h, w["shared.attn.wq"], precision).reshape(B, S, H, hd),
             pos)
    k = rope(linear(h, w["shared.attn.wk"], precision).reshape(B, S, KV, hd),
             pos)
    v = linear(h, w["shared.attn.wv"], precision).reshape(B, S, KV, hd)
    o = causal_attention(q, k, v).reshape(B, S, H * hd)
    x = x + linear(o, w["shared.attn.wo"], precision)
    h = rmsnorm(x, w["shared.ln2"])
    return x + swiglu(h, w["shared.mlp.w_gate"], w["shared.mlp.w_up"],
                      w["shared.mlp.w_down"], precision)


@torch.no_grad()
def last_logits(w: dict, m: dict, tokens, precision="float32"):
    """Logits of the last position of every row of ``tokens`` [B, S],
    float32 [B, vocab].  ``w`` holds float32 tensors."""
    x = F.embedding(tokens, w["embed"])
    every = m["attn_every"]
    for i in range(m["n_layers"]):
        x = mamba_block(w, f"layers.{i}.", m, x, precision)
        if (i + 1) % every == 0:
            x = shared_block(w, m, x, precision)
    h = rmsnorm(x[:, -1], w["ln_f"])
    return linear(h, w["unembed"], precision)
