"""Shared model building blocks of the serving path.

Parameters live in ``nn.Module``s (``Attention``, ``MLP``) laid out as in
the JAX package (``x @ W`` with ``W`` of shape [in, out]), so a reference
parameter tree loads without transposes (``repro_torch.convert``).  Modules
take an explicit device and generator at init; the random init mirrors the
reference's distributions (dense: normal / sqrt(fan_in); norms 1; biases
0) without being bit-identical.

Products that the reference asks in fp32 (``preferred_element_type``) are
taken on float32 copies of their inputs.  There is no mesh in this package
yet, so the reference's sharding constraints and checkpoint names, which
are no-ops without one, are left out.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as fa_ops

NEG_INF = -1e30


def dense_init(shape, dtype, device, generator, scale=None):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale or 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32) * scale
    return nn.Parameter(w.to(dtype))


def ones(shape, dtype, device):
    return nn.Parameter(torch.ones(shape, dtype=dtype, device=device))


def zeros(shape, dtype, device):
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# Norms: f32 math, cast to x's dtype, then * g (the reference's order)
# ---------------------------------------------------------------------------

def rmsnorm(x, g, eps=1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * g


def layernorm(x, g, eps=1e-6):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * g


def apply_norm(kind, x, g, eps=1e-6):
    return rmsnorm(x, g, eps) if kind == "rmsnorm" else layernorm(x, g, eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings (full or partial fraction)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, fraction: float, base: float = 10000.0,
               device=None):
    rot = int(head_dim * fraction) // 2 * 2
    if rot == 0:
        return None
    return 1.0 / (base ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                        device=device) / rot))


def apply_rope(x, positions, inv_freqs):
    """x: [..., S, H, hd]; positions: [..., S] (int)."""
    if inv_freqs is None:
        return x
    rot = inv_freqs.shape[0] * 2
    xr, xp = x[..., :rot], x[..., rot:]
    ang = positions[..., None].float() * inv_freqs        # [..., S, r/2]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    xr = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([xr.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd
        self.wq = dense_init((D, H * hd), dtype, device, generator)
        self.wk = dense_init((D, KV * hd), dtype, device, generator)
        self.wv = dense_init((D, KV * hd), dtype, device, generator)
        self.wo = dense_init((H * hd, D), dtype, device, generator)
        if cfg.qkv_bias:
            self.bq = zeros((H * hd,), dtype, device)
            self.bk = zeros((KV * hd,), dtype, device)
            self.bv = zeros((KV * hd,), dtype, device)


def blockwise_attention(q, k, v, *, causal, q_offset=0, q_block=512,
                        kv_block=1024, probs_dtype=torch.float32):
    """Memory-bounded attention: online softmax over kv blocks, looped over
    q blocks.  q: [B, Sq, H, hd]; k/v: [B, Skv, KV, hd]; H % KV == 0;
    q_offset is the absolute position of q[0]."""
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    q_block = min(q_block, Sq)
    kv_block = min(kv_block, Skv)
    nq = math.ceil(Sq / q_block)
    nk = math.ceil(Skv / kv_block)
    pq, pk = nq * q_block, nk * kv_block
    dev = q.device
    qp = F.pad(q, (0, 0, 0, 0, 0, pq - Sq)).reshape(B, nq, q_block, KV, G,
                                                    hd)
    kp = F.pad(k, (0, 0, 0, 0, 0, pk - Skv)).reshape(B, nk, kv_block, KV, hd)
    vp = F.pad(v, (0, 0, 0, 0, 0, pk - Skv)).reshape(B, nk, kv_block, KV, hd)
    kv_valid = (torch.arange(pk, device=dev) < Skv).reshape(nk, kv_block)

    blocks = []
    for qi in range(nq):
        qb = qp[:, qi] * scale                            # [B, qb, KV, G, hd]
        q_pos = q_offset + qi * q_block + torch.arange(q_block, device=dev)
        m = torch.full((B, KV, G, q_block), NEG_INF, device=dev)
        l = torch.zeros((B, KV, G, q_block), device=dev)
        acc = torch.zeros((B, KV, G, q_block, hd), device=dev)
        for ki in range(nk):
            s = torch.einsum("bqkgh,bpkh->bkgqp", qb.float(),
                             kp[:, ki].float())
            k_pos = ki * kv_block + torch.arange(kv_block, device=dev)
            mask = kv_valid[ki][None, :]
            if causal:
                mask = mask & (q_pos[:, None] >= k_pos[None, :])
            s = s.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqp,bpkh->bkgqh", p.to(probs_dtype).float(),
                vp[:, ki].to(probs_dtype).float())
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        out = out.permute(0, 3, 1, 2, 4).reshape(B, q_block, H, hd)
        blocks.append(out.to(q.dtype))
    return torch.cat(blocks, dim=1)[:, :Sq]


def reference_attention(q, k, v, *, causal, q_offset=0):
    """Naive attention (small shapes / oracles only)."""
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgh,bpkh->bkgqp", qg.float(),
                     k.float()) / math.sqrt(hd)
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        mask = q_pos[:, None] >= torch.arange(Skv, device=q.device)[None, :]
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqp,bpkh->bkgqh", p, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP {item})")


def qchunk_attention(q, k, v, *, causal, q_offset=0, q_block=512,
                     probs_dtype=torch.float32):
    raise _not_ported("qchunk_attention", "A9")


def flashref_attention(q, k, v, causal=True, q_block=512,
                       probs_dtype=torch.float32):
    raise _not_ported("flashref_attention", "A9")


def attention_block(p, cfg, x, *, positions, causal=True, kv_cache=None,
                    cache_index=None, inv_freqs=None, context=None,
                    return_kv=False, stacked_cache=None, layer_index=None):
    """Full attention block. Returns (out, new_kv_cache).

    kv_cache: optional (k, v) of shape [B, S_max, KV, hd] for decode - the
      fresh k/v are written at ``cache_index`` into a copy and attention
      runs over the valid prefix (S == 1) or causally over the fresh k/v
      (S > 1).  Without a cache, ``cfg.attn_impl == "flash"`` runs the
      flash-attention kernel.
    context: cross-attention source; replaces the k/v input.
    return_kv: return the rope'd (k, v) of a cache-less call.
    ``stacked_cache`` (decode_inplace), ``qchunk`` and ``flashref`` are not
    ported yet and raise.
    """
    if stacked_cache is not None:
        raise _not_ported("the decode_inplace stacked-cache branch", "A9")
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    src = context if context is not None else x
    q = x @ p.wq
    k = src @ p.wk
    v = src @ p.wv
    if hasattr(p, "bq"):
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, src.shape[1], KV, hd)
    v = v.reshape(B, src.shape[1], KV, hd)
    if context is None and inv_freqs is not None:
        q = apply_rope(q, positions, inv_freqs)
        k = apply_rope(k, positions, inv_freqs)

    new_cache = None
    pdt = getattr(torch, cfg.attn_probs_dtype)
    if kv_cache is not None:
        ck, cv = kv_cache
        ck, cv = ck.clone(), cv.clone()
        ck[:, cache_index:cache_index + S] = k.to(ck.dtype)
        cv[:, cache_index:cache_index + S] = v.to(cv.dtype)
        new_cache = (ck, cv)
        if S > 1:
            if cfg.attn_impl in ("qchunk", "flashref") and \
                    src.shape[1] <= 8192:
                o = qchunk_attention(q, k, v, causal=True, probs_dtype=pdt)
            else:
                o = blockwise_attention(q, k, v, causal=True,
                                        probs_dtype=pdt)
        else:
            # decode: attend over the valid cache prefix only
            S_max = ck.shape[1]
            pos_mask = torch.arange(S_max, device=x.device) <= cache_index
            qg = q.reshape(B, S, KV, H // KV, hd)
            s = torch.einsum("bqkgh,bpkh->bkgqp", qg.float(), ck.float())
            s = s / math.sqrt(hd)
            s = s.masked_fill(~pos_mask, NEG_INF)
            pr = torch.softmax(s, dim=-1).to(pdt)
            o = torch.einsum("bkgqp,bpkh->bkgqh", pr.float(),
                             cv.to(pdt).float())
            o = o.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(x.dtype)
    else:
        if cfg.attn_impl == "flash" and context is None:
            o = fa_ops.flash_attention(q, k, v, causal=causal)
        elif S * src.shape[1] <= 256 * 256:
            o = reference_attention(q, k, v,
                                    causal=causal and context is None)
        elif cfg.attn_impl == "qchunk":
            o = qchunk_attention(q, k, v, causal=causal and context is None,
                                 probs_dtype=pdt)
        elif cfg.attn_impl == "flashref":
            o = flashref_attention(q, k, v, causal and context is None, 512,
                                   pdt)
        else:
            o = blockwise_attention(q, k, v,
                                    causal=causal and context is None,
                                    probs_dtype=pdt)
        if return_kv:
            new_cache = (k, v)
    out = o.reshape(B, S, H * hd) @ p.wo
    if cfg.tp_bf16_reduce:
        out = out.to(torch.bfloat16)
    return out, new_cache


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, d_model, d_ff, dtype, device, generator):
        super().__init__()
        self.w_gate = dense_init((d_model, d_ff), dtype, device, generator)
        self.w_up = dense_init((d_model, d_ff), dtype, device, generator)
        self.w_down = dense_init((d_ff, d_model), dtype, device, generator)


def mlp_block(p, x, cfg=None):
    h = F.silu(x @ p.w_gate) * (x @ p.w_up)
    y = h @ p.w_down
    if cfg is not None and cfg.tp_bf16_reduce:
        y = y.to(torch.bfloat16)
    return y


def moe_block(p, cfg, x, capacity_factor: float = 1.25):
    raise _not_ported("the MoE block", "A9")
