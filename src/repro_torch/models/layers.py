"""Shared model building blocks of the serving and training paths.

Parameters live in ``nn.Module``s (``Attention``, ``MLP``, ``MoE``) laid
out as in the JAX package (``x @ W`` with ``W`` of shape [in, out]), so a
reference parameter tree loads without transposes (``repro_torch.convert``).
Modules take an explicit device and generator at init; the random init
mirrors the reference's distributions (dense: normal / sqrt(fan_in); norms
1; biases 0) without being bit-identical.

Products that the reference asks in fp32 (``preferred_element_type``) are
taken on float32 copies of their inputs.  The reference's sharding
constraints are ``sharding.constrain`` calls at the same places (no-ops
without a mesh); under a mesh the hand kernels run through ``local_map``
on each rank's shard (``_flash_attention``).  Its checkpoint name
``proj_out`` (the products by ``wo`` and ``w_down``) has no torch
counterpart: ``transformer.py``'s ``save_proj_remat`` policy finds those
products by their weights.
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import BATCH, MODEL, constrain
from repro_torch.kernels.flash_attention import ops as fa_ops

NEG_INF = -1e30


def dense_init(shape, dtype, device, generator, scale=None):
    if torch.device(device).type == "meta":      # shape and dtype only
        return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))
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


def split_heads(t, n, hd, groups=None):
    """[B, S, n * hd] -> [B, S, n, hd].  Under a mesh, a projection whose
    ``model`` shards would cut a head, or for q a KV group (``groups``),
    is replicated over ``model`` first: DTensor cannot unflatten such a
    shard, where GSPMD would reshard it silently."""
    if shd.is_dtensor(t) and (n if groups is None else groups) % \
            shd.axis_size("model"):
        t = constrain(t, (BATCH, None, None))
    return t.reshape(t.shape[0], t.shape[1], n, hd)


def merge_heads(o):
    """[B, S, n, hd] -> [B, S, n * hd], its gradient placed as the merged
    tensor is under a mesh (``sharding.grad_as_placed``), so that the
    backward's split of the heads never meets a ``model`` shard that cuts
    one."""
    return shd.grad_as_placed(o.reshape(o.shape[0], o.shape[1], -1))


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


def _acc_dtype(t):
    """The dtype the reference's float32 products take: float32, or
    float64 for float64 inputs (``torch.autograd.gradcheck``)."""
    return torch.promote_types(t.dtype, torch.float32)


def _q_chunks(q, KV, q_block):
    """q [B, Sq, H, hd] padded to whole chunks of ``q_block`` rows and
    split: [B, nq, q_block, KV, G, hd]."""
    B, Sq, H, hd = q.shape
    nq = math.ceil(Sq / q_block)
    qp = F.pad(q, (0, 0, 0, 0, 0, nq * q_block - Sq))
    return qp.reshape(B, nq, q_block, KV, H // KV, hd)


def _chunk_scores(qc, kf, causal, q_pos):
    """Scores [B, KV, G, qb, Skv] of one q chunk qc [B, qb, KV, G, hd]
    against kf [B, Skv, KV, hd]; with ``causal`` the keys after each
    query's absolute position ``q_pos`` [qb] are masked."""
    s = torch.einsum("bqkgh,bpkh->bkgqp", qc, kf)
    if causal:
        k_pos = torch.arange(kf.shape[1], device=kf.device)
        s = s.masked_fill(~(q_pos[:, None] >= k_pos[None, :]), NEG_INF)
    return s


def _chunk_out(o, dtype):
    """[B, KV, G, qb, hd] -> [B, qb, H, hd] in ``dtype``."""
    B, KV, G, qb, hd = o.shape
    return o.permute(0, 3, 1, 2, 4).reshape(B, qb, KV * G, hd).to(dtype)


def qchunk_attention(q, k, v, *, causal, q_offset=0, q_block=512,
                     probs_dtype=torch.float32):
    """Single-pass attention: q in chunks of ``q_block`` rows (the last
    one padded), a full-K softmax per chunk, no online-softmax carry.
    q: [B, Sq, H, hd]; k/v: [B, Skv, KV, hd]; ``q_offset`` is the absolute
    position of q[0].  Products in float32 (the reference's
    ``preferred_element_type``), probabilities rounded to ``probs_dtype``
    before the product with v."""
    Sq, hd = q.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(hd)
    q_block = min(q_block, Sq)
    qp = _q_chunks(q, k.shape[2], q_block)
    acc = _acc_dtype(q)
    kf = k.to(acc)
    vp = v.to(probs_dtype).to(acc)
    rows = torch.arange(q_block, device=q.device)
    blocks = []
    for qi in range(qp.shape[1]):
        s = _chunk_scores((qp[:, qi] * scale).to(acc), kf, causal,
                          q_offset + qi * q_block + rows)
        p = torch.softmax(s, dim=-1).to(probs_dtype)
        o = torch.einsum("bkgqp,bpkh->bkgqh", p.to(acc), vp)
        blocks.append(_chunk_out(o, q.dtype))
    return torch.cat(blocks, dim=1)[:, :Sq]


def _flashref_fwd_impl(q, k, v, causal, q_block, probs_dtype):
    """(out, logsumexp [B, KV, G, Sq]) of ``flashref_attention``."""
    Sq, hd = q.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(hd)
    qb_ = min(q_block, Sq)
    qp = _q_chunks(q, k.shape[2], qb_)
    acc = _acc_dtype(q)
    kf = k.to(acc)
    vp = v.to(probs_dtype).to(acc)
    rows = torch.arange(qb_, device=q.device)
    blocks, lses = [], []
    for qi in range(qp.shape[1]):
        s = _chunk_scores(qp[:, qi].to(acc) * scale, kf, causal,
                          qi * qb_ + rows)
        lse = torch.logsumexp(s, dim=-1)                     # [B,KV,G,qb]
        p = torch.exp(s - lse[..., None]).to(probs_dtype)
        o = torch.einsum("bkgqp,bpkh->bkgqh", p.to(acc), vp)
        blocks.append(_chunk_out(o, q.dtype))
        lses.append(lse)
    return (torch.cat(blocks, dim=1)[:, :Sq],
            torch.cat(lses, dim=-1)[..., :Sq])


def _flashref_bwd(causal, q_block, q, k, v, o, lse, do):
    """(dq, dk, dv) from the saved (q, k, v, o, lse): per q chunk the
    scores and probabilities are recomputed from the logsumexp, dk and dv
    accumulate over the chunks in float32."""
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    scale = 1.0 / math.sqrt(hd)
    qb_ = min(q_block, Sq)
    acc = _acc_dtype(q)
    qp = _q_chunks(q, KV, qb_)
    dop = _q_chunks(do, KV, qb_)
    op = _q_chunks(o, KV, qb_)
    nq = qp.shape[1]
    lsep = F.pad(lse, (0, nq * qb_ - Sq)).reshape(B, KV, H // KV, nq, qb_)
    kf = k.to(acc)
    vf = v.to(acc)
    dk = torch.zeros((B, Skv, KV, hd), dtype=acc, device=q.device)
    dv = torch.zeros_like(dk)
    rows = torch.arange(qb_, device=q.device)
    dqs = []
    for qi in range(nq):
        qc = qp[:, qi].to(acc) * scale                       # [B,qb,KV,G,hd]
        doc = dop[:, qi].to(acc)
        oc = op[:, qi].to(acc)
        s = _chunk_scores(qc, kf, causal, qi * qb_ + rows)
        p = torch.exp(s - lsep[:, :, :, qi][..., None])      # recomputed
        dog = doc.permute(0, 2, 3, 1, 4)                     # [B,KV,G,qb,hd]
        dv = dv + torch.einsum("bkgqp,bkgqh->bpkh", p, dog)
        dp = torch.einsum("bkgqh,bpkh->bkgqp", dog, vf)
        delta = torch.sum(doc * oc, dim=-1).permute(0, 2, 3, 1)
        ds = p * (dp - delta[..., None])
        dqs.append(torch.einsum("bkgqp,bpkh->bqkgh", ds, kf) * scale)
        # qc carries the 1/sqrt(hd) scale already, so dk needs none
        dk = dk + torch.einsum("bkgqp,bqkgh->bpkh", ds, qc)
    dq = torch.cat(dqs, dim=1)[:, :Sq].reshape(B, Sq, H, hd)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashRef(torch.autograd.Function):
    """The reference's ``custom_vjp``: the forward saves only q, k, v, the
    output and the logsumexp; the backward recomputes the rest."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_block, probs_dtype):
        o, lse = _flashref_fwd_impl(q, k, v, causal, q_block, probs_dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.q_block = causal, q_block
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flashref_bwd(ctx.causal, ctx.q_block, q, k, v, o, lse,
                                   do)
        return dq, dk, dv, None, None, None


def flashref_attention(q, k, v, causal=True, q_block=512,
                       probs_dtype=torch.float32):
    """Flash-attention recompute semantics in tensor ops: q in chunks of
    ``q_block`` rows, a full-K softmax per chunk whose logsumexp is kept
    for the backward (``_FlashRef``).  ``causal``, ``q_block`` and
    ``probs_dtype`` are not differentiable."""
    return _FlashRef.apply(q, k, v, causal, q_block, probs_dtype)


def _decode_attention(q, ck, cv, cache_index, probs_dtype):
    """One decode step's attention over the cache's valid prefix
    (positions <= ``cache_index``); q: [B, S, H, hd]; ck/cv: [B, S_max,
    KV, hd].  Shared by the copying and the in-place cache paths, so the
    two give the same bits."""
    B, S, H, hd = q.shape
    KV = ck.shape[2]
    pos_mask = torch.arange(ck.shape[1], device=q.device) <= cache_index
    qg = q.reshape(B, S, KV, H // KV, hd)
    s = torch.einsum("bqkgh,bpkh->bkgqp", qg.float(), ck.float())
    s = s / math.sqrt(hd)
    s = s.masked_fill(~pos_mask, NEG_INF)
    pr = torch.softmax(s, dim=-1).to(probs_dtype)
    o = torch.einsum("bkgqp,bpkh->bkgqh", pr.float(),
                     cv.to(probs_dtype).float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)


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
    stacked_cache: ``decode_inplace`` - the whole [L, B, S_max, KV, hd]
      cache pair; the new token's k/v are written in place at
      (``layer_index``, ``cache_index``), attention runs over that layer's
      valid prefix, and the same two tensors are returned.
    """
    S = x.shape[1]
    H, KV, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    src = context if context is not None else x
    q = x @ p.wq
    k = src @ p.wk
    v = src @ p.wv
    if hasattr(p, "bq"):
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = split_heads(q, H, hd, KV)
    k = split_heads(k, KV, hd)
    v = split_heads(v, KV, hd)
    q = constrain(q, head_template(KV))
    k = constrain(k, (BATCH, None, MODEL, None))
    if context is None and inv_freqs is not None:
        q = apply_rope(q, positions, inv_freqs)
        k = apply_rope(k, positions, inv_freqs)

    new_cache = None
    pdt = getattr(torch, cfg.attn_probs_dtype)
    if stacked_cache is not None:
        ck_all, cv_all = stacked_cache
        ck_all[layer_index, :, cache_index:cache_index + S] = \
            k.to(ck_all.dtype)
        cv_all[layer_index, :, cache_index:cache_index + S] = \
            v.to(cv_all.dtype)
        new_cache = (ck_all, cv_all)
        o = per_head(lambda q, k, v: _decode_attention(q, k, v, cache_index,
                                                       pdt),
                     q, ck_all[layer_index], cv_all[layer_index]).to(x.dtype)
        o = constrain(o, (BATCH, None, MODEL, None))
    elif kv_cache is not None:
        ck, cv = kv_cache
        ck, cv = ck.clone(), cv.clone()
        ck[:, cache_index:cache_index + S] = k.to(ck.dtype)
        cv[:, cache_index:cache_index + S] = v.to(cv.dtype)
        new_cache = (ck, cv)
        if S > 1:
            if cfg.attn_impl in ("qchunk", "flashref") and \
                    src.shape[1] <= 8192:
                attend = partial(qchunk_attention, causal=True,
                                 probs_dtype=pdt)
            else:
                attend = partial(blockwise_attention, causal=True,
                                 probs_dtype=pdt)
            o = per_head(attend, q, k, v)
        else:
            # decode: attend over the valid cache prefix only
            o = per_head(lambda q, k, v: _decode_attention(
                q, k, v, cache_index, pdt), q, ck, cv).to(x.dtype)
    else:
        masked = causal and context is None
        if cfg.attn_impl == "flash" and context is None:
            attend = partial(_flash_attention, causal=causal)
        elif S * src.shape[1] <= 256 * 256:
            attend = partial(reference_attention, causal=masked)
        elif cfg.attn_impl == "qchunk":
            attend = partial(qchunk_attention, causal=masked,
                             probs_dtype=pdt)
        elif cfg.attn_impl == "flashref":
            attend = partial(flashref_attention, causal=masked, q_block=512,
                             probs_dtype=pdt)
        else:
            attend = partial(blockwise_attention, causal=masked,
                             probs_dtype=pdt)
        o = per_head(attend, q, k, v)
        if return_kv:
            new_cache = (k, v)
    o = constrain(o, (BATCH, None, MODEL, None))
    out = merge_heads(o) @ p.wo
    if cfg.tp_bf16_reduce:
        out = out.to(torch.bfloat16)
    return out, new_cache


def head_template(kv_heads: int):
    """The template of a [B, S, heads, hd] q (or kernel operand) under the
    mesh: batch over the batch axes, heads over ``model`` only when
    ``kv_heads`` divides by it, so that each rank's q heads meet their own
    KV group (GQA); otherwise heads replicated and the batch sharded
    alone.  The reference shards q heads whenever H divides (ROADMAP
    D-entry on the GQA rule)."""
    heads = MODEL if kv_heads % shd.axis_size("model") == 0 else None
    return (BATCH, None, heads, None)


def per_head(attend, q, k, v):
    """``attend(q, k, v)`` -> o [B, Sq, H, hd], an attention that mixes
    nothing across batch rows or KV groups.  Under a mesh it runs through
    ``local_map`` on each rank's shard of batch and heads
    (``head_template``), so a hand kernel launches on local tensors
    (DTensor has no sharding rule for a custom extension) and the plain
    forms skip DTensor's per-op dispatch (torch 2.11 has no rule for
    their einsums' merged views either).  Gradients stay per shard: a
    replicated dimension's ranks compute the same values."""
    mesh = shd.get_mesh()
    if mesh is None or not shd.is_dtensor(q):
        return attend(q, k, v)
    tpl = head_template(k.shape[2])
    pq = shd.fitted_sharding(q.shape, tpl).placements
    pkv = shd.fitted_sharding(k.shape, tpl).placements
    return shd.local_map(attend, out_placements=list(pq),
                         in_placements=(pq, pkv, pkv), device_mesh=mesh,
                         redistribute_inputs=True)(q, k, v)


def _flash_attention(q, k, v, causal):
    """``fa_ops.flash_attention`` (K2, and K3/K4 through its
    ``autograd.Function``).  A rank's shard (``per_head``) that is a
    strided view is copied to dense rows first, so the kernels' 16-byte
    rows and 8-element strides hold (``_mma_layout_error``); a whole
    tensor is contiguous already and passes as it is."""
    q, k, v = (t if t.is_contiguous() else t.contiguous() for t in (q, k, v))
    return fa_ops.flash_attention(q, k, v, causal=causal)


# ---------------------------------------------------------------------------
# MLP (SwiGLU) and MoE
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, d_model, d_ff, dtype, device, generator):
        super().__init__()
        self.w_gate = dense_init((d_model, d_ff), dtype, device, generator)
        self.w_up = dense_init((d_model, d_ff), dtype, device, generator)
        self.w_down = dense_init((d_ff, d_model), dtype, device, generator)


def mlp_block(p, x, cfg=None):
    h = F.silu(x @ p.w_gate) * (x @ p.w_up)
    h = constrain(h, (BATCH, None, MODEL))
    y = h @ p.w_down
    if cfg is not None and cfg.tp_bf16_reduce:
        y = y.to(torch.bfloat16)
    return y


class MoE(nn.Module):
    """``router`` [D, E] (float32 whatever the parameter dtype),
    ``we_gate``/``we_up`` [E, D, Fe], ``we_down`` [E, Fe, D] and, where the
    config has shared experts, a ``shared`` SwiGLU MLP of width
    Fe * ``moe_shared_experts`` (the reference's ``init_moe``)."""

    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        D = cfg.d_model
        E, Fe = cfg.moe_experts, cfg.moe_d_ff or cfg.d_ff
        self.router = dense_init((D, E), torch.float32, device, generator)
        self.we_gate = dense_init((E, D, Fe), dtype, device, generator)
        self.we_up = dense_init((E, D, Fe), dtype, device, generator)
        self.we_down = dense_init((E, Fe, D), dtype, device, generator)
        if cfg.moe_shared_experts:
            self.shared = MLP(D, Fe * cfg.moe_shared_experts, dtype, device,
                              generator)


def moe_capacity(cfg, T: int, capacity_factor: float = 1.25) -> int:
    """Tokens each expert takes at most: max(1, int(cf * K * T / E))."""
    return max(1, int(capacity_factor * cfg.moe_topk * T / cfg.moe_experts))


def _route(probs, K: int, C: int, e_base: int, E_loc: int) -> dict:
    """The dispatch of tokens with router probabilities ``probs`` [T, E]
    to the experts [e_base, e_base + E_loc), each taking at most C: the
    top-k ``gates`` (renormalized) and picks ``idx`` [T, K]; the T*K
    routed rows in stable (expert, token) ``order``; ``keep`` (an expert
    of the range, within its capacity) and ``slot`` (local expert * C +
    rank, or E_loc * C, the dump row).  With e_base = 0 and E_loc = E
    every expert is in range: the global path."""
    T = probs.shape[0]
    gates, idx = torch.topk(probs, K, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # rank of each routed token within its expert
    pos = torch.arange(T * K, device=probs.device) - torch.searchsorted(
        sorted_e, sorted_e, side="left")
    local_e = sorted_e - e_base
    keep = (pos < C) & (local_e >= 0) & (local_e < E_loc)
    slot = torch.where(keep, local_e * C + pos, E_loc * C)
    return {"probs": probs, "gates": gates, "idx": idx, "capacity": C,
            "order": order, "keep": keep, "slot": slot}


def _route_whole(probs, K: int, C: int, e_base: int, E_loc: int) -> dict:
    """``_route``; under the mesh every rank routes all T tokens on the
    whole, replicated ``probs`` (``local_map``): DTensor has no sharding
    rule for ``searchsorted``, and GSPMD replicates the reference's sort
    of a sharded dim too."""
    if not shd.is_dtensor(probs):
        return _route(probs, K, C, e_base, E_loc)
    keys = ("gates", "idx", "order", "keep", "slot")
    mesh = probs.device_mesh
    whole = (shd.Replicate(),) * mesh.ndim

    def local(pr):
        r = _route(pr, K, C, e_base, E_loc)
        return tuple(r[k] for k in keys)
    out = shd.local_map(local, out_placements=(whole,) * len(keys),
                        in_placements=(whole,), device_mesh=mesh,
                        redistribute_inputs=True)(probs)
    return {"probs": probs, "capacity": C, **dict(zip(keys, out))}


def moe_route(p, cfg, xt, capacity_factor: float = 1.25) -> dict:
    """The global path's routing of tokens ``xt`` [T, D] (``_route`` over
    all E experts): the float32 softmax ``probs`` of the router logits,
    gates, picks, order, keep and slot, with the capacity
    ``moe_capacity``."""
    probs = torch.softmax(xt.float() @ p.router, dim=-1)
    return _route(probs, cfg.moe_topk,
                  moe_capacity(cfg, xt.shape[0], capacity_factor), 0,
                  cfg.moe_experts)


def _moe_dispatch_compute(xt, probs, wg, wu, wd, K, C, e_base):
    """Sort-based dispatch and expert FFN of tokens ``xt`` [T, D] for the
    experts [e_base, e_base + E_loc) whose weights ``wg``/``wu``/``wd``
    [E_loc, ...] are given (``_route``); a routed row of another expert,
    or past its capacity, goes to the dump row and contributes nothing.
    Returns y [T, D], each token's rows summed in its own pick order
    (D36)."""
    T, D = xt.shape
    E_loc = wg.shape[0]
    r = _route_whole(probs, K, C, e_base, E_loc)
    order, keep, slot = r["order"], r["keep"], r["slot"]
    buf = torch.zeros((E_loc * C + 1, D), dtype=xt.dtype, device=xt.device)
    buf = buf.index_put((slot,), xt[order // K])   # duplicates: dump row only
    ex_in = constrain(buf[:-1].reshape(E_loc, C, D), (MODEL, None, None))
    h = F.silu(torch.bmm(ex_in, wg)) * torch.bmm(ex_in, wu)
    ex_out = constrain(torch.bmm(h, wd), (MODEL, None, None))
    flat_out = shd.grad_as_placed(ex_out.reshape(E_loc * C, D))
    routed = torch.where(keep[:, None],
                         flat_out[torch.clamp(slot, 0, E_loc * C - 1)],
                         torch.zeros((), dtype=xt.dtype, device=xt.device))
    g = r["gates"].reshape(-1)[order][:, None].to(xt.dtype)
    # back to (token, pick) order, then a fixed-order sum over the picks
    picks = (routed * g)[torch.argsort(order)].reshape(T, K, D)
    y = picks[:, 0]
    for k in range(1, K):
        y = y + picks[:, k]
    return y


def moe_local_dispatch(p, cfg, xt, probs, capacity_factor: float = 1.25):
    """Expert-parallel dispatch under the mesh (the reference's
    ``_moe_local_dispatch``, its ``moe_local`` optimisation).

    Activations are replicated along the ``model`` axis, so every
    expert-owner rank dispatches its own ``E / ep`` experts' tokens
    locally, from ``e_base = rank_in_model * E_loc``, with the capacity of
    its data shard, ``C = max(1, int(cf * K * T_loc / E))``; the only
    communication is one all-reduce of the combined output over ``model``
    (``sharding.psum``)."""
    mesh = shd.get_mesh()
    names = mesh.mesh_dim_names
    model_dim = names.index("model")
    E, K = cfg.moe_experts, cfg.moe_topk
    ep = mesh.size(model_dim)
    if E % ep:
        raise ValueError(f"moe_local_dispatch: {E} experts do not divide "
                         f"over a {ep}-way model axis")
    E_loc = E // ep
    rows = shd.resolve((BATCH, None))
    dp = 1
    for i, pl in enumerate(rows):
        if pl != shd.Replicate():
            dp *= mesh.size(i)
    C = max(1, int(capacity_factor * K * (xt.shape[0] // dp) / E))
    experts = shd.resolve((MODEL, None, None))
    # gradients: a token's comes from every expert owner (summed over
    # ``model``); an expert's from every data shard's tokens
    rows_grad = tuple(shd.Partial() if i == model_dim else pl
                      for i, pl in enumerate(rows))
    experts_grad = tuple(shd.Partial() if pl == shd.Replicate() else pl
                         for pl in experts)

    def local(xt_l, probs_l, wg, wu, wd):
        e_base = mesh.get_local_rank("model") * E_loc
        y = _moe_dispatch_compute(xt_l, probs_l, wg, wu, wd, K, C, e_base)
        return shd.psum(y, "model")
    return shd.local_map(
        local, out_placements=list(rows),
        in_placements=(rows, rows, experts, experts, experts),
        in_grad_placements=(rows_grad, rows_grad, experts_grad,
                            experts_grad, experts_grad),
        device_mesh=mesh, redistribute_inputs=True)(
            xt, probs, p.we_gate, p.we_up, p.we_down)


def moe_block(p, cfg, x, capacity_factor: float = 1.25):
    """Sort-based top-k MoE dispatch with the fixed capacity
    ``C = max(1, int(capacity_factor * K * T / E))``; returns (y, aux).

    The reference's global path (``moe_route``): tokens go to their top-k
    experts in (expert, token) order, each expert takes at most C of them
    and the overflow goes to a dump row that is discarded; the grouped
    expert products are batched matmuls.  With ``cfg.moe_local_dispatch``
    under a mesh the same dispatch runs expert-parallel
    (``moe_local_dispatch``); without a mesh the reference takes the
    global path too.

    Nothing depends on values (no ``.item()``, masks or bincount), so a
    step captures over meta tensors.  The combine is deterministic: each
    token gathers its K routed rows in its own pick order and sums them
    k = 0, 1, ..., K-1 (ROADMAP D36); the reference scatter-adds them in
    (expert, token) order.  The aux loss is Switch's, E * sum(me * pe),
    on both paths: me the one-hot mean of each token's top-1 pick, pe the
    mean router probability."""
    B, S, D = x.shape
    E, K = cfg.moe_experts, cfg.moe_topk
    T = B * S
    xt = x.reshape(T, D)
    probs = torch.softmax(xt.float() @ p.router, dim=-1)
    if cfg.moe_local_dispatch and shd.get_mesh() is not None:
        y = moe_local_dispatch(p, cfg, xt, probs, capacity_factor)
    else:
        y = _moe_dispatch_compute(xt, probs, p.we_gate, p.we_up, p.we_down,
                                  K, moe_capacity(cfg, T, capacity_factor),
                                  0)
    y = y.reshape(B, S, D)
    if hasattr(p, "shared"):
        y = y + mlp_block(p.shared, x)
    # load-balancing auxiliary loss (Switch-style)
    top1 = torch.argmax(probs, dim=-1)
    me = (top1[:, None] == torch.arange(E, device=x.device)).float().mean(0)
    return y, E * torch.sum(me * probs.mean(0))
