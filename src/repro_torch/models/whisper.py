"""Whisper-style encoder-decoder backbone (audio family).

The conv frontend is a stub, as in the reference: inputs are precomputed
mel-frame embeddings [B, enc_seq, D] (``batch_specs`` provides them), so
this module covers the transformer backbone only: a bidirectional encoder
and a causal decoder with cross-attention.  Learned positional embeddings,
LayerNorm (pre-norm), no RoPE.

The reference scans stacked layers; here ``enc_layers`` and ``dec_layers``
are ``nn.ModuleList``s walked in a loop, each layer under
``torch.utils.checkpoint`` when ``cfg.remat`` asks (and gradients are on).
With ``attn_impl="flash"`` the encoder's self-attention runs the
flash-attention kernels with ``causal=False`` and the cache-less decoder's
with ``causal=True``; cross-attention never does, as in the reference.
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import BATCH, constrain
from repro_torch.models import layers as L

MAX_DECODER_POS = 32768  # sized for the decode_32k assigned shape


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype, device, generator):
        super().__init__()
        D = cfg.d_model
        self.ln1 = L.ones((D,), dtype, device)
        self.attn = L.Attention(cfg, dtype, device, generator)
        self.ln2 = L.ones((D,), dtype, device)
        self.mlp = L.MLP(D, cfg.d_ff, dtype, device, generator)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype, device, generator):
        super().__init__()
        D = cfg.d_model
        self.ln1 = L.ones((D,), dtype, device)
        self.attn = L.Attention(cfg, dtype, device, generator)
        self.lnx = L.ones((D,), dtype, device)
        self.cross = L.Attention(cfg, dtype, device, generator)
        self.ln2 = L.ones((D,), dtype, device)
        self.mlp = L.MLP(D, cfg.d_ff, dtype, device, generator)


class WhisperLM(nn.Module):
    """``embed`` [V, D], ``enc_pos`` [enc_seq, D], ``dec_pos``
    [MAX_DECODER_POS, D], ``enc_layers[i]``, ``dec_layers[i]``, ``ln_enc``,
    ``ln_f`` and ``unembed`` [D, V], as the reference's ``init_lm`` lays
    them out."""

    def __init__(self, cfg: ArchConfig, device, generator):
        super().__init__()
        dtype = getattr(torch, cfg.param_dtype)
        D, V = cfg.d_model, cfg.vocab
        self.cfg = cfg
        self.embed = L.dense_init((V, D), dtype, device, generator,
                                  scale=0.02)
        self.enc_pos = L.dense_init((cfg.enc_seq, D), dtype, device,
                                    generator, scale=0.02)
        self.dec_pos = L.dense_init((MAX_DECODER_POS, D), dtype, device,
                                    generator, scale=0.02)
        self.enc_layers = nn.ModuleList(
            EncoderLayer(cfg, dtype, device, generator)
            for _ in range(cfg.enc_layers))
        self.dec_layers = nn.ModuleList(
            DecoderLayer(cfg, dtype, device, generator)
            for _ in range(cfg.n_layers))
        self.ln_enc = L.ones((D,), dtype, device)
        self.ln_f = L.ones((D,), dtype, device)
        self.unembed = L.dense_init((D, V), dtype, device, generator,
                                    scale=0.02)


def _remat(cfg) -> bool:
    return cfg.remat and torch.is_grad_enabled()


def _encoder_layer(cfg, p, x, positions):
    h, _ = L.attention_block(
        p.attn, cfg, L.apply_norm(cfg.norm, x, p.ln1), positions=positions,
        causal=False, inv_freqs=None)
    x = x + h
    return x + L.mlp_block(p.mlp, L.apply_norm(cfg.norm, x, p.ln2))


def encode(model: WhisperLM, frames):
    """frames: [B, enc_seq, D] stub embeddings -> encoder states."""
    cfg = model.cfg
    x = frames.to(getattr(torch, cfg.param_dtype)) + model.enc_pos
    x = constrain(x, (BATCH, None, None))
    positions = torch.arange(x.shape[1], device=x.device)
    for p in model.enc_layers:
        if _remat(cfg):
            x = checkpoint(_encoder_layer, cfg, p, x, positions,
                           use_reentrant=False)
        else:
            x = _encoder_layer(cfg, p, x, positions)
    return L.apply_norm(cfg.norm, x, model.ln_enc)


def _cross_attend(p, cfg, x, ck, cv):
    """Cross-attention against precomputed (cached) encoder k/v."""
    H, KV, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    q = L.split_heads(x @ p.wq, H, hd, KV)
    o = L.per_head(partial(_cross_scores, dtype=x.dtype), q, ck, cv)
    return L.merge_heads(o) @ p.wo


def _cross_scores(q, ck, cv, dtype):
    """[B, S, H, hd] attention of q over the whole encoder k/v."""
    B, S, H, hd = q.shape
    KV = ck.shape[2]
    if S * ck.shape[1] > 256 * 256:
        # long prefill: memory-bounded blockwise path
        return L.blockwise_attention(q, ck.to(q.dtype), cv.to(q.dtype),
                                     causal=False)
    qg = q.reshape(B, S, KV, H // KV, hd)
    s = torch.einsum("bqkgh,bpkh->bkgqp", qg.float(),
                     ck.float()) / math.sqrt(hd)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqp,bpkh->bkgqh", pr, cv.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(dtype)


def cross_kv(p, cfg, enc_out):
    B, Se, _ = enc_out.shape
    KV, hd = cfg.kv_heads, cfg.hd
    k = L.split_heads(enc_out @ p.wk, KV, hd)
    v = L.split_heads(enc_out @ p.wv, KV, hd)
    return k, v


def _decoder_layer(cfg, p, x, positions, enc_out):
    h, _ = L.attention_block(
        p.attn, cfg, L.apply_norm(cfg.norm, x, p.ln1), positions=positions,
        causal=True, inv_freqs=None)
    x = x + h
    ck, cv = cross_kv(p.cross, cfg, enc_out)
    x = x + _cross_attend(p.cross, cfg, L.apply_norm(cfg.norm, x, p.lnx),
                          ck, cv)
    return x + L.mlp_block(p.mlp, L.apply_norm(cfg.norm, x, p.ln2))


def decode(model: WhisperLM, tokens, enc_out, cache=None, cache_index=None):
    """Decoder states [B, S, D] and the updated cache (None without one).
    Without a cache the cross k/v come from ``enc_out``; with one, from
    ``cache["cross_k"]``/``["cross_v"]``, and the self-attention k/v are
    written at ``cache_index``."""
    cfg = model.cfg
    S = tokens.shape[1]
    x = F.embedding(tokens, model.embed)
    start = 0 if cache_index is None else cache_index
    x = constrain(x + model.dec_pos[start:start + S], (BATCH, None, None))
    positions = start + torch.arange(S, device=tokens.device)

    if cache is None:
        for p in model.dec_layers:
            if _remat(cfg):
                x = checkpoint(_decoder_layer, cfg, p, x, positions, enc_out,
                               use_reentrant=False)
            else:
                x = _decoder_layer(cfg, p, x, positions, enc_out)
        new_cache = None
    else:
        new_k, new_v = [], []
        for i, p in enumerate(model.dec_layers):
            h, (nk, nv) = L.attention_block(
                p.attn, cfg, L.apply_norm(cfg.norm, x, p.ln1),
                positions=positions, causal=True,
                kv_cache=(cache["k"][i], cache["v"][i]),
                cache_index=cache_index, inv_freqs=None)
            x = x + h
            x = x + _cross_attend(p.cross, cfg,
                                  L.apply_norm(cfg.norm, x, p.lnx),
                                  cache["cross_k"][i], cache["cross_v"][i])
            x = x + L.mlp_block(p.mlp, L.apply_norm(cfg.norm, x, p.ln2))
            new_k.append(nk)
            new_v.append(nv)
        new_cache = dict(cache, k=torch.stack(new_k), v=torch.stack(new_v))
    return L.apply_norm(cfg.norm, x, model.ln_f), new_cache


def loss_fn(model: WhisperLM, batch):
    from repro_torch.models.transformer import chunked_ce_loss
    enc_out = encode(model, batch["frames"])
    hidden, _ = decode(model, batch["tokens"], enc_out)
    return chunked_ce_loss(model, model.cfg, hidden, batch["labels"])


def init_cache(model: WhisperLM, enc_out, batch: int, max_seq: int):
    """Zero self-attention k/v [n_layers, batch, max_seq, KV, hd] and each
    decoder layer's cross k/v of ``enc_out``, all bf16."""
    cfg = model.cfg
    shape = (cfg.n_layers, batch, max_seq, cfg.kv_heads, cfg.hd)
    cross = [cross_kv(p.cross, cfg, enc_out) for p in model.dec_layers]
    dev = enc_out.device
    return {
        "k": shd.place_cache(torch.zeros(shape, dtype=torch.bfloat16,
                                         device=dev)),
        "v": shd.place_cache(torch.zeros(shape, dtype=torch.bfloat16,
                                         device=dev)),
        "cross_k": torch.stack([k for k, _ in cross]).to(torch.bfloat16),
        "cross_v": torch.stack([v for _, v in cross]).to(torch.bfloat16),
    }


@torch.no_grad()
def prefill(model: WhisperLM, tokens, frames):
    """Logits of the last position and a cache sized to the tokens whose
    self-attention k/v are *zero* (only the cross k/v are filled), as the
    reference returns (ROADMAP D37)."""
    from repro_torch.models.transformer import unembed_matrix
    B, S = tokens.shape
    enc_out = encode(model, frames)
    hidden, _ = decode(model, tokens, enc_out)
    cache = init_cache(model, enc_out, B, S)
    return hidden[:, -1] @ unembed_matrix(model, model.cfg), cache


@torch.no_grad()
def decode_step(model: WhisperLM, cache, token, index):
    from repro_torch.models.transformer import unembed_matrix
    hidden, new_cache = decode(model, token[:, None], None, cache=cache,
                               cache_index=index)
    return hidden[:, -1] @ unembed_matrix(model, model.cfg), new_cache
