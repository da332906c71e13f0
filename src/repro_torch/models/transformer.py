"""Decoder-only transformer LM, dense family (TinyLlama-style).

The reference runs the layer stack under ``lax.scan`` over stacked
parameters; here the layers are an ``nn.ModuleList`` walked in a loop, and
``cfg.remat`` wraps each layer in ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` on the scan body): its activations are
recomputed in the backward pass, so with ``attn_impl="flash"`` each layer
runs the forward kernel twice and each backward kernel once.  The loss is
vocab-chunked cross-entropy over ``loss_chunk``-token chunks, so the
``tokens x vocab`` logits are never held at once.

The MoE branch (``moe_block``, ``dense_layers``), the VLM stub
(``vision_proj``), ``save_proj_remat`` and ``decode_inplace`` are not
ported yet and raise (ROADMAP A9).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP A9)")


class DenseLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype, device, generator):
        super().__init__()
        D = cfg.d_model
        self.ln1 = L.ones((D,), dtype, device)
        self.ln2 = L.ones((D,), dtype, device)
        self.attn = L.Attention(cfg, dtype, device, generator)
        self.mlp = L.MLP(D, cfg.d_ff, dtype, device, generator)


class TransformerLM(nn.Module):
    """``embed`` [V, D], ``layers[i]`` (``ln1``, ``ln2``, ``attn``,
    ``mlp``), ``ln_f`` and ``unembed`` [D, V], as the reference's
    ``init_lm`` lays them out (its stacked ``layers/<name>`` leaves are
    ``layers[i].<name>`` here)."""

    def __init__(self, cfg: ArchConfig, device, generator):
        super().__init__()
        if cfg.moe_experts:
            raise _not_ported("the MoE transformer")
        if cfg.vision_tokens:
            raise _not_ported("the VLM transformer")
        dtype = getattr(torch, cfg.param_dtype)
        D, V = cfg.d_model, cfg.vocab
        self.cfg = cfg
        self.embed = L.dense_init((V, D), dtype, device, generator,
                                  scale=0.02)
        self.layers = nn.ModuleList(
            DenseLayer(cfg, dtype, device, generator)
            for _ in range(cfg.n_layers))
        self.ln_f = L.ones((D,), dtype, device)
        if not cfg.tie_embeddings:
            self.unembed = L.dense_init((D, V), dtype, device, generator,
                                        scale=0.02)

    def forward(self, tokens, kv_caches=None, cache_index=None):
        """Returns (hidden [B, S, D], new_kv_caches, aux_loss)."""
        cfg = self.cfg
        if cfg.decode_inplace and kv_caches is not None and \
                tokens.shape[1] == 1:
            raise _not_ported("the decode_inplace stacked-cache branch")
        S = tokens.shape[1]
        x = F.embedding(tokens, self.embed)
        positions = torch.arange(S, device=tokens.device)
        if cache_index is not None:
            positions = positions + cache_index
        inv_freqs = L.rope_freqs(cfg.hd, cfg.rope_fraction,
                                 device=tokens.device)
        remat = cfg.remat and kv_caches is None and torch.is_grad_enabled()
        if remat and cfg.save_proj_remat:
            raise _not_ported("the save_proj_remat checkpoint policy")
        new_k, new_v = [], []
        for i, layer in enumerate(self.layers):
            if remat:
                x = checkpoint(_layer_hidden, cfg, inv_freqs, layer, x,
                               positions, use_reentrant=False)
                continue
            kv = None if kv_caches is None else (kv_caches["main"][0][i],
                                                 kv_caches["main"][1][i])
            x, kv = _layer_apply(cfg, inv_freqs, layer, x, positions, kv,
                                 cache_index)
            if kv is not None:
                new_k.append(kv[0])
                new_v.append(kv[1])
        x = L.apply_norm(cfg.norm, x, self.ln_f)
        new_caches = None
        if kv_caches is not None:
            new_caches = {"main": (torch.stack(new_k), torch.stack(new_v))}
        return x, new_caches, 0.0


def _layer_apply(cfg, inv_freqs, p, x, positions, kv=None, cache_index=None):
    h, new_kv = L.attention_block(
        p.attn, cfg, L.apply_norm(cfg.norm, x, p.ln1), positions=positions,
        causal=True, kv_cache=kv, cache_index=cache_index,
        inv_freqs=inv_freqs)
    x = x + h
    y = L.mlp_block(p.mlp, L.apply_norm(cfg.norm, x, p.ln2), cfg)
    return x + y, new_kv


def _layer_hidden(cfg, inv_freqs, p, x, positions):
    return _layer_apply(cfg, inv_freqs, p, x, positions)[0]


def unembed_matrix(model, cfg):
    if cfg.tie_embeddings:
        return model.embed.T
    return model.unembed


def chunked_ce_loss(model, cfg: ArchConfig, hidden, labels, mask=None):
    """Mean cross entropy over vocab, in ``loss_chunk``-token chunks (the
    last one the remainder).  hidden: [B, S, D]; labels: [B, S].  The label
    logit is gathered (no tensor parallelism here to need the reference's
    one-hot reduction); each chunk's logits are float32."""
    B, S, D = hidden.shape
    h = hidden.reshape(B * S, D)
    y = labels.reshape(B * S)
    m = (torch.ones(y.shape, dtype=torch.float32, device=y.device)
         if mask is None else mask.reshape(B * S).float())
    W = unembed_matrix(model, cfg)
    C = min(cfg.loss_chunk, h.shape[0])
    n_chunks = h.shape[0] // C

    def chunk_loss(hc, yc, mc):
        logits = (hc @ W).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(1, yc[:, None])[:, 0]
        return ((lse - gold) * mc).sum(), mc.sum()

    def run(hc, yc, mc):
        if cfg.ce_recompute and torch.is_grad_enabled():
            # recompute the chunk's float32 logits in the backward pass
            return checkpoint(chunk_loss, hc, yc, mc, use_reentrant=False)
        return chunk_loss(hc, yc, mc)

    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n_chunks):
        sl = slice(i * C, (i + 1) * C)
        l, n = run(h[sl], y[sl], m[sl])
        tot, cnt = tot + l, cnt + n
    if n_chunks * C < h.shape[0]:
        sl = slice(n_chunks * C, None)
        l, n = run(h[sl], y[sl], m[sl])
        tot, cnt = tot + l, cnt + n
    return tot / torch.clamp_min(cnt, 1.0)


def loss_fn(model: TransformerLM, batch):
    hidden, _, aux = model(batch["tokens"])
    loss = chunked_ce_loss(model, model.cfg, hidden, batch["labels"])
    return loss + 0.01 * aux


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: ArchConfig, batch: int, max_seq: int, device,
                  dtype=torch.bfloat16):
    shape = (cfg.n_layers, batch, max_seq, cfg.kv_heads, cfg.hd)
    return {"main": (torch.zeros(shape, dtype=dtype, device=device),
                     torch.zeros(shape, dtype=dtype, device=device))}


@torch.no_grad()
def prefill(model: TransformerLM, tokens):
    """Full forward writing k/v into a fresh cache at index 0; returns
    (last-position logits, kv_cache)."""
    B, S = tokens.shape
    cache = init_kv_cache(model.cfg, B, S, tokens.device)
    hidden, new_cache, _ = model(tokens, kv_caches=cache, cache_index=0)
    return hidden[:, -1] @ unembed_matrix(model, model.cfg), new_cache


@torch.no_grad()
def decode_step(model: TransformerLM, cache, token, index):
    """One decode step: token [B] at absolute position ``index``."""
    hidden, new_cache, _ = model(token[:, None], kv_caches=cache,
                                 cache_index=index)
    return hidden[:, -1] @ unembed_matrix(model, model.cfg), new_cache
