"""Decoder-only transformer LM: the dense, MoE and VLM families.

The reference runs the layer stack under ``lax.scan`` over stacked
parameters; here the layers are an ``nn.ModuleList`` walked in a loop, and
``cfg.remat`` wraps each layer in ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` on the scan body): its activations are
recomputed in the backward pass, so with ``attn_impl="flash"`` each layer
runs the forward kernel twice and each backward kernel once.  The loss is
vocab-chunked cross-entropy over ``loss_chunk``-token chunks, so the
``tokens x vocab`` logits are never held at once.

MoE configs (``moe_experts``) have ``moe_first_dense`` dense layers in
``dense_layers`` before the MoE layers in ``layers``; each MoE layer adds
its load-balancing loss to the forward's ``aux``.  VLM configs
(``vision_tokens``) project the stub patch embeddings through
``vision_proj`` and prepend them to the token embeddings.

``save_proj_remat`` keeps, per layer, the outputs of the products by the
attention's ``wo`` and the MLP's ``w_down`` (the reference's values named
``proj_out``) and recomputes the rest: a selective checkpoint whose policy
finds those two products by their weights.  ``decode_inplace`` writes each
decode step's k/v into the caller's stacked cache in place and returns the
same tensors (the reference donates the stack to a jitted step).
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import BATCH, constrain
from repro_torch.models import layers as L


class DenseLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype, device, generator):
        super().__init__()
        D = cfg.d_model
        self.ln1 = L.ones((D,), dtype, device)
        self.ln2 = L.ones((D,), dtype, device)
        self.attn = L.Attention(cfg, dtype, device, generator)
        self.mlp = L.MLP(D, cfg.d_ff, dtype, device, generator)


class MoELayer(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype, device, generator):
        super().__init__()
        D = cfg.d_model
        self.ln1 = L.ones((D,), dtype, device)
        self.ln2 = L.ones((D,), dtype, device)
        self.attn = L.Attention(cfg, dtype, device, generator)
        self.moe = L.MoE(cfg, dtype, device, generator)


def n_dense_layers(cfg: ArchConfig) -> int:
    return cfg.moe_first_dense if cfg.moe_experts else 0


class TransformerLM(nn.Module):
    """``embed`` [V, D], ``dense_layers[i]`` (MoE configs' leading dense
    layers), ``layers[i]`` (``ln1``, ``ln2``, ``attn`` and ``mlp`` or
    ``moe``), ``ln_f``, ``unembed`` [D, V] and ``vision_proj`` [D, D], as
    the reference's ``init_lm`` lays them out (its stacked
    ``layers/<name>`` leaves are ``layers[i].<name>`` here)."""

    def __init__(self, cfg: ArchConfig, device, generator):
        super().__init__()
        dtype = getattr(torch, cfg.param_dtype)
        D, V = cfg.d_model, cfg.vocab
        n_dense = n_dense_layers(cfg)
        main = MoELayer if cfg.moe_experts else DenseLayer
        self.cfg = cfg
        self.embed = L.dense_init((V, D), dtype, device, generator,
                                  scale=0.02)
        if n_dense:
            self.dense_layers = nn.ModuleList(
                DenseLayer(cfg, dtype, device, generator)
                for _ in range(n_dense))
        self.layers = nn.ModuleList(
            main(cfg, dtype, device, generator)
            for _ in range(cfg.n_layers - n_dense))
        self.ln_f = L.ones((D,), dtype, device)
        if not cfg.tie_embeddings:
            self.unembed = L.dense_init((D, V), dtype, device, generator,
                                        scale=0.02)
        if cfg.vision_tokens:
            self.vision_proj = L.dense_init((D, D), dtype, device,
                                            generator)

    def forward(self, tokens, extra_embeds=None, kv_caches=None,
                cache_index=None):
        """Returns (hidden [B, S, D], new_kv_caches, aux_loss); with
        ``extra_embeds`` [B, Sv, D] the hidden states cover the Sv vision
        positions first, then the tokens."""
        cfg = self.cfg
        inplace = (cfg.decode_inplace and kv_caches is not None and
                   tokens.shape[1] == 1 and extra_embeds is None)
        x = F.embedding(tokens, self.embed)
        if extra_embeds is not None:
            dt = torch.promote_types(extra_embeds.dtype,
                                     self.vision_proj.dtype)
            ve = extra_embeds.to(dt) @ self.vision_proj.to(dt)
            x = torch.cat([ve.to(x.dtype), x], dim=1)
        x = constrain(x, (BATCH, None, None))
        S = x.shape[1]
        positions = torch.arange(S, device=tokens.device)
        if cache_index is not None:
            positions = positions + cache_index
        inv_freqs = L.rope_freqs(cfg.hd, cfg.rope_fraction,
                                 device=tokens.device)
        remat = cfg.remat and kv_caches is None and torch.is_grad_enabled()
        aux = 0.0
        new_kv = {}
        stacks = [("main", self.layers)]
        if hasattr(self, "dense_layers"):
            stacks.insert(0, ("dense", self.dense_layers))
        for name, stack in stacks:
            caches = None if kv_caches is None else kv_caches[name]
            new_k, new_v = [], []
            for i, layer in enumerate(stack):
                if remat:
                    sac = {}
                    if cfg.save_proj_remat:
                        sac["context_fn"] = partial(
                            create_selective_checkpoint_contexts,
                            save_proj_policy(layer))
                    x, aux_l = checkpoint(_layer_hidden, cfg, inv_freqs,
                                          layer, x, positions,
                                          use_reentrant=False, **sac)
                elif inplace:
                    x, _, aux_l = _layer_apply(
                        cfg, inv_freqs, layer, x, positions,
                        cache_index=cache_index, stacked=caches,
                        layer_index=i)
                else:
                    kv = None if caches is None else (caches[0][i],
                                                      caches[1][i])
                    x, kv, aux_l = _layer_apply(cfg, inv_freqs, layer, x,
                                                positions, kv, cache_index)
                    if kv is not None:
                        new_k.append(kv[0])
                        new_v.append(kv[1])
                aux = aux + aux_l
            if inplace:
                new_kv[name] = caches
            elif caches is not None:
                new_kv[name] = (torch.stack(new_k), torch.stack(new_v))
        x = L.apply_norm(cfg.norm, x, self.ln_f)
        return x, (new_kv if kv_caches is not None else None), aux


def _layer_apply(cfg, inv_freqs, p, x, positions, kv=None, cache_index=None,
                 stacked=None, layer_index=None):
    h, new_kv = L.attention_block(
        p.attn, cfg, L.apply_norm(cfg.norm, x, p.ln1), positions=positions,
        causal=True, kv_cache=kv, cache_index=cache_index,
        inv_freqs=inv_freqs, stacked_cache=stacked, layer_index=layer_index)
    x = x + h
    xn = L.apply_norm(cfg.norm, x, p.ln2)
    if hasattr(p, "moe"):
        y, aux = L.moe_block(p.moe, cfg, xn)
    else:
        y, aux = L.mlp_block(p.mlp, xn, cfg), 0.0
    return x + y, new_kv, aux


def _layer_hidden(cfg, inv_freqs, p, x, positions):
    x, _, aux = _layer_apply(cfg, inv_freqs, p, x, positions)
    return x, aux


def proj_weights(layer) -> tuple:
    """The weights whose products the reference names ``proj_out``: the
    attention's ``wo``, the MLP's ``w_down`` and, in a MoE layer, the
    shared experts' ``w_down`` (the routed experts' are not named)."""
    ws = [layer.attn.wo]
    if hasattr(layer, "mlp"):
        ws.append(layer.mlp.w_down)
    elif hasattr(layer.moe, "shared"):
        ws.append(layer.moe.shared.w_down)
    return tuple(ws)


def save_proj_policy(layer):
    """The reference's ``save_only_these_names("proj_out")`` for one layer:
    save the output of every ``mm`` by one of ``proj_weights(layer)``,
    recompute everything else."""
    keep = {id(w) for w in proj_weights(layer)}

    def policy(ctx, func, *args, **kwargs):
        if func is torch.ops.aten.mm.default and id(args[1]) in keep:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy



def unembed_matrix(model, cfg):
    if cfg.tie_embeddings:
        return model.embed.T
    return model.unembed


def chunked_ce_loss(model, cfg: ArchConfig, hidden, labels, mask=None):
    """Mean cross entropy over vocab, in ``loss_chunk``-token chunks (the
    last one the remainder).  hidden: [B, S, D]; labels: [B, S].  The label
    logit is gathered; under a mesh, where the logits are split over the
    vocab, it is recovered with the reference's one-hot reduction instead
    (DTensor's gather on a sharded dim needs the whole row).  Each chunk's
    logits are float32."""
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
        if shd.is_dtensor(logits):
            onehot = yc[:, None] == torch.arange(logits.shape[1],
                                                 device=yc.device)
            gold = torch.sum(logits * onehot, dim=-1)
        else:
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
    extra = batch.get("vision")
    hidden, _, aux = model(batch["tokens"], extra_embeds=extra)
    if extra is not None:
        hidden = hidden[:, extra.shape[1]:]   # loss on text positions only
    loss = chunked_ce_loss(model, model.cfg, hidden, batch["labels"])
    return loss + 0.01 * aux


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: ArchConfig, batch: int, max_seq: int, device,
                  dtype=torch.bfloat16):
    """``{"main": (k, v)}`` of [n_layers, batch, max_seq, KV, hd], and
    ``"dense"`` for an MoE config's leading dense layers."""
    n_dense = n_dense_layers(cfg)

    def mk(n):
        shape = (n, batch, max_seq, cfg.kv_heads, cfg.hd)
        return tuple(shd.place_cache(torch.zeros(shape, dtype=dtype,
                                                 device=device))
                     for _ in range(2))
    cache = {"main": mk(cfg.n_layers - n_dense)}
    if n_dense:
        cache["dense"] = mk(n_dense)
    return cache


@torch.no_grad()
def prefill(model: TransformerLM, tokens, extra_embeds=None):
    """Full forward writing k/v into a fresh cache at index 0, sized to the
    vision and text positions; returns (last-position logits, kv_cache)."""
    B, S = tokens.shape
    s_total = S + (extra_embeds.shape[1] if extra_embeds is not None else 0)
    cache = init_kv_cache(model.cfg, B, s_total, tokens.device)
    hidden, new_cache, _ = model(tokens, extra_embeds=extra_embeds,
                                 kv_caches=cache, cache_index=0)
    return hidden[:, -1] @ unembed_matrix(model, model.cfg), new_cache


@torch.no_grad()
def decode_step(model: TransformerLM, cache, token, index):
    """One decode step: token [B] at absolute position ``index``."""
    hidden, new_cache, _ = model(token[:, None], kv_caches=cache,
                                 cache_index=index)
    return hidden[:, -1] @ unembed_matrix(model, model.cfg), new_cache
