"""Zamba2-style hybrid: Mamba-2 backbone + one *shared* attention block.

The shared attention(+MLP) block's parameters are reused at every
application point (every ``attn_every`` Mamba blocks), Zamba's signature
parameter-sharing trick.  Each application point still has its own KV cache
(the activations differ even though the weights are shared).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M


def n_attn_apps(cfg: ArchConfig) -> int:
    return cfg.n_layers // cfg.attn_every


class SharedBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype, device, generator):
        super().__init__()
        D = cfg.d_model
        self.ln1 = L.ones((D,), dtype, device)
        self.attn = L.Attention(cfg, dtype, device, generator)
        self.ln2 = L.ones((D,), dtype, device)
        self.mlp = L.MLP(D, cfg.d_ff, dtype, device, generator)


class HybridLM(nn.Module):
    def __init__(self, cfg: ArchConfig, device, generator):
        super().__init__()
        dtype = getattr(torch, cfg.param_dtype)
        D, V = cfg.d_model, cfg.vocab
        self.cfg = cfg
        self.embed = L.dense_init((V, D), dtype, device, generator,
                                  scale=0.02)
        self.layers = nn.ModuleList(
            M.MambaBlock(cfg, dtype, device, generator)
            for _ in range(cfg.n_layers))
        self.shared = SharedBlock(cfg, dtype, device, generator)
        self.ln_f = L.ones((D,), dtype, device)
        self.unembed = L.dense_init((D, V), dtype, device, generator,
                                    scale=0.02)

    def forward(self, tokens, cache=None, cache_index=None):
        cfg = self.cfg
        S = tokens.shape[1]
        x = self.embed[tokens]
        A, G = cfg.attn_every, n_attn_apps(cfg)
        positions = torch.arange(S, device=tokens.device)
        if cache_index is not None:
            positions = positions + cache_index
        ssm_n, conv_n, k_n, v_n = [], [], [], []
        for g in range(G):
            x, ns, ncv = M.run_blocks(self.layers[g * A:(g + 1) * A], cfg,
                                      x, cache, g * A)
            kv = None if cache is None else (cache["attn_k"][g],
                                             cache["attn_v"][g])
            x, new_kv = _shared_attn(self, cfg, x, positions, kv,
                                     cache_index)
            ssm_n += ns
            conv_n += ncv
            if new_kv is not None:
                k_n.append(new_kv[0])
                v_n.append(new_kv[1])
        # trailing mamba layers (if n_layers % attn_every != 0)
        if G * A < cfg.n_layers:
            x, ns, ncv = M.run_blocks(self.layers[G * A:], cfg, x, cache,
                                      G * A)
            ssm_n += ns
            conv_n += ncv
        new_cache = None
        if cache is not None:
            new_cache = {"ssm": torch.stack(ssm_n),
                         "conv": torch.stack(conv_n),
                         "attn_k": torch.stack(k_n),
                         "attn_v": torch.stack(v_n)}
        return L.apply_norm(cfg.norm, x, self.ln_f), new_cache


def _shared_attn(model, cfg, x, positions, kv=None, cache_index=None):
    sp = model.shared
    inv = L.rope_freqs(cfg.hd, cfg.rope_fraction, device=x.device)
    h, new_kv = L.attention_block(
        sp.attn, cfg, L.apply_norm(cfg.norm, x, sp.ln1),
        positions=positions, causal=True, kv_cache=kv,
        cache_index=cache_index, inv_freqs=inv)
    x = x + h
    x = x + L.mlp_block(sp.mlp, L.apply_norm(cfg.norm, x, sp.ln2))
    return x, new_kv


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device):
    c = M.init_ssm_cache(cfg, cfg.n_layers, batch, device)
    G = n_attn_apps(cfg)
    shape = (G, batch, max_seq, cfg.kv_heads, cfg.hd)
    c["attn_k"] = torch.zeros(shape, dtype=torch.bfloat16, device=device)
    c["attn_v"] = torch.zeros(shape, dtype=torch.bfloat16, device=device)
    return c


@torch.no_grad()
def prefill(model: HybridLM, tokens):
    """Logits of the last position and a *zero* cache sized to the tokens,
    as the reference returns (ROADMAP Queue C records this)."""
    from repro_torch.models.transformer import unembed_matrix
    B, S = tokens.shape
    cache = init_cache(model.cfg, B, S, tokens.device)
    hidden, _ = model(tokens)
    logits = hidden[:, -1] @ unembed_matrix(model, model.cfg)
    return logits, cache


@torch.no_grad()
def decode_step(model: HybridLM, cache, token, index):
    from repro_torch.models.transformer import unembed_matrix
    hidden, new_cache = model(token[:, None], cache=cache,
                              cache_index=index)
    logits = hidden[:, -1] @ unembed_matrix(model, model.cfg)
    return logits, new_cache
