"""Mamba-2 (SSD) blocks: attention-free LM + building block for hybrids.

Block layout follows the Mamba-2 paper: fused input projection producing
(z, x, B, C, dt), short causal depthwise conv over (x, B, C), SSD scan,
gated RMSNorm, output projection.  With ``cfg.attn_impl == "flash"`` (the
reference's flag for "kernels on") the prefill scan runs the SSD kernel,
otherwise the chunked plain form.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd
from repro_torch.models import layers as L

CONV_K = 4


def block_dims(cfg: ArchConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    n = cfg.ssm_state
    conv_dim = d_in + 2 * n
    proj_dim = 2 * d_in + 2 * n + nh
    return d_in, nh, n, conv_dim, proj_dim


class MambaBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype, device, generator):
        super().__init__()
        D = cfg.d_model
        d_in, nh, n, conv_dim, proj_dim = block_dims(cfg)
        f32 = torch.float32
        self.ln = L.ones((D,), dtype, device)
        self.in_proj = L.dense_init((D, proj_dim), dtype, device, generator)
        self.conv_w = L.dense_init((CONV_K, conv_dim), dtype, device,
                                   generator, scale=0.5)
        self.conv_b = L.zeros((conv_dim,), dtype, device)
        self.A_log = L.zeros((nh,), f32, device)
        self.D = L.ones((nh,), f32, device)
        self.dt_bias = L.zeros((nh,), f32, device)
        self.norm_g = L.ones((d_in,), dtype, device)
        self.out_proj = L.dense_init((d_in, D), dtype, device, generator)


def _split_proj(cfg, zxbcdt):
    d_in, nh, n, _, _ = block_dims(cfg)
    z = zxbcdt[..., :d_in]
    x = zxbcdt[..., d_in:2 * d_in]
    B = zxbcdt[..., 2 * d_in:2 * d_in + n]
    C = zxbcdt[..., 2 * d_in + n:2 * d_in + 2 * n]
    dt = zxbcdt[..., 2 * d_in + 2 * n:]
    return z, x, B, C, dt


def _causal_conv(xbc, w, b):
    """Depthwise causal conv over sequence. xbc: [B,S,C]; w: [K,C]."""
    K = w.shape[0]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * w[i] for i in range(K))
    return F.silu(out + b)


def mamba_block(p, cfg: ArchConfig, u, ssm_state=None, conv_state=None):
    """u: [B,S,D]. Prefill when states are None; decode otherwise.

    Decode: S == 1; conv_state: [B, K-1, conv_dim]; ssm_state [B,nh,hp,n].
    Returns (out, new_ssm_state, new_conv_state).
    """
    Bsz, S, _ = u.shape
    d_in, nh, n, _, _ = block_dims(cfg)
    hp = cfg.ssm_head_dim

    un = L.apply_norm(cfg.norm, u, p.ln)
    z, x, B, C, dt = _split_proj(cfg, un @ p.in_proj)
    xbc = torch.cat([x, B, C], dim=-1)

    new_conv = None
    if conv_state is not None:
        # roll the conv window: [B, K-1, conv_dim]
        window = torch.cat([conv_state, xbc], dim=1)
        new_conv = window[:, 1:]
        out = sum(window[:, i:i + 1, :] * p.conv_w[i] for i in range(CONV_K))
        xbc = F.silu(out + p.conv_b)
    else:
        xbc = _causal_conv(xbc, p.conv_w, p.conv_b)

    x = xbc[..., :d_in].reshape(Bsz, S, nh, hp)
    B_ssm = xbc[..., d_in:d_in + n]
    C_ssm = xbc[..., d_in + n:]
    dt = F.softplus(dt.float() + p.dt_bias)
    A = -torch.exp(p.A_log)

    new_ssm = None
    if ssm_state is not None:
        new_ssm, y = ssd.ssd_decode_step(
            ssm_state, x[:, 0], dt[:, 0], A, B_ssm[:, 0], C_ssm[:, 0],
            D=p.D)
        y = y[:, None]
    elif cfg.attn_impl == "flash":          # the reference's "kernels on"
        y = ssd_ops.ssd_scan(x, dt, A, B_ssm, C_ssm, D=p.D,
                             chunk=cfg.ssm_chunk)
    else:
        y = ssd.ssd_chunked(x, dt, A, B_ssm, C_ssm, D=p.D,
                            chunk=cfg.ssm_chunk)
    y = y.reshape(Bsz, S, d_in)
    y = L.rmsnorm(y * F.silu(z), p.norm_g)
    return u + y @ p.out_proj, new_ssm, new_conv


def init_ssm_cache(cfg: ArchConfig, n_layers: int, batch: int, device):
    d_in, nh, n, conv_dim, _ = block_dims(cfg)
    return {
        "ssm": torch.zeros((n_layers, batch, nh, cfg.ssm_head_dim, n),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((n_layers, batch, CONV_K - 1, conv_dim),
                            dtype=torch.bfloat16, device=device),
    }


def run_blocks(blocks, cfg, x, cache=None, layer0=0):
    """Run ``blocks`` (layers ``layer0``.. of the stack) over x; with a
    cache, also return the blocks' new (ssm, conv) states as lists."""
    if cache is None:
        for blk in blocks:
            x, _, _ = mamba_block(blk, cfg, x)
        return x, [], []
    ssm_n, conv_n = [], []
    for i, blk in enumerate(blocks):
        x, ns, ncv = mamba_block(blk, cfg, x,
                                 ssm_state=cache["ssm"][layer0 + i],
                                 conv_state=cache["conv"][layer0 + i])
        ssm_n.append(ns)
        conv_n.append(ncv)
    return x, ssm_n, conv_n


class MambaLM(nn.Module):
    """Pure-SSM LM (mamba2-130m)."""

    def __init__(self, cfg: ArchConfig, device, generator):
        super().__init__()
        dtype = getattr(torch, cfg.param_dtype)
        D, V = cfg.d_model, cfg.vocab
        self.cfg = cfg
        self.embed = L.dense_init((V, D), dtype, device, generator,
                                  scale=0.02)
        self.layers = nn.ModuleList(
            MambaBlock(cfg, dtype, device, generator)
            for _ in range(cfg.n_layers))
        self.ln_f = L.ones((D,), dtype, device)
        if not cfg.tie_embeddings:
            self.unembed = L.dense_init((D, V), dtype, device, generator,
                                        scale=0.02)

    def forward(self, tokens, cache=None):
        cfg = self.cfg
        x, ssm_n, conv_n = run_blocks(self.layers, cfg, self.embed[tokens],
                                      cache)
        new_cache = None if cache is None else {
            "ssm": torch.stack(ssm_n), "conv": torch.stack(conv_n)}
        return L.apply_norm(cfg.norm, x, self.ln_f), new_cache


@torch.no_grad()
def prefill(model: MambaLM, tokens):
    """Logits of the last position and a *zero* cache, as the reference
    returns (it leaves the exact post-prefill state to a later path;
    ROADMAP Queue C records this)."""
    from repro_torch.models.transformer import unembed_matrix
    hidden, _ = model(tokens)
    logits = hidden[:, -1] @ unembed_matrix(model, model.cfg)
    cache = init_ssm_cache(model.cfg, model.cfg.n_layers, tokens.shape[0],
                           tokens.device)
    return logits, cache


@torch.no_grad()
def decode_step(model: MambaLM, cache, token, index):
    from repro_torch.models.transformer import unembed_matrix
    hidden, new_cache = model(token[:, None], cache=cache)
    logits = hidden[:, -1] @ unembed_matrix(model, model.cfg)
    return logits, new_cache
