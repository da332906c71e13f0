"""Plain oracle for the flash-attention kernel (naive softmax attention)."""

from __future__ import annotations

import math

import torch


def attention_reference(q, k, v, *, causal=True):
    """q: [B, H, Sq, hd]; k/v: [B, KV, Skv, hd].  fp32 softmax math, GQA by
    reshaping q into [B, KV, G, Sq, hd]; the mask is top-left aligned
    (query i sees keys 0..i whatever Sq and Skv are)."""
    B, H, Sq, hd = q.shape
    _, KV, Skv, _ = k.shape
    G = H // KV
    qg = q.reshape(B, KV, G, Sq, hd).float()
    s = torch.einsum("bkgqh,bkph->bkgqp", qg, k.float()) / math.sqrt(hd)
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Skv, device=q.device)[None, :])
        s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqp,bkph->bkgqh", p, v.float())
    return o.reshape(B, H, Sq, hd).to(q.dtype)
