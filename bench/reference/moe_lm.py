"""Plain float32 reference of the MoE transformer language model as the
configuration states it (deepseek-moe, arXiv:2401.06066, as the port's
``configs/deepseek_moe_16b.py`` reads it), its training loss and AdamW.

Layers: ``moe_first_dense`` dense layers, then MoE layers.  Each layer:
x += Attn(RMSNorm(x)), then x += FFN(RMSNorm(x)); attention is causal,
multi-head, with rotary embeddings over the whole head; the dense FFN is a
SwiGLU of width ``d_ff``.  The MoE FFN: a float32 router's softmax over
``moe_experts``, the top ``moe_topk`` experts with their probabilities
renormalised as gates, each expert a SwiGLU of width ``moe_d_ff`` taking at
most C = max(1, int(1.25 * topk * T / E)) of the batch's T tokens (routed
pairs in (expert, token, pick) order, the rest dropped), plus a shared
SwiGLU of width ``moe_d_ff * moe_shared_experts``; the load-balancing loss
E * sum_e(me_e * pe_e) (me: share of tokens whose best expert is e, pe:
mean router probability).  The loss: mean cross entropy of the next token
over every position, plus 0.01 times the summed balancing losses.

AdamW as configured: global-norm clip 1.0, b1 0.9, b2 0.95, eps 1e-8,
decoupled weight decay 0.1 inside the learning-rate product, bias
correction, learning rate from ``lr(step)``.

Parameter names and shapes are the training program's, so the benchmark
hands one set of weights to both.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference.plain import causal_attention, linear, rmsnorm, rope, \
    swiglu

CAPACITY_FACTOR = 1.25
AUX_WEIGHT = 0.01


def _attn_specs(p, m, bf16):
    D, H, KV = m["d_model"], m["n_heads"], m["kv_heads"]
    hd = m.get("head_dim") or D // H
    return [(p + "ln1", (D,), bf16, ("ones",)),
            (p + "ln2", (D,), bf16, ("ones",)),
            (p + "attn.wq", (D, H * hd), bf16, ("normal", D ** -0.5)),
            (p + "attn.wk", (D, KV * hd), bf16, ("normal", D ** -0.5)),
            (p + "attn.wv", (D, KV * hd), bf16, ("normal", D ** -0.5)),
            (p + "attn.wo", (H * hd, D), bf16, ("normal", (H * hd) ** -0.5))]


def _mlp_specs(p, D, F_, bf16):
    return [(p + "w_gate", (D, F_), bf16, ("normal", D ** -0.5)),
            (p + "w_up", (D, F_), bf16, ("normal", D ** -0.5)),
            (p + "w_down", (F_, D), bf16, ("normal", F_ ** -0.5))]


def specs(m: dict) -> list:
    """(name, shape, dtype, init) of every parameter."""
    bf16, f32 = getattr(torch, m["param_dtype"]), torch.float32
    D, V = m["d_model"], m["vocab"]
    E, Fe = m["moe_experts"], m.get("moe_d_ff") or m["d_ff"]
    out = [("embed", (V, D), bf16, ("normal", 0.02))]
    n_dense = m.get("moe_first_dense", 0)
    for i in range(n_dense):
        p = f"dense_layers.{i}."
        out += _attn_specs(p, m, bf16) + _mlp_specs(p + "mlp.", D, m["d_ff"],
                                                    bf16)
    for i in range(m["n_layers"] - n_dense):
        p = f"layers.{i}."
        out += _attn_specs(p, m, bf16)
        out += [(p + "moe.router", (D, E), f32, ("normal", D ** -0.5)),
                (p + "moe.we_gate", (E, D, Fe), bf16, ("normal", D ** -0.5)),
                (p + "moe.we_up", (E, D, Fe), bf16, ("normal", D ** -0.5)),
                (p + "moe.we_down", (E, Fe, D), bf16,
                 ("normal", Fe ** -0.5))]
        if m.get("moe_shared_experts"):
            out += _mlp_specs(p + "moe.shared.", D,
                              Fe * m["moe_shared_experts"], bf16)
    out += [("ln_f", (D,), bf16, ("ones",)),
            ("unembed", (D, V), bf16, ("normal", 0.02))]
    return out


def attention(w, p, m, x, precision):
    H, KV = m["n_heads"], m["kv_heads"]
    hd = m.get("head_dim") or m["d_model"] // H
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)
    q = rope(linear(x, w[p + "attn.wq"], precision).reshape(B, S, H, hd), pos)
    k = rope(linear(x, w[p + "attn.wk"], precision).reshape(B, S, KV, hd),
             pos)
    v = linear(x, w[p + "attn.wv"], precision).reshape(B, S, KV, hd)
    o = causal_attention(q, k, v).reshape(B, S, H * hd)
    return linear(o, w[p + "attn.wo"], precision)


def moe(w, p, m, x, precision):
    """(y, balancing loss) of one MoE FFN over x [B, S, D]."""
    B, S, D = x.shape
    E, K = m["moe_experts"], m["moe_topk"]
    T = B * S
    xt = x.reshape(T, D)
    probs = torch.softmax(xt @ w[p + "moe.router"], dim=-1)
    gates, idx = torch.topk(probs, K, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    C = max(1, int(CAPACITY_FACTOR * K * T / E))
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)          # (expert, token, k)
    counts = torch.bincount(flat_e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    flat_gates = gates.reshape(-1)
    toks, outs = [], []
    for e, (start, count) in enumerate(zip(starts.tolist(),
                                           counts.tolist())):
        rows = order[start:start + min(count, C)]
        if rows.numel() == 0:
            continue
        h = swiglu(xt[rows // K], w[p + "moe.we_gate"][e],
                   w[p + "moe.we_up"][e], w[p + "moe.we_down"][e], precision)
        toks.append(rows // K)
        outs.append(h * flat_gates[rows][:, None])
    y = torch.zeros_like(xt).index_add(0, torch.cat(toks), torch.cat(outs))
    y = y.reshape(B, S, D)
    if m.get("moe_shared_experts"):
        y = y + swiglu(x, w[p + "moe.shared.w_gate"], w[p + "moe.shared.w_up"],
                       w[p + "moe.shared.w_down"], precision)
    top1 = torch.argmax(probs, dim=-1)
    me = torch.bincount(top1, minlength=E).float() / T
    return y, E * torch.sum(me * probs.mean(0))


def _layer(w, p, m, x, precision):
    x = x + attention(w, p, m, rmsnorm(x, w[p + "ln1"]), precision)
    h = rmsnorm(x, w[p + "ln2"])
    if p.startswith("dense_layers"):
        return x + swiglu(h, w[p + "mlp.w_gate"], w[p + "mlp.w_up"],
                          w[p + "mlp.w_down"], precision), x.new_zeros(())
    y, aux = moe(w, p, m, h, precision)
    return x + y, aux


def _ce_sum(h, labels, unembed, precision):
    logits = linear(h, unembed, precision)
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, labels[:, None])[:, 0]).sum()


def loss(w: dict, m: dict, tokens, labels, precision="float32",
         chunk=2048):
    """The training loss of one batch; every layer and each chunk of the
    head is recomputed in the backward pass, so the float32 reference
    fits beside its optimizer state."""
    x = F.embedding(tokens, w["embed"])
    aux = x.new_zeros(())
    names = [f"dense_layers.{i}." for i in range(m.get("moe_first_dense", 0))]
    names += [f"layers.{i}."
              for i in range(m["n_layers"] - m.get("moe_first_dense", 0))]
    for p in names:
        x, a = checkpoint(_layer, w, p, m, x, precision, use_reentrant=False)
        aux = aux + a
    h = rmsnorm(x, w["ln_f"]).reshape(-1, x.shape[-1])
    y = labels.reshape(-1)
    total = x.new_zeros(())
    for c0 in range(0, h.shape[0], chunk):
        total = total + checkpoint(_ce_sum, h[c0:c0 + chunk],
                                   y[c0:c0 + chunk], w["unembed"], precision,
                                   use_reentrant=False)
    return total / h.shape[0] + AUX_WEIGHT * aux


def cosine_lr(step: int, peak=3e-4, warmup=200, total=10000, floor=0.1):
    """Linear warm-up to ``peak``, then cosine decay to ``floor * peak``."""
    if step < warmup:
        return peak * step / max(warmup, 1)
    frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * frac)))


class AdamW:
    """The configured AdamW over a dict of float32 leaves."""

    def __init__(self, params: dict, lr=cosine_lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, grad_clip=1.0):
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.eps, self.wd, self.clip = eps, weight_decay, grad_clip
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.step = 0

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> dict:
        """One step in place; returns each leaf's gradient as the update
        takes it (after the clip)."""
        self.step += 1
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        scale = torch.clamp_max(self.clip / (gnorm + 1e-12), 1.0)
        lr = self.lr(self.step)
        bc1 = 1 - self.b1 ** self.step
        bc2 = 1 - self.b2 ** self.step
        taken = {}
        for n, g in grads.items():
            g = g * scale
            taken[n] = g
            self.m[n].mul_(self.b1).add_((1 - self.b1) * g)
            self.v[n].mul_(self.b2).add_((1 - self.b2) * g * g)
            params[n].sub_(lr * ((self.m[n] / bc1) / (
                torch.sqrt(self.v[n] / bc2) + self.eps)
                + self.wd * params[n]))
        return taken
