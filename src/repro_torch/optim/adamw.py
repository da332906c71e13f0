"""AdamW with fp32 master weights and fp32 moments (mixed-precision
training standard): model params stay bf16 for compute; the optimizer
carries the precision.

The reference's functional update becomes an in-place one here: the
moments, the master weights and the model's parameters are updated where
they lie (a 1.1B-parameter model carries 13 GB of fp32 state, which a
second copy per step would double).  ``update`` still returns
``(params, state, metrics)`` as the reference does.  The arithmetic is the
reference's, in its order: global-norm clip, bias correction, decoupled
weight decay inside the learning-rate product.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable:
    """Linear warm-up to ``peak_lr``, then cosine decay to ``floor *
    peak_lr``; ``lr(step)`` is a float32 tensor."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 *
                         (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params: dict) -> dict:
        """``params``: name -> tensor (``dict(model.named_parameters())``)."""
        device = next(iter(params.values())).device
        return {
            "step": torch.zeros((), dtype=torch.int64, device=device),
            "m": {n: torch.zeros_like(p, dtype=torch.float32)
                  for n, p in params.items()},
            "v": {n: torch.zeros_like(p, dtype=torch.float32)
                  for n, p in params.items()},
            "master": {n: p.detach().float().clone()
                       for n, p in params.items()},
        }

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict):
        """One step, in place on ``state`` and ``params``; returns
        ``(params, state, {"grad_norm", "lr"})``."""
        step = state["step"] + 1
        gsq = sum(torch.sum(torch.square(g.float())) for g in grads.values())
        gnorm = torch.sqrt(gsq)
        scale = torch.clamp_max(self.grad_clip / (gnorm + 1e-12), 1.0)
        lr = self.lr(step)
        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        for name, g in grads.items():
            m, v, mw = state["m"][name], state["v"][name], \
                state["master"][name]
            g = g.float() * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            mhat = m / bc1
            vhat = v / bc2
            mw.sub_(lr * (mhat / (torch.sqrt(vhat) + self.eps)
                          + self.weight_decay * mw))
            params[name].copy_(mw)
        state["step"] = step
        return params, state, {"grad_norm": gnorm, "lr": lr}
