"""Public entry point of the flash-attention kernels in the model layout.

``flash_attention`` takes [B, S, H, hd] (heads after sequence) and hands
the kernels transposed views, without copies.  It is differentiable: a
``torch.autograd.Function`` runs the forward kernel (K2), saves
``(q, k, v, o, lse)`` and runs the two backward kernels (K3, K4) on the
gradient, as the reference's custom VJP does; no S x S probabilities are
kept between the two directions.  Under ``torch.no_grad()`` (as the serving
path runs) only the forward runs.  The entry points are looked up in this
module at call time, so a caller can route them elsewhere for a
comparison.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_bhsd
from repro_torch.kernels.flash_attention.kernel_bwd import \
    flash_attention_bwd_bhsd


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_bhsd(q, k, v, causal=causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:            # the kernels take strided rows only
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd_bhsd(q, k, v, o, lse, do,
                                              causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal=True):
    """q: [B, Sq, H, hd]; k/v: [B, Skv, KV, hd] -> [B, Sq, H, hd]."""
    o = _FlashAttention.apply(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal)
    return o.transpose(1, 2)
