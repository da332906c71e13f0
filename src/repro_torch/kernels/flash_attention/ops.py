"""Public entry point of the flash-attention kernel in the model layout.

``flash_attention`` takes [B, S, H, hd] (heads after sequence) and hands
the kernel transposed views, without copies.  It is forward-only: the
backward kernels (ROADMAP B3/B4) come with the training slice, so a tensor
that requires grad raises rather than differentiating through the plain
version.  Under ``torch.no_grad()`` (as the serving path runs) nothing is
recorded and the call goes through.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_bhsd


def flash_attention(q, k, v, *, causal=True):
    """q: [B, Sq, H, hd]; k/v: [B, Skv, KV, hd] -> [B, Sq, H, hd]."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash_attention is forward-only until its backward kernels are "
            "ported (ROADMAP B3); call it under torch.no_grad()")
    o, _ = flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal)
    return o.transpose(1, 2)
