"""Plain oracles for the Mamba-2 SSD (state-space duality) scan.

Recurrence (per batch b, head h, channel p, state n):

    s_t = exp(dt_t * A_h) * s_{t-1} + dt_t * B_t[n] * x_t[p]
    y_t = sum_n C_t[n] * s_t[p, n]  (+ D_h * x_t[p])

``ssd_sequential`` is the literal recurrence (oracle).  ``ssd_chunked`` is
the chunked form (a loop over chunks; quadratic intra-chunk term plus the
inter-chunk state carry), mathematically identical.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_sequential(x, dt, A, B, C, D=None):
    """x: [b,l,h,p]; dt: [b,l,h] (>0); A: [h] (<0); B,C: [b,l,n]."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    s = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(l):
        da = torch.exp(dtf[:, t] * A)                        # [b,h]
        s = s * da[..., None, None] + torch.einsum(
            "bhp,bn->bhpn", xf[:, t] * dtf[:, t, :, None], Bf[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", s, Cf[:, t]))
    y = torch.stack(ys, 1)
    if D is not None:
        y = y + xf * D[None, None, :, None]
    return y.to(x.dtype)


def ssd_chunked(x, dt, A, B, C, D=None, chunk: int = 64):
    """Chunked SSD: intra-chunk quadratic attention-like term plus
    inter-chunk recurrent state (the SSD algorithm of Mamba-2 §6)."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, l)
    pad = (-l) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = x.shape[1] // q

    xf = x.float().reshape(b, nc, q, h, p)
    dtf = dt.float().reshape(b, nc, q, h)
    Bf = B.float().reshape(b, nc, q, n)
    Cf = C.float().reshape(b, nc, q, n)
    Af = A.float()
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=x.device))

    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xc, dtc, Bc, Cc = xf[:, c], dtf[:, c], Bf[:, c], Cf[:, c]
        cum = torch.cumsum(dtc * Af, dim=1)                 # [b,q,h]
        # intra-chunk: y_i += sum_{j<=i} (C_i.B_j) exp(cum_i-cum_j) dt_j x_j
        seg = cum[:, :, None, :] - cum[:, None, :, :]       # [b,i,j,h]
        decay = torch.where(causal[None, :, :, None], torch.exp(seg),
                            torch.zeros((), device=x.device))
        cb = torch.einsum("bin,bjn->bij", Cc, Bc)
        xdt = xc * dtc[..., None]
        y_intra = torch.einsum("bij,bijh,bjhp->bihp", cb, decay, xdt)
        # inter-chunk: y_i += C_i . (exp(cum_i) * state)
        y_inter = torch.einsum("bin,bhpn->bihp", Cc, state) \
            * torch.exp(cum)[..., None]
        # s' = exp(cum_Q) s + sum_j exp(cum_Q-cum_j) dt_j B_j x_j
        to_end = torch.exp(cum[:, -1:, :] - cum)
        state = state * torch.exp(cum[:, -1, :])[..., None, None] \
            + torch.einsum("bjh,bjn,bjhp->bhpn", to_end * dtc, Bc, xc)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, 1).reshape(b, nc * q, h, p)[:, :l]
    if D is not None:
        y = y + x.float()[:, :l] * D[None, None, :, None]
    return y.to(x.dtype)


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t, D=None):
    """One recurrent decode step. state: [b,h,p,n]; x_t: [b,h,p];
    dt_t: [b,h]; B_t/C_t: [b,n]. Returns (new_state, y_t)."""
    da = torch.exp(dt_t.float() * A)
    state = state * da[..., None, None] + torch.einsum(
        "bhp,bn->bhpn", (x_t * dt_t[..., None]).float(), B_t.float())
    y = torch.einsum("bhpn,bn->bhp", state, C_t.float())
    if D is not None:
        y = y + x_t.float() * D[None, :, None]
    return state, y.to(x_t.dtype)
