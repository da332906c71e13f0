"""Public entry point of the SSD scan kernel: pad, then dispatch."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.kernel import ssd_scan_chunked


def ssd_scan(x, dt, A, B, C, D=None, chunk: int = 64):
    """x: [b,l,h,p]; dt: [b,l,h]; A: [h]; B/C: [b,l,n]; D: [h] or None.

    l is padded to a multiple of ``chunk`` with dt = 0, which contributes
    nothing (dt*A = 0 keeps the decay, dt*x = 0 adds nothing)."""
    b, l, h, p = x.shape
    if D is None:
        D = torch.zeros((h,), dtype=torch.float32, device=x.device)
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    y = ssd_scan_chunked(x, dt.float(), A.float(), B, C, D.float(),
                         chunk=chunk)
    return y[:, :l]
