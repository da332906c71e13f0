"""Public entry point of the SSD scan kernel: pad, then dispatch.

The kernel has no backward, as the reference's Pallas ``ssd_scan`` has no
VJP: a gradient through :func:`ssd_scan` raises on every device (on the CPU
the plain version runs, but this route stands for the kernel route, which
cannot be differentiated).  Training goes through ``attn_impl="ref"``, the
chunked plain form of ``kernels/ssd_scan/ref.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.kernel import ssd_scan_chunked

NO_BACKWARD = ("the SSD scan kernel has no backward (the reference's "
               "Pallas ssd_scan has no VJP either); train through "
               "attn_impl='ref'")


class _SSDScan(torch.autograd.Function):
    """The kernel call, recorded so that a backward through it raises
    instead of treating y as a constant."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, chunk):
        return ssd_scan_chunked(x, dt, A, B, C, D, chunk=chunk)

    @staticmethod
    def backward(ctx, grad_y):
        raise NotImplementedError(NO_BACKWARD)


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
    y = _SSDScan.apply(x, dt.float(), A.float(), B, C, D.float(), chunk)
    return y[:, :l]
