"""Independent oracle for the lifetime-scan kernel.

Reuses the frontend's segmented extraction (``repro_torch.core.lifetime``)
and bins the result on the host with exact integer arithmetic - the kernel
and its plain version must reproduce these aggregates exactly.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.lifetime import extract_lifetimes
from repro_torch.kernels.lifetime_scan.ops import integer_edges


def lifetime_hist_reference(t, addr, is_write, edges, device=None):
    """Returns (hist [NB] int64, stats [8] int64) matching the kernel
    contract, as numpy arrays."""
    w = np.asarray(is_write, bool)
    host = extract_lifetimes(
        np.asarray(t, np.int64), np.asarray(addr), w, np.ones_like(w),
        mode="scratchpad", device=device).numpy()
    live = ~host.orphan
    lt = host.lifetime_cycles[live]
    ie = integer_edges(edges)
    hist = np.array([((lt >= lo) & (lt < hi)).sum()
                     for lo, hi in zip(ie[:-1], ie[1:])], np.int64)
    out = np.zeros(8, np.int64)
    out[0] = live.sum()
    out[1] = host.orphan.sum()
    out[2] = lt.sum()
    out[3] = lt.max() if lt.size else 0
    out[4] = (~w).sum()
    out[5] = w.sum()
    return hist, out
