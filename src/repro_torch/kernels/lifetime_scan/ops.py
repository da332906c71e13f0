"""Public entry point of the lifetime-scan kernel: sort + dispatch.

Events are moved to the device, ordered by (addr, time) with two stable
sorts there, and handed to ``kernel.lifetime_scan_sorted``.  Times and
addresses are any int64: there is no rebasing, no limb split, no address
window and no padding protocol.

Histogram edges are given in float64 and converted to *integer*
thresholds (ceil) on the host: for integer lifetimes ``lt >= e`` iff
``lt >= ceil(e)`` and ``lt < e`` iff ``lt < ceil(e)``, so binning is exact
at any magnitude.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.lifetime import _to_device, sort_by_addr_time
from repro_torch.device import resolve_device
from repro_torch.kernels.lifetime_scan.kernel import lifetime_scan_sorted

_I64_MAX = np.iinfo(np.int64).max
_I64_MIN = np.iinfo(np.int64).min


def default_edges(n_bins: int = 64, lo_cycles: float = 1.0,
                  hi_cycles: float = 1e8) -> np.ndarray:
    """Log-spaced lifetime bins (cycles); final edge is +inf.

    float64: f32 edges misbin integer cycle counts past 2**24 (distinct
    edges collapse and boundary lifetimes land one bin off).
    """
    e = np.logspace(np.log10(lo_cycles), np.log10(hi_cycles), n_bins)
    return np.concatenate([[0.0], e[:-1], [np.inf]]).astype(np.float64)


def integer_edges(edges) -> np.ndarray:
    """float64 edges -> exact int64 ceil thresholds.

    +inf (and anything past the int64 range) caps at ``2**63 - 1``, which
    no difference of two cycle stamps inside the trace contract
    (``|t| < 2**62``) reaches, so the open top bin still catches
    everything.  Edges must ascend.
    """
    e = np.asarray(edges, np.float64)
    if e.ndim != 1 or len(e) < 2:
        raise ValueError("edges must be 1-D with at least two entries")
    if np.isnan(e).any() or (np.diff(e) < 0).any():
        raise ValueError("edges must be ascending and not NaN")
    c = np.ceil(e)
    ie = np.where(c < 0, _I64_MIN, _I64_MAX).astype(np.int64)
    inside = (c >= -2.0 ** 63) & (c < 2.0 ** 63)
    ie[inside] = c[inside].astype(np.int64)
    return ie


def lifetime_histogram(time_cycles, addr, is_write, edges=None,
                       device=None):
    """Aggregate lifetime histogram + stats over an (unsorted) event list.

    Returns ``(hist [NB] int64, stats [8] int64)`` on ``device`` (``None``
    = the CUDA device); see ``kernel.py`` for the stats layout.
    """
    if edges is None:
        edges = default_edges()
    dev = resolve_device(device)
    e = torch.from_numpy(integer_edges(edges)).to(dev)
    t = _to_device(time_cycles, torch.int64, dev)
    a = _to_device(addr, torch.int64, dev)
    w = _to_device(is_write, torch.bool, dev)
    if t.shape[0] == 0:
        return (torch.zeros(len(e) - 1, dtype=torch.int64, device=dev),
                torch.zeros(8, dtype=torch.int64, device=dev))
    order = sort_by_addr_time(t, a)
    return lifetime_scan_sorted(t[order], a[order], w[order], e)
