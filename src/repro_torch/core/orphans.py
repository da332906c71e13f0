"""Orphaned-access / cache-pollution analysis (paper §7.1.6, Table 8).

An access is *orphaned* when it belongs to a lifetime with zero reuse: the
datum was fetched or written to the cache, then evicted/overwritten without
ever being read.  Orphaned accesses pollute the cache and waste refresh and
allocation energy on short-term memories.

The lifetimes are extracted on the torch ``device`` (``None`` = the CUDA
device; raises without one) and the per-lifetime access counts are taken
there; only two integers come back to the host.
"""

from __future__ import annotations

import torch

from repro_torch.core.lifetime import LifetimeStats, lifetimes_of_trace
from repro_torch.core.trace import Trace


def orphaned_access_fraction(
    trace: Trace,
    sub: int,
    mode: str = "cache",
    write_allocate: bool = True,
    device=None,
) -> float:
    """Fraction of accesses that belong to zero-reuse lifetimes."""
    t = trace.select(sub)
    if t.n_events == 0:
        return 0.0
    stats: LifetimeStats = lifetimes_of_trace(
        t, mode=mode, write_allocate=write_allocate, device=device)
    n = stats.lifetime_cycles.shape[0]
    seg_events = torch.bincount(stats.seg_id_per_event, minlength=n)
    valid, orphan = stats.valid, stats.orphan
    total = int(seg_events[valid].sum())
    if total == 0:
        return 0.0
    return float(int(seg_events[valid & orphan].sum()) / total)


def policy_ablation(trace: Trace, sub: int, device=None) -> dict:
    """Write-allocate vs no-write-allocate orphan comparison (Table 8)."""
    return {
        "write_allocate": orphaned_access_fraction(
            trace, sub, write_allocate=True, device=device),
        "no_write_allocate": orphaned_access_fraction(
            trace, sub, write_allocate=False, device=device),
    }
