"""Data-lifetime extraction (paper §4, Definitions 4.1-4.3).

A *lifetime* of a value at an address is the interval between its first
write (store / fetch / cache miss, depending on the memory kind) and the
last read of that value before it is overwritten or invalidated.

The extraction is a segmented reduction over the event stream sorted by
(address, time): a new segment ("lifetime") begins whenever the address
changes or a *boundary* event occurs.  Boundary rules per Definition:

  Def 4.1/4.2 (scratchpad):  boundary = is_write
  Def 4.3    (data cache):   boundary = is_write | miss
      under no-allocate-on-write, write misses do not allocate: the write
      terminates the previous lifetime but does not begin a new one, so a
      segment started by a write-miss is dropped.

Implemented with stock torch ops on the caller's device (two stable sorts,
``cumsum`` segment ids, ``scatter_reduce_``); the hand-written CUDA kernel
covering the aggregate form of the same computation lives in
``repro_torch.kernels.lifetime_scan`` (this module is its oracle for the
sorted-segment phase).

Outputs are *per-segment* tensors padded to ``n_events`` (a trace of N
events has at most N lifetimes), index-for-index the layout of
``repro.core.lifetime``:
  lifetime_cycles  i64   last-read - first-write (0 for orphans)
  n_reads          i64   reads observed within the lifetime
  start_cycles     i64   cycle stamp of the initiating event
  addr             i64   block address hosting the lifetime
  valid            bool  segment exists (non-padding)
  orphan           bool  lifetime with zero reads (fetched/written, never
                         reused) - paper §7.1.6 "orphaned accesses"

Cycle stamps and addresses are native ``torch.int64`` end to end: cycle
counts past 2**31 and line addresses >= 2**31 are exact.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.trace import Trace
from repro_torch.device import resolve_device

# "no read yet" sentinel: below any real int64 cycle stamp, with headroom
# so segment arithmetic cannot overflow (repro_torch.core.accumulate
# mirrors it).
NO_READ_SENTINEL = -(2 ** 62)

_I64_MAX = torch.iinfo(torch.int64).max
_I64_MIN = torch.iinfo(torch.int64).min


@dataclasses.dataclass(frozen=True)
class HostLifetimes:
    """The valid rows of a :class:`LifetimeStats` as numpy arrays, in
    segment order (``valid`` is all ones).  This is what the numpy
    frontend and the composition engine consume; it has the layout of
    ``accumulate.FoldedLifetimes`` without the per-segment event count."""
    lifetime_cycles: np.ndarray
    n_reads: np.ndarray
    start_cycles: np.ndarray
    addr: np.ndarray
    valid: np.ndarray
    orphan: np.ndarray


@dataclasses.dataclass(frozen=True)
class LifetimeStats:
    lifetime_cycles: torch.Tensor
    n_reads: torch.Tensor
    start_cycles: torch.Tensor
    addr: torch.Tensor
    valid: torch.Tensor
    orphan: torch.Tensor
    seg_id_per_event: torch.Tensor  # maps events -> their lifetime segment

    @functools.cached_property
    def _host(self) -> HostLifetimes:
        v = self.valid

        def rows(x: torch.Tensor) -> np.ndarray:
            # compact on the device, so only valid rows cross to the host
            return x[v].cpu().numpy()

        lt = rows(self.lifetime_cycles)
        return HostLifetimes(
            lifetime_cycles=lt, n_reads=rows(self.n_reads),
            start_cycles=rows(self.start_cycles), addr=rows(self.addr),
            valid=np.ones(len(lt), bool), orphan=rows(self.orphan))

    def numpy(self) -> HostLifetimes:
        """Valid rows on the host (copied once, then cached)."""
        return self._host

    def lifetimes_s(self, clock_hz: float) -> np.ndarray:
        """Valid lifetimes in seconds (host-side convenience)."""
        return self.numpy().lifetime_cycles / clock_hz


def _to_device(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    return x.to(device=device, dtype=dtype)


def sort_by_addr_time(t: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Permutation ordering events by (addr, time), stable: a stable sort
    by time followed by a stable sort by address, which is the order of
    ``lexsort((t, a))``."""
    by_t = torch.sort(t, stable=True).indices
    by_a = torch.sort(a[by_t], stable=True).indices
    return by_t[by_a]


def extract_lifetimes(
    time_cycles,
    addr,
    is_write,
    hit,
    mode: str = "scratchpad",
    write_allocate: bool = True,
    device=None,
) -> LifetimeStats:
    """Segmented lifetime extraction. All inputs are 1-D, equal length
    (numpy arrays or tensors); the work runs on ``device`` (``None`` =
    the CUDA device) and the result stays there.

    mode: "scratchpad" (Def 4.2) or "cache" (Def 4.3).
    write_allocate: cache write-allocation policy ablation (§7.1.6).
    """
    if mode not in ("scratchpad", "cache"):
        raise ValueError(f"unknown mode {mode!r}")
    dev = resolve_device(device)
    t = _to_device(time_cycles, torch.int64, dev)
    a = _to_device(addr, torch.int64, dev)
    w = _to_device(is_write, torch.bool, dev)
    h = _to_device(hit, torch.bool, dev)
    n = t.shape[0]

    # Sort events by (addr, time); stable so same-cycle order is preserved.
    order = sort_by_addr_time(t, a)
    t, a, w, h = t[order], a[order], w[order], h[order]

    new_addr = torch.ones(n, dtype=torch.bool, device=dev)
    new_addr[1:] = a[1:] != a[:-1]
    no = torch.zeros_like(w)
    if mode == "scratchpad":
        boundary = new_addr | w
        read_ok = ~w
        dead_start = no                 # every segment is a real lifetime
    else:
        miss = ~h
        boundary = new_addr | w | miss
        # a read only extends a lifetime if it hits in the cache
        read_ok = (~w) & h
        # write misses do not allocate a line under no-write-allocate:
        # segments they start are not lifetimes in the cache (the data
        # never lived on-chip).
        dead_start = no if write_allocate else w & miss

    seg_id = torch.cumsum(boundary, 0) - 1

    def seg(src: torch.Tensor, reduce: str, init: int) -> torch.Tensor:
        out = torch.full((n,), init, dtype=torch.int64, device=dev)
        return out.scatter_reduce_(0, seg_id, src, reduce, include_self=True)

    start = seg(t, "amin", _I64_MAX)
    last_read = seg(torch.where(read_ok, t, NO_READ_SENTINEL), "amax",
                    _I64_MIN)
    n_reads = seg(read_ok.to(torch.int64), "sum", 0)
    n_events_seg = seg(torch.ones_like(seg_id), "sum", 0)
    seg_addr = seg(a, "amax", _I64_MIN)
    seg_dead = seg((dead_start & boundary).to(torch.int64), "amax", 0) > 0

    valid = (n_events_seg > 0) & (~seg_dead)
    has_read = n_reads > 0
    lifetime = torch.where(valid & has_read, last_read - start, 0)
    orphan = valid & (~has_read)

    return LifetimeStats(
        lifetime_cycles=lifetime,
        n_reads=n_reads,
        start_cycles=torch.where(valid, start, 0),
        addr=torch.where(valid, seg_addr, -1),
        valid=valid,
        orphan=orphan,
        seg_id_per_event=seg_id,
    )


def lifetimes_of_trace(
    trace: Trace,
    mode: str = "scratchpad",
    write_allocate: bool = True,
    device=None,
) -> LifetimeStats:
    """Move one (single-subpartition) trace's arrays to ``device`` once
    and extract its lifetimes there."""
    return extract_lifetimes(
        trace.time_cycles,
        trace.addr,
        trace.is_write,
        trace.hit,
        mode=mode,
        write_allocate=write_allocate,
        device=device,
    )


def short_lived_fraction(
    stats: LifetimeStats, clock_hz: float, retention_s: float,
    weight_by_accesses: bool = True,
) -> float:
    """Fraction of accesses (or lifetimes) at or under a device retention.

    The paper's headline numbers ("64% of L1 accesses are short-lived")
    weight by *accesses*: every event belonging to a lifetime that fits the
    retention counts.
    """
    lt = stats.lifetime_cycles.to(torch.float64)
    # divided by a tensor on the same device: a Python scalar divisor makes
    # CUDA multiply by its reciprocal, which moves lifetimes that sit on a
    # retention boundary (1000 cycles at 1 GHz is 1e-6 s) across it
    lt_s = lt / torch.tensor(clock_hz, dtype=torch.float64, device=lt.device)
    valid = stats.valid
    fits = (lt_s <= retention_s) & valid
    if weight_by_accesses:
        seg_events = torch.bincount(stats.seg_id_per_event,
                                    minlength=valid.shape[0])
        tot = int(seg_events[valid].sum())
        return float(int(seg_events[fits].sum()) / max(tot, 1))
    nv = int(valid.sum())
    return float(int(fits.sum()) / max(nv, 1))


def lifetime_histogram(
    stats: LifetimeStats, clock_hz: float,
    bins_s: np.ndarray,
) -> np.ndarray:
    """Histogram of valid lifetimes (seconds) over given bin edges."""
    lt = stats.lifetimes_s(clock_hz)
    hist, _ = np.histogram(lt, bins=np.asarray(bins_s))
    return hist
