"""Incremental (streaming) lifetime analysis: ``TraceAccumulator``.

The monolithic frontend path materializes one flat ``Trace`` and extracts
every lifetime in a single segmented reduction.  Multi-step workloads
(per-kernel streams, PKA-sampled epochs, long training runs) can instead be
folded chunk by chunk: the accumulator keeps, per subpartition, only

  - scalar counters (reads, writes, time bounds, unique addresses), and
  - one *open* segment per live address (the trailing lifetime that the
    next chunk may extend),

so memory is bounded by the memory's footprint, not the trace length.

Semantics replicate ``repro_torch.core.lifetime.extract_lifetimes`` exactly
(Definitions 4.1-4.3, including the cache-mode miss boundaries and the
no-write-allocate dead-segment rule).  The contract for exact equivalence
with the monolithic path is that each address's events arrive in
time order across chunks - which any time-sorted trace split with
``repro_torch.core.trace.chunk_trace`` (or any per-step stream emitted in
execution order) satisfies.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.frontend import SubpartitionStats
from repro_torch.core.trace import Trace

from repro_torch.core.lifetime import NO_READ_SENTINEL as _NEG  # "no read yet"


@dataclasses.dataclass(frozen=True)
class FoldedLifetimes:
    """Completed lifetimes of one subpartition, in ``LifetimeStats`` layout
    (valid rows only).  Duck-type compatible with ``compose(raw=...)``."""
    lifetime_cycles: np.ndarray
    n_reads: np.ndarray
    start_cycles: np.ndarray
    addr: np.ndarray
    valid: np.ndarray
    orphan: np.ndarray
    n_events: np.ndarray


def folded_short_lived_fraction(
    raw: FoldedLifetimes, clock_hz: float, retention_s: float,
    weight_by_accesses: bool = True) -> float:
    """Streaming twin of ``repro_torch.core.lifetime.short_lived_fraction``:
    folded lifetimes carry per-segment event counts, so the paper's
    access-weighted headline numbers come straight from them."""
    lt_s = raw.lifetime_cycles / clock_hz
    fits = lt_s <= retention_s
    if weight_by_accesses:
        tot = raw.n_events.sum()
        return float(raw.n_events[fits].sum() / max(tot, 1))
    return float(fits.sum() / max(len(fits), 1))


class _SubState:
    """Streaming fold state for one subpartition."""

    def __init__(self):
        self.n_reads = 0
        self.n_writes = 0
        self.t_min = None
        self.t_max = None
        self.addr_seen: set = set()
        # open segments, parallel arrays sorted by address
        self.open_addr = np.zeros(0, np.int64)
        self.open_start = np.zeros(0, np.int64)
        self.open_last = np.full(0, _NEG, np.int64)
        self.open_nreads = np.zeros(0, np.int64)
        self.open_nev = np.zeros(0, np.int64)
        self.open_dead = np.zeros(0, bool)
        # finalized (valid) lifetimes, appended per chunk
        self.done_lt: list = []
        self.done_nreads: list = []
        self.done_start: list = []
        self.done_addr: list = []
        self.done_orphan: list = []
        self.done_nev: list = []

    def _finalize(self, start, last, nreads, addr, dead, nev):
        valid = ~dead
        if not valid.any():
            return
        start, last = start[valid], last[valid]
        nreads, addr, nev = nreads[valid], addr[valid], nev[valid]
        has_read = nreads > 0
        self.done_lt.append(np.where(has_read, last - start, 0))
        self.done_nreads.append(nreads)
        self.done_start.append(start)
        self.done_addr.append(addr)
        self.done_orphan.append(~has_read)
        self.done_nev.append(nev)

    def close_all(self):
        self._finalize(self.open_start, self.open_last, self.open_nreads,
                       self.open_addr, self.open_dead, self.open_nev)
        self.open_addr = np.zeros(0, np.int64)
        self.open_start = np.zeros(0, np.int64)
        self.open_last = np.full(0, _NEG, np.int64)
        self.open_nreads = np.zeros(0, np.int64)
        self.open_nev = np.zeros(0, np.int64)
        self.open_dead = np.zeros(0, bool)

    def folded(self) -> FoldedLifetimes:
        def cat(parts, dtype):
            return (np.concatenate(parts).astype(dtype) if parts
                    else np.zeros(0, dtype))
        lt = cat(self.done_lt, np.int64)
        return FoldedLifetimes(
            lifetime_cycles=lt,
            n_reads=cat(self.done_nreads, np.int64),
            start_cycles=cat(self.done_start, np.int64),
            addr=cat(self.done_addr, np.int64),
            valid=np.ones(len(lt), bool),
            orphan=cat(self.done_orphan, bool),
            n_events=cat(self.done_nev, np.int64),
        )


class TraceAccumulator:
    """Fold per-chunk traces into frontend statistics in bounded memory.

    Usage::

        acc = TraceAccumulator(mode="scratchpad")
        for chunk in chunk_trace(trace, 10_000):   # or any per-step stream
            acc.update(chunk)
        stats, raw = acc.stats(sub=0)              # SubpartitionStats +
                                                   # compose()-ready raw
    """

    def __init__(self, mode: str = "scratchpad",
                 write_allocate: bool = True):
        if mode not in ("scratchpad", "cache"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        self.write_allocate = write_allocate
        self.clock_hz = None
        self.block_bits = None
        self.names: tuple = ()
        self._subs: dict[int, _SubState] = {}
        self._closed = False

    # ------------------------------------------------------------------
    @property
    def subpartitions(self) -> tuple:
        return tuple(sorted(self._subs))

    def update(self, chunk: Trace) -> "TraceAccumulator":
        if self._closed:
            raise RuntimeError("TraceAccumulator already finalized")
        if self.clock_hz is None:
            self.clock_hz = chunk.clock_hz
            self.block_bits = chunk.block_bits
            self.names = tuple(chunk.names)
        elif (chunk.clock_hz != self.clock_hz
              or chunk.block_bits != self.block_bits
              or tuple(chunk.names) != self.names):
            raise ValueError("chunk metadata mismatch: all chunks must "
                             "share clock_hz/block_bits/names")
        subp = np.asarray(chunk.subpartition)
        t = np.asarray(chunk.time_cycles)
        a = np.asarray(chunk.addr)
        w = np.asarray(chunk.is_write, bool)
        h = np.asarray(chunk.hit, bool)
        for sub in np.unique(subp).tolist():
            m = subp == sub
            self._fold(self._subs.setdefault(int(sub), _SubState()),
                       t[m], a[m], w[m], h[m])
        return self

    def _fold(self, s: _SubState, t_raw, a_raw, w, h):
        n = len(t_raw)
        if n == 0:
            return
        s.n_reads += int((~w).sum())
        s.n_writes += int(w.sum())
        tmin, tmax = int(t_raw.min()), int(t_raw.max())
        s.t_min = tmin if s.t_min is None else min(s.t_min, tmin)
        s.t_max = tmax if s.t_max is None else max(s.t_max, tmax)
        s.addr_seen.update(np.unique(a_raw).tolist())

        # match extract_lifetimes: int64 cycle/address arithmetic, stable
        # (addr, time) sort
        t = t_raw.astype(np.int64)
        a = a_raw.astype(np.int64)
        order = np.lexsort((t, a))
        t, a, w, h = t[order], a[order], w[order], h[order]

        if self.mode == "scratchpad":
            boundary = w
            read_ok = ~w
            dead = np.zeros(n, bool)
        else:
            miss = ~h
            boundary = w | miss
            read_ok = (~w) & h
            dead = (w & miss) if not self.write_allocate \
                else np.zeros(n, bool)

        new_addr = np.empty(n, bool)
        new_addr[0] = True
        new_addr[1:] = a[1:] != a[:-1]
        starts = np.flatnonzero(new_addr | boundary)
        nseg = len(starts)

        seg_addr = a[starts].astype(np.int64)
        eff_start = t[starts].astype(np.int64)
        eff_last = np.maximum.reduceat(
            np.where(read_ok, t.astype(np.int64), _NEG), starts)
        eff_nreads = np.add.reduceat(read_ok.astype(np.int64), starts)
        eff_nev = np.diff(np.append(starts, n))
        eff_dead = dead[starts].copy()
        # a segment head that is not itself a boundary event continues the
        # address's open segment from previous chunks (if any)
        cont = new_addr[starts] & ~boundary[starts]

        first_of_addr = np.empty(nseg, bool)
        first_of_addr[0] = True
        first_of_addr[1:] = seg_addr[1:] != seg_addr[:-1]
        last_of_addr = np.empty(nseg, bool)
        last_of_addr[-1] = True
        last_of_addr[:-1] = seg_addr[1:] != seg_addr[:-1]

        consumed = np.zeros(len(s.open_addr), bool)
        if len(s.open_addr):
            fi = np.flatnonzero(first_of_addr)
            faddr = seg_addr[fi]
            pos = np.searchsorted(s.open_addr, faddr)
            ok = pos < len(s.open_addr)
            match = np.zeros(len(fi), bool)
            match[ok] = s.open_addr[pos[ok]] == faddr[ok]
            # continuation heads: merge the open segment into the head
            mm = match & cont[fi]
            midx, opos = fi[mm], pos[mm]
            eff_start[midx] = s.open_start[opos]
            eff_last[midx] = np.maximum(s.open_last[opos], eff_last[midx])
            eff_nreads[midx] += s.open_nreads[opos]
            eff_nev[midx] += s.open_nev[opos]
            eff_dead[midx] = s.open_dead[opos]
            consumed[opos] = True
            # boundary heads: the open segment ends right there, as-is
            bb = match & ~cont[fi]
            bpos = pos[bb]
            s._finalize(s.open_start[bpos], s.open_last[bpos],
                        s.open_nreads[bpos], s.open_addr[bpos],
                        s.open_dead[bpos], s.open_nev[bpos])
            consumed[bpos] = True

        # every non-trailing segment of an address is complete
        fin = ~last_of_addr
        s._finalize(eff_start[fin], eff_last[fin], eff_nreads[fin],
                    seg_addr[fin], eff_dead[fin], eff_nev[fin])

        # new open set: untouched previous opens + trailing chunk segments
        keep = ~consumed
        lm = last_of_addr
        new_addrs = np.concatenate([s.open_addr[keep], seg_addr[lm]])
        o = np.argsort(new_addrs, kind="stable")
        s.open_addr = new_addrs[o]
        s.open_start = np.concatenate(
            [s.open_start[keep], eff_start[lm]])[o]
        s.open_last = np.concatenate([s.open_last[keep], eff_last[lm]])[o]
        s.open_nreads = np.concatenate(
            [s.open_nreads[keep], eff_nreads[lm]])[o]
        s.open_nev = np.concatenate([s.open_nev[keep], eff_nev[lm]])[o]
        s.open_dead = np.concatenate([s.open_dead[keep], eff_dead[lm]])[o]

    # ------------------------------------------------------------------
    def finalize(self) -> "TraceAccumulator":
        """Close all still-open trailing lifetimes (end of trace)."""
        if not self._closed:
            for s in self._subs.values():
                s.close_all()
            self._closed = True
        return self

    def stats(self, sub: int) -> tuple[SubpartitionStats, FoldedLifetimes]:
        """(SubpartitionStats, compose()-ready raw) for one subpartition."""
        self.finalize()
        if sub not in self._subs:
            raise ValueError(f"subpartition {sub} never seen "
                             f"(have {self.subpartitions})")
        s = self._subs[sub]
        raw = s.folded()
        dur_s = 0.0 if s.t_min is None else \
            float(s.t_max - s.t_min + 1) / self.clock_hz
        dur = max(dur_s, 1e-30)
        lt_s = raw.lifetime_cycles / self.clock_hz
        stats = SubpartitionStats(
            name=self.names[sub] if sub < len(self.names) else f"sub{sub}",
            n_reads=s.n_reads,
            n_writes=s.n_writes,
            n_unique_addrs=len(s.addr_seen),
            duration_s=dur,
            write_freq_hz=s.n_writes / dur,
            read_freq_hz=s.n_reads / dur,
            lifetimes_s=lt_s,
            lifetime_bits=np.full(lt_s.shape, self.block_bits, np.float64),
            accesses_per_lifetime=(raw.n_reads + 1).astype(np.float64),
            orphan_fraction=float(raw.orphan.mean()) if len(raw.orphan)
            else 0.0,
            block_bits=self.block_bits,
        )
        return stats, raw

    def short_lived_fraction(self, sub: int, retention_s: float,
                             weight_by_accesses: bool = True) -> float:
        """Streaming twin of ``repro_torch.core.lifetime.short_lived_fraction``."""
        _, raw = self.stats(sub)
        return folded_short_lived_fraction(
            raw, self.clock_hz, retention_s,
            weight_by_accesses=weight_by_accesses)
