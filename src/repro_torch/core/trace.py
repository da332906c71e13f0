"""Canonical memory-access trace schema shared by every hardware backend.

A trace is a flat, struct-of-arrays record of memory accesses to one or more
on-chip memory *subpartitions* (paper §5.3): GPU L1/L2 caches, systolic-array
ifmap/filter/ofmap scratchpads, or TPU VMEM. Backends emit this format; the
analytical frontend consumes it without knowing which backend produced it.

Fields (all 1-D arrays of equal length ``n_events``):
  time_cycles   int64   cycle stamp of the access (monotone per subpartition)
  addr          int64   block-granular address (cache line / scratchpad word)
  is_write      bool    store (True) vs load (False)
  hit           bool    cache hit status; always True for scratchpads
  subpartition  int32   which memory the access targets (index into names)

``time_cycles`` and ``addr`` are int64 **by contract**: multi-step streamed
workloads blow past 2**31 cycles (~2.1 s at 1 GHz) and line addresses of
large address spaces exceed 2**31, so every consumer (the lifetime
frontend, the streaming accumulator, the cache simulator) carries them at
64 bits end-to-end rather than silently wrapping.

Scalar metadata:
  clock_hz      float   clock used to convert cycles -> seconds
  block_bits    int     bits per addressable block (e.g. 128 B line = 1024)
  names         tuple   subpartition names, e.g. ("L1", "L2")
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Trace:
    time_cycles: np.ndarray
    addr: np.ndarray
    is_write: np.ndarray
    hit: np.ndarray
    subpartition: np.ndarray
    clock_hz: float = 1.0e9
    block_bits: int = 1024  # 128-byte line
    names: tuple = ("mem",)

    def __post_init__(self):
        n = len(self.time_cycles)
        for f in ("addr", "is_write", "hit", "subpartition"):
            if len(getattr(self, f)) != n:
                raise ValueError(f"trace field {f} length mismatch")

    @property
    def n_events(self) -> int:
        return int(len(self.time_cycles))

    @property
    def duration_s(self) -> float:
        if self.n_events == 0:
            return 0.0
        t = np.asarray(self.time_cycles)
        return float(t.max() - t.min() + 1) / self.clock_hz

    def select(self, sub: int) -> "Trace":
        """Restrict the trace to a single subpartition."""
        m = np.asarray(self.subpartition) == sub
        return Trace(
            time_cycles=np.asarray(self.time_cycles)[m],
            addr=np.asarray(self.addr)[m],
            is_write=np.asarray(self.is_write)[m],
            hit=np.asarray(self.hit)[m],
            subpartition=np.asarray(self.subpartition)[m],
            clock_hz=self.clock_hz,
            block_bits=self.block_bits,
            names=self.names,
        )

    def counts(self):
        w = np.asarray(self.is_write)
        return int((~w).sum()), int(w.sum())  # (reads, writes)


def make_trace(
    time_cycles: Sequence[int],
    addr: Sequence[int],
    is_write: Sequence[bool],
    hit: Sequence[bool] | None = None,
    subpartition: Sequence[int] | None = None,
    clock_hz: float = 1.0e9,
    block_bits: int = 1024,
    names: tuple = ("mem",),
) -> Trace:
    t = np.asarray(time_cycles, dtype=np.int64)
    a = np.asarray(addr, dtype=np.int64)
    w = np.asarray(is_write, dtype=bool)
    h = np.ones_like(w) if hit is None else np.asarray(hit, dtype=bool)
    s = np.zeros(len(t), np.int32) if subpartition is None else np.asarray(
        subpartition, dtype=np.int32)
    return Trace(t, a, w, h, s, clock_hz, block_bits, names)


def concat_traces(traces: Sequence[Trace]) -> Trace:
    """Concatenate traces that share metadata (e.g. per-kernel streams).

    This materializes one flat trace; for long multi-step workloads prefer
    feeding the per-step traces to ``repro_torch.core.accumulate.TraceAccumulator``
    (or ``ProfileSession.profile(..., chunk_events=...)``), which folds
    lifetime statistics chunk by chunk in bounded memory.

    All inputs must agree on ``clock_hz``/``block_bits``/``names``:
    concatenating traces from different clock domains or line geometries
    would silently convert cycles with the wrong clock downstream.
    """
    if not traces:
        raise ValueError("concat_traces needs at least one trace")
    base = traces[0]
    for i, tr in enumerate(traces[1:], start=1):
        for field in ("clock_hz", "block_bits", "names"):
            got, want = getattr(tr, field), getattr(base, field)
            if field == "names":
                got, want = tuple(got), tuple(want)
            if got != want:
                raise ValueError(
                    f"concat_traces metadata mismatch: traces[{i}].{field} "
                    f"= {got!r} != traces[0].{field} = {want!r}")
    return Trace(
        time_cycles=np.concatenate([np.asarray(t.time_cycles) for t in traces]),
        addr=np.concatenate([np.asarray(t.addr) for t in traces]),
        is_write=np.concatenate([np.asarray(t.is_write) for t in traces]),
        hit=np.concatenate([np.asarray(t.hit) for t in traces]),
        subpartition=np.concatenate(
            [np.asarray(t.subpartition) for t in traces]),
        clock_hz=base.clock_hz,
        block_bits=base.block_bits,
        names=base.names,
    )


def chunk_trace(trace: Trace, max_events: int):
    """Split a time-sorted trace into contiguous chunks of at most
    ``max_events`` events.

    Because the split is along the (already time-ordered) event axis, each
    address's events stay time-ordered across chunks, which is exactly the
    contract ``TraceAccumulator.update`` needs for chunked analysis to
    match the monolithic result.  The input is checked for time
    monotonicity eagerly (not at first iteration): an unsorted trace would
    silently break the chunked-vs-monolithic equivalence guarantee.
    """
    if max_events <= 0:
        raise ValueError(f"max_events must be positive, got {max_events}")
    t = np.asarray(trace.time_cycles)
    if len(t) and not (np.diff(t) >= 0).all():
        bad = int(np.argmax(np.diff(t) < 0))
        raise ValueError(
            "chunk_trace requires a time-sorted trace (chunked analysis "
            "only matches the monolithic result when each address's events "
            f"stay time-ordered across chunks); time_cycles decreases at "
            f"event {bad + 1} ({int(t[bad])} -> {int(t[bad + 1])})")
    return _chunk_trace_checked(trace, max_events)


def _chunk_trace_checked(trace: Trace, max_events: int):
    n = trace.n_events
    for lo in range(0, max(n, 1), max_events):
        hi = min(lo + max_events, n)
        yield Trace(
            time_cycles=np.asarray(trace.time_cycles)[lo:hi],
            addr=np.asarray(trace.addr)[lo:hi],
            is_write=np.asarray(trace.is_write)[lo:hi],
            hit=np.asarray(trace.hit)[lo:hi],
            subpartition=np.asarray(trace.subpartition)[lo:hi],
            clock_hz=trace.clock_hz,
            block_bits=trace.block_bits,
            names=trace.names,
        )
        if hi >= n:
            return
