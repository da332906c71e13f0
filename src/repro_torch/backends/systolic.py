"""SCALE-Sim-style systolic-array backend (paper §5.2).

Models an R x C PE systolic array with three peripheral SRAM buffers
(ifmap / filter / ofmap) and generates cycle-stamped memory traces in the
canonical format.  Trace semantics follow the paper exactly:

  - ifmap / filter buffers: DRAM->SRAM fetches are *writes*, SRAM->array
    streaming accesses are *reads*;
  - ofmap buffer: PE->SRAM drains are *writes*, SRAM->DRAM transfers are
    *reads* (write-then-read, hence the short ofmap lifetimes of Fig 10).

Dataflows: is / ws / os.  Mechanisms that shape the lifetime distributions
(Takeaways 7.5/7.6):

  - The *stationary* operand of a tile is block-prefetched while the
    previous tile computes, so its buffer residency spans a full tile
    (long lifetimes under is/ws).
  - *Streamed* operands are fetched just-in-time (half a buffer ahead of
    consumption), giving short lifetimes.
  - Buffers retain data across tiles (direct-mapped residency over the
    buffer's group capacity): operand slices reused by later tiles are
    read again without a refetch, producing the long upper tail.
  - os accumulates in the PEs and never reads partials back, so ofmap data
    is written once and drained immediately (uniformly short).

Event granularity is one SRAM *group* = the row of words feeding one array
edge in one cycle, matching SCALE-Sim's per-cycle SRAM trace rows.

A 128 x 128 array with its scratchpads is also the on-chip model of a
matrix-unit accelerator.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.core.api import ProfileResult, register_backend
from repro_torch.core.trace import Trace, chunk_trace

IFMAP, FILTER, OFMAP = 0, 1, 2
SUB_NAMES = ("ifmap", "filter", "ofmap")


@dataclasses.dataclass(frozen=True)
class SystolicConfig:
    rows: int = 256
    cols: int = 256
    ifmap_kb: int = 4
    filter_kb: int = 4
    ofmap_kb: int = 8
    dataflow: str = "ws"      # "is" | "ws" | "os"
    word_bytes: int = 2
    clock_hz: float = 1.0e9
    drain_latency: int = 16   # cycles between ofmap write and DRAM read

    def cap_groups(self, sub: int) -> int:
        kb = (self.ifmap_kb, self.filter_kb, self.ofmap_kb)[sub]
        width = self.rows if sub == IFMAP else self.cols
        return max(4, (kb * 1024) // (width * self.word_bytes))


@dataclasses.dataclass(frozen=True)
class GemmLayer:
    """One GEMM (transformer format): (M x K) @ (K x N)."""
    name: str
    M: int
    N: int
    K: int


def conv_as_gemm(name: str, out_hw: int, out_c: int, in_c: int,
                 k: int, stride: int = 1) -> GemmLayer:
    """im2col lowering of a conv layer (CNN format -> GEMM format)."""
    oh = max(1, out_hw // stride)
    return GemmLayer(name=name, M=oh * oh, N=out_c, K=k * k * in_c)


class _Buffer:
    """Direct-mapped residency model of one scratchpad buffer."""

    def __init__(self, emitter: "_TraceEmitter", sub: int, cap: int):
        self.b = emitter
        self.sub = sub
        self.cap = cap
        self.occupant = np.full(cap, -1, np.int64)  # data id per slot

    def access(self, data_ids: np.ndarray, read_times: np.ndarray,
               prefetch_time: int | None = None):
        """Read `data_ids` at `read_times`; fetch non-resident ones first.

        prefetch_time: block-prefetch stamp for stationary operands; when
        None, fetches are just-in-time (cap/2 groups ahead of consumption).
        """
        slots = data_ids % self.cap
        need = self.occupant[slots] != data_ids
        if need.any():
            ids_n = data_ids[need]
            if prefetch_time is not None:
                n = int(need.sum())
                wt = prefetch_time + np.arange(n, dtype=np.int64)
            else:
                ahead = max(1, self.cap // 2)
                wt = np.maximum(read_times[need] - ahead, 0)
            self.b.emit(wt, slots[need], True, self.sub)
            self.occupant[slots[need]] = ids_n
        self.b.emit(read_times, slots, False, self.sub)

    def write_then_read(self, data_ids: np.ndarray, write_times: np.ndarray,
                        read_times: np.ndarray | None):
        """ofmap semantics: PE drain writes, optional DRAM-transfer read."""
        slots = data_ids % self.cap
        self.b.emit(write_times, slots, True, self.sub)
        self.occupant[slots] = data_ids
        if read_times is not None:
            self.b.emit(read_times, slots, False, self.sub)

    def read_back(self, data_ids: np.ndarray, read_times: np.ndarray):
        """Partial sums read back (ws/is accumulation across K tiles)."""
        slots = data_ids % self.cap
        self.b.emit(read_times, slots, False, self.sub)


class _TraceEmitter:
    def __init__(self):
        self.t, self.a, self.w, self.s = [], [], [], []

    def emit(self, times, addrs, is_write, sub):
        times = np.asarray(times, np.int64)
        if times.size == 0:
            return
        self.t.append(times)
        self.a.append(np.asarray(addrs, np.int64))
        self.w.append(np.full(times.shape, is_write, bool))
        self.s.append(np.full(times.shape, sub, np.int32))

    def n_events(self):
        return sum(len(x) for x in self.t)

    def build(self, cfg: SystolicConfig) -> Trace:
        t = np.concatenate(self.t) if self.t else np.zeros(0, np.int64)
        a = np.concatenate(self.a) if self.a else np.zeros(0, np.int64)
        w = np.concatenate(self.w) if self.w else np.zeros(0, bool)
        s = np.concatenate(self.s) if self.s else np.zeros(0, np.int32)
        order = np.argsort(t, kind="stable")
        return Trace(
            time_cycles=t[order], addr=a[order], is_write=w[order],
            hit=np.ones(len(t), bool), subpartition=s[order],
            clock_hz=cfg.clock_hz,
            block_bits=cfg.rows * cfg.word_bytes * 8,
            names=SUB_NAMES)


@dataclasses.dataclass
class _LayerIds:
    """Data-group id spaces for one layer (offset to stay globally unique)."""
    if_base: int
    fl_base: int
    of_base: int


def simulate_layer(b, bufs, cfg: SystolicConfig, layer: GemmLayer,
                   t0: int, ids: _LayerIds) -> int:
    R, C = cfg.rows, cfg.cols
    M, N, K = layer.M, layer.N, layer.K
    lat = cfg.drain_latency
    t = t0
    ifb, flb, ofb = bufs

    if cfg.dataflow == "ws":
        # weights stationary: tile over (nt, kt); stream M ifmap rows.
        n_t, k_t = math.ceil(N / C), math.ceil(K / R)
        for nt in range(n_t):
            for kt in range(k_t):
                tile_dur = R + M + C
                # filter tile: R groups, prefetched during previous tile
                fids = ids.fl_base + (nt * k_t + kt) * R + np.arange(R)
                flb.access(fids, t + np.arange(R),
                           prefetch_time=max(t - tile_dur, t0 - R))
                # ifmap rows: M groups of the kt-th K-slice (reused per nt)
                iids = ids.if_base + kt * M + np.arange(M)
                ifb.access(iids, t + R + np.arange(M))
                # ofmap partials: M groups per nt
                oids = ids.of_base + nt * M + np.arange(M)
                drain_t = t + R + np.arange(M) + C
                if kt > 0:
                    ofb.read_back(oids, t + R + np.arange(M))
                ofb.write_then_read(
                    oids, drain_t,
                    drain_t + lat if kt == k_t - 1 else None)
                t += tile_dur

    elif cfg.dataflow == "is":
        # inputs stationary: tile over (mt, kt); stream N weight columns.
        m_t, k_t = math.ceil(M / R), math.ceil(K / C)
        for mt in range(m_t):
            for kt in range(k_t):
                tile_dur = R + N + C
                iids = ids.if_base + (mt * k_t + kt) * R + np.arange(R)
                ifb.access(iids, t + np.arange(R),
                           prefetch_time=max(t - tile_dur, t0 - R))
                # weight slice kt: reused across mt tiles
                fids = ids.fl_base + kt * N + np.arange(N)
                flb.access(fids, t + R + np.arange(N))
                oids = ids.of_base + mt * N + np.arange(N)
                drain_t = t + R + np.arange(N) + C
                if kt > 0:
                    ofb.read_back(oids, t + R + np.arange(N))
                ofb.write_then_read(
                    oids, drain_t,
                    drain_t + lat if kt == k_t - 1 else None)
                t += tile_dur

    elif cfg.dataflow == "os":
        # outputs stationary: tile over (mt, nt); stream K steps; outputs
        # accumulate in the PEs - no partial read-back.
        m_t, n_t = math.ceil(M / R), math.ceil(N / C)
        for mt in range(m_t):
            for nt in range(n_t):
                # ifmap K-groups of row-block mt: reused across nt
                iids = ids.if_base + mt * K + np.arange(K)
                ifb.access(iids, t + np.arange(K))
                # filter K-groups of col-block nt: reused across mt
                fids = ids.fl_base + nt * K + np.arange(K)
                flb.access(fids, t + np.arange(K))
                oids = ids.of_base + (mt * n_t + nt) * C + np.arange(C)
                drain_t = t + K + R + np.arange(C)
                ofb.write_then_read(oids, drain_t, drain_t + lat)
                t += K + R + C

    else:
        raise ValueError(f"unknown dataflow {cfg.dataflow!r}")

    return t


def simulate(layers: Sequence[GemmLayer],
             cfg: SystolicConfig) -> tuple[Trace, list[dict]]:
    """Simulate a workload; returns (trace, per-layer kernel stats).

    Per-layer stats (cycles/events/flops) feed PKA sampling and the
    frontend's per-kernel analysis.
    """
    b = _TraceEmitter()
    bufs = (_Buffer(b, IFMAP, cfg.cap_groups(IFMAP)),
            _Buffer(b, FILTER, cfg.cap_groups(FILTER)),
            _Buffer(b, OFMAP, cfg.cap_groups(OFMAP)))
    t = 0
    next_id = [0, 0, 0]
    kstats = []
    for layer in layers:
        start_events = b.n_events()
        start_t = t
        ids = _LayerIds(*next_id)
        t = simulate_layer(b, bufs, cfg, layer, t, ids)
        # advance id spaces past this layer's groups
        next_id[0] += layer.K * layer.M + cfg.rows * 16  # guard band
        next_id[1] += layer.K * layer.N + cfg.cols * 16
        next_id[2] += layer.M * layer.N + cfg.cols * 16
        kstats.append({
            "name": layer.name, "M": layer.M, "N": layer.N, "K": layer.K,
            "cycles": t - start_t, "events": b.n_events() - start_events,
            "flops": 2 * layer.M * layer.N * layer.K,
        })
    return b.build(cfg), kstats


@register_backend("systolic")
class SystolicBackend:
    """Registry adapter for the systolic-array simulator.

    Workload: a sequence of :class:`GemmLayer`.  Config kwargs are the
    :class:`SystolicConfig` fields (or pass ``config=SystolicConfig(...)``
    directly).  ``chunk_events=N`` streams the trace to the frontend in
    N-event chunks instead of one flat array.
    """
    name = "systolic"
    mode = "scratchpad"

    def run(self, workload, *, config: SystolicConfig | None = None,
            chunk_events: int | None = None, **cfg) -> ProfileResult:
        scfg = config if config is not None else SystolicConfig(**cfg)
        trace, kstats = simulate(list(workload), scfg)
        if chunk_events:
            return ProfileResult(chunks=chunk_trace(trace, chunk_events),
                                 kernels=kstats, mode=self.mode)
        return ProfileResult(trace=trace, kernels=kstats, mode=self.mode)
