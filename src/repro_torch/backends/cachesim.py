"""Set-associative L1/L2 data-cache simulator (paper §5.1).

Replaces the Accel-Sim GPU backend: address streams (from
``repro_torch.backends.opstream`` or any other source) are replayed through
a two-level write-back cache hierarchy modeled after an H100 SM slice:
configurable size / associativity / line size, LRU replacement, and the
write-allocation policy ablation of §5.1.2 / §7.1.6.

Two implementations of the per-level replay exist:

  ``set_parallel`` (default)
      Accesses to different cache sets are independent in a
      set-associative cache, so the level's stream goes to the torch
      ``device``, is stably sorted by set there, replayed by the
      hand-written ``cache_replay`` kernels (one wrapper call per level;
      under write-allocate the split replay, which also cuts each set's
      stream in time, otherwise one chain per set; on a CPU tensor the
      plain PyTorch version), and the per-access results are put back
      into stream order and copied to the host.  The kernels read the
      compact set-sorted stream: there is no padding of every set to a
      common length and no fallback for a stream skewed onto a few sets.

  ``scalar``
      One access at a time over the whole ``(n_sets, ways)`` state, in a
      plain Python loop on the host.  Kept as the differential oracle: the
      set-parallel simulator is bit-for-bit identical to it.  It is only
      run when a caller names it.

Select via ``HierarchyConfig(simulator="scalar")`` (or the ``simulator=``
kwarg through ``ProfileSession("gpu")`` / ``CacheHierarchyBackend.run``).

Cycle stamps and line addresses are int64 end to end, matching the trace
contract of ``repro_torch.core.trace``.

L2 stream composition (write-back hierarchy), in numpy on the host:
  - L1 read misses and (under write-allocate) L1 write misses fetch the
    line from L2  -> L2 *read* access;
  - dirty L1 evictions write back           -> L2 *write* access;
  - under no-write-allocate, L1 write misses bypass to L2 -> L2 *write*.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.api import ProfileResult, register_backend
from repro_torch.core.trace import Trace, chunk_trace
from repro_torch.device import resolve_device
from repro_torch.kernels.cache_replay.ops import cache_replay, decode

L1, L2 = 0, 1
SUB_NAMES = ("L1", "L2")

SIMULATORS = ("set_parallel", "scalar")


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    size_kb: int = 128
    ways: int = 8
    line_bytes: int = 128

    @property
    def n_sets(self) -> int:
        return max(1, (self.size_kb * 1024) // (self.line_bytes * self.ways))


@dataclasses.dataclass(frozen=True)
class HierarchyConfig:
    l1: CacheConfig = CacheConfig(size_kb=128, ways=8)
    l2: CacheConfig = CacheConfig(size_kb=4096, ways=16)
    write_allocate: bool = True
    clock_hz: float = 1.0e9
    l2_latency: int = 30  # cycles added to L2 access stamps
    simulator: str = "set_parallel"  # or "scalar" (differential oracle)


def _simulate_cache(line_addr, is_write, n_sets, ways, write_allocate):
    """Scalar oracle: one access per step over one cache level, on the host.

    Returns numpy (hit, fill, evict_addr, evict_dirty):
    fill:        line was allocated (miss that fetched from next level)
    evict_addr:  address of a line evicted by the fill (-1 if none/invalid)
    evict_dirty: evicted line was dirty (needs write-back)
    LRU by a clock stamped on every touch; the victim is the least stamp,
    the lowest way on ties (untouched ways hold stamp 0).
    """
    _simulate_cache.calls += 1
    lines = np.asarray(line_addr, np.int64)
    writes = np.asarray(is_write, bool)
    n = lines.shape[0]
    hit = np.zeros(n, bool)
    fill = np.zeros(n, bool)
    evict_addr = np.full(n, -1, np.int64)
    evict_dirty = np.zeros(n, bool)
    tags = [[-1] * ways for _ in range(n_sets)]
    dirty = [[False] * ways for _ in range(n_sets)]
    stamp = [[0] * ways for _ in range(n_sets)]
    for i, (addr, w) in enumerate(zip(lines.tolist(), writes.tolist())):
        s = addr % n_sets
        row, drow, srow = tags[s], dirty[s], stamp[s]
        if addr in row:
            way = row.index(addr)
            hit[i] = True
            drow[way] = w or drow[way]
        elif write_allocate or not w:
            way = srow.index(min(srow))
            fill[i] = True
            evict_addr[i] = row[way]
            evict_dirty[i] = drow[way] and row[way] >= 0
            row[way], drow[way] = addr, w
        else:
            continue
        srow[way] = i + 1
    return hit, fill, evict_addr, evict_dirty


_simulate_cache.calls = 0


def _simulate_cache_set_parallel(line_addr, is_write, n_sets, ways,
                                 write_allocate, device=None):
    """Set-parallel replay of one cache level on ``device``; host arrays in
    and out, in stream order.

    Returns numpy (hit, fill, evict_addr, evict_dirty) bit-for-bit
    identical to the scalar oracle's.  ``device=None`` is the CUDA device
    (raises without one).
    """
    lines = np.asarray(line_addr, np.int64)
    w = np.asarray(is_write, bool)
    n = lines.shape[0]
    if n == 0:
        return (np.zeros(0, bool), np.zeros(0, bool),
                np.zeros(0, np.int64), np.zeros(0, bool))
    if int(lines.min()) < 0 or int(lines.max()) >= 2 ** 59:
        raise OverflowError(
            "cachesim line addresses must lie in [0, 2^59) "
            f"(got [{int(lines.min())}, {int(lines.max())}]); that is "
            "byte addresses below 2^66 at 128-byte lines")
    dev = resolve_device(device)
    words = cache_replay(torch.from_numpy(lines).to(dev),
                         torch.from_numpy(w).to(dev), n_sets, ways,
                         write_allocate)
    return decode(words.cpu().numpy())


def _simulate_level(lines, w, level: CacheConfig, write_allocate: bool,
                    simulator: str, device=None):
    """Dispatch one cache level to the selected simulator (host arrays)."""
    if simulator == "set_parallel":
        return _simulate_cache_set_parallel(
            lines, w, level.n_sets, level.ways, write_allocate, device)
    if simulator == "scalar":
        return _simulate_cache(lines, w, level.n_sets, level.ways,
                               write_allocate)
    raise ValueError(
        f"unknown simulator {simulator!r}; available: {SIMULATORS}")


def l2_stream(t, lines, w, l1_result, cfg: HierarchyConfig):
    """The L2 access stream ``(time_cycles, line_addr, is_write)`` that L1's
    results imply, in time order (host numpy)."""
    hit1, fill1, ev_addr, ev_dirty = l1_result
    l2_t, l2_a, l2_w = [], [], []
    # fills: L1 fetched the line from L2 (read)
    l2_t.append(t[fill1] + cfg.l2_latency)
    l2_a.append(lines[fill1])
    l2_w.append(np.zeros(int(fill1.sum()), bool))
    # dirty evictions: write-back to L2
    m = ev_dirty & (ev_addr >= 0)
    l2_t.append(t[m] + cfg.l2_latency)
    l2_a.append(ev_addr[m].astype(np.int64))
    l2_w.append(np.ones(int(m.sum()), bool))
    # no-write-allocate: write misses bypass to L2
    if not cfg.write_allocate:
        m = w & ~hit1
        l2_t.append(t[m] + cfg.l2_latency)
        l2_a.append(lines[m])
        l2_w.append(np.ones(int(m.sum()), bool))
    l2_t = np.concatenate(l2_t)
    l2_a = np.concatenate(l2_a)
    l2_w = np.concatenate(l2_w)
    order = np.argsort(l2_t, kind="stable")
    return l2_t[order], l2_a[order], l2_w[order]


def merge_levels(t, lines, w, hit1, l2, hit2, cfg: HierarchyConfig) -> Trace:
    """The two-subpartition trace of both levels, in time order."""
    l2_t, l2_a, l2_w = l2
    times = np.concatenate([t, l2_t])
    addrs = np.concatenate([lines, l2_a])
    writes = np.concatenate([w, l2_w])
    hits = np.concatenate([np.asarray(hit1), np.asarray(hit2)])
    subs = np.concatenate([np.zeros(len(t), np.int32),
                           np.ones(len(l2_t), np.int32)])
    order = np.argsort(times, kind="stable")
    return Trace(
        time_cycles=times[order], addr=addrs[order], is_write=writes[order],
        hit=hits[order], subpartition=subs[order],
        clock_hz=cfg.clock_hz, block_bits=cfg.l1.line_bytes * 8,
        names=SUB_NAMES)


def simulate_hierarchy(
    time_cycles: np.ndarray,
    byte_addr: np.ndarray,
    is_write: np.ndarray,
    cfg: HierarchyConfig = HierarchyConfig(),
    device=None,
) -> Trace:
    """Replay a byte-address stream through L1 -> L2; emit a two-subpartition
    trace in the canonical format (line-granular addresses).  The
    set-parallel replay runs on ``device`` (``None`` = the CUDA device)."""
    t = np.asarray(time_cycles, np.int64)
    lines = (np.asarray(byte_addr, np.int64) // cfg.l1.line_bytes)
    w = np.asarray(is_write, bool)

    l1 = _simulate_level(lines, w, cfg.l1, cfg.write_allocate,
                         cfg.simulator, device)
    l2 = l2_stream(t, lines, w, l1, cfg)
    hit2 = _simulate_level(l2[1], l2[2], cfg.l2, cfg.write_allocate,
                           cfg.simulator, device)[0]
    return merge_levels(t, lines, w, l1[0], l2, hit2, cfg)


def stream_of(workload, sample: int = 1):
    """``((time_cycles, byte_addr, is_write), kernels)`` of a workload in
    any of the forms :class:`CacheHierarchyBackend` takes."""
    if hasattr(workload, "finish"):
        return workload.finish(), [k.__dict__ for k in workload.kernels]
    if callable(workload):
        from repro_torch.backends.opstream import StreamBuilder
        sb = StreamBuilder(sample=sample)
        workload(sb)
        return sb.finish(), [k.__dict__ for k in sb.kernels]
    return workload, []


@register_backend("cachesim", aliases=("gpu",))
class CacheHierarchyBackend:
    """Registry adapter for the L1/L2 cache hierarchy (alias: "gpu").

    Workload forms:
      - ``(time_cycles, byte_addr, is_write)`` arrays to replay directly,
      - a filled ``opstream.StreamBuilder`` (anything with ``.finish()``),
      - a callable op program ``fn(sb)`` lowered onto a fresh builder
        (``sample=`` controls its line sampling).

    Config kwargs are the :class:`HierarchyConfig` fields (or pass
    ``config=HierarchyConfig(...)``); ``simulator="set_parallel"``
    (default) or ``"scalar"`` picks the per-level replay implementation.
    ``chunk_events=N`` streams the hit-annotated trace to the frontend in
    N-event chunks.  ``device`` is the torch device of the set-parallel
    replay (``None`` = the CUDA device; raises without one).
    """
    name = "cachesim"
    mode = "cache"

    def run(self, workload, *, config: HierarchyConfig | None = None,
            sample: int = 1, chunk_events: int | None = None,
            device=None, **cfg) -> ProfileResult:
        dev = resolve_device(device)
        (t, a, w), kernels = stream_of(workload, sample)
        if config is not None and cfg:
            raise ValueError(
                "pass either config=HierarchyConfig(...) or field kwargs "
                f"({sorted(cfg)}), not both - the kwargs would be "
                "silently ignored")
        hcfg = config if config is not None else HierarchyConfig(**cfg)
        if hcfg.simulator not in SIMULATORS:
            raise ValueError(
                f"unknown simulator {hcfg.simulator!r}; "
                f"available: {SIMULATORS}")
        trace = simulate_hierarchy(t, a, w, hcfg, device=dev)
        if chunk_events:
            return ProfileResult(chunks=chunk_trace(trace, chunk_events),
                                 kernels=kernels, mode=self.mode)
        return ProfileResult(trace=trace, kernels=kernels, mode=self.mode)
