"""The ``cache_replay`` kernel: wrapper, plain PyTorch version, launch count.

Contract (one cache level; the stream already partitioned by set, the
partition stays outside, in ``ops.py``):

  packed   int64 [N]       ``line_addr * 2 + is_write``, stably sorted by
                           set (``line_addr % n_sets``), line addresses in
                           ``[0, 2^59)``
  offsets  int64 [n_sets]  where each set's accesses start in ``packed``
  counts   int64 [n_sets]  how many accesses each set has

  out      int64 [N]       per access, in the same layout:
                           ``(evict_addr + 1) << 3 | evict_dirty << 2 |
                           fill << 1 | hit``

Each set replays its accesses in order through a ``ways``-wide LRU
write-back state: a hit refreshes its way (and dirties it on a write); a
miss that allocates (every miss under write-allocate, read misses only
otherwise) fills the least recently touched way, untouched ways in index
order first, and reports the line it evicts (``-1`` for an invalid way) and
whether that line was dirty.  This is the reference's
``_simulate_cache_sets`` (``src/repro/backends/cachesim.py``) on a compact
layout: no padding of every set to a common length.

:func:`cache_replay_sorted` is the wrapper: on CUDA tensors it launches the
hand-written kernels (``csrc/cache_replay.cu``, built at first use; one
wrapper call counted in ``.launches``; ``ways`` up to :data:`MAX_WAYS`) or
raises; on CPU tensors it runs :func:`cache_replay_plain`, the same
function in stock torch ops (an eager loop over slots, vectorised over
sets, as the reference's scan steps), which is also what the tests and the
on-card comparison hold the kernels against.  ``cache_replay_plain.calls``
counts the plain version's calls.  The write policy alone picks the
design: under write-allocate the split replay (chunks of
:func:`split_length` accesses replayed in parallel, three CUDA launches a
call), otherwise the per-set chain (one launch); the source note says why
the split is exact only under write-allocate.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from repro_torch.kernels import _build

MAX_WAYS = 32            # csrc: one 32-bit word of dirty bits per set
# the split replay's chunks hold at least this many accesses per way, so
# that a chunk's lists (at most `ways` lines) stay small beside its replay
SPLIT_MIN_PER_WAY = 4


def split_length(n: int, ways: int, n_sms: int, resident_warps: int) -> int:
    """Accesses per chunk of the split replay: just enough that one chunk a
    lane fills each of the card's ``n_sms * resident_warps`` resident warps
    of the replay kernel once, and at least ``SPLIT_MIN_PER_WAY * ways``."""
    lanes = n_sms * resident_warps * 32
    return max(SPLIT_MIN_PER_WAY * ways, -(-n // lanes))


def cache_replay_plain(packed: torch.Tensor, offsets: torch.Tensor,
                       counts: torch.Tensor, ways: int,
                       write_allocate: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device).

    Step ``j`` replays slot ``j`` of every set that has one.  The state
    follows the reference's scan: ``T`` packs ``tag * 2 + dirty`` (-2 for
    an invalid way), ``key`` is the unique recency key ``clock * ways +
    way`` (initial keys 0..ways-1 pick untouched ways in index order).
    """
    cache_replay_plain.calls += 1
    dev = packed.device
    n, n_sets = packed.shape[0], counts.shape[0]
    out = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return out
    i64 = torch.int64
    T = torch.full((n_sets, ways), -2, dtype=i64, device=dev)
    way_iota = torch.arange(ways, dtype=i64, device=dev)
    key = way_iota.expand(n_sets, ways).clone()
    clockw = ways
    for j in range(int(counts.max())):
        valid = counts > j
        idx = torch.where(valid, offsets + j, 0)
        v = packed[idx]
        addr, w = v >> 1, (v & 1).bool()
        alloc_ok = valid if write_allocate else valid & ~w
        match = (T >> 1) == addr[:, None]
        raw_hit = match.any(1)
        hit = raw_hit & valid
        victim = key == key.amin(1, keepdim=True)
        allocate = alloc_ok & ~raw_hit
        woh = torch.where(raw_hit[:, None], match, victim)
        upd = woh & (hit | allocate)[:, None]
        selv = (T * woh).sum(1)             # the selected way's tag|dirty
        cur_dirty = (selv & 1).bool()
        evict_addr = torch.where(allocate & (selv >= 0), selv >> 1, -1)
        evict_dirty = allocate & cur_dirty & (selv >= 0)
        new_dirty = w | (cur_dirty & hit)
        T = torch.where(upd, (addr * 2 + new_dirty)[:, None], T)
        key = torch.where(upd, clockw + way_iota, key)
        word = (((evict_addr + 1) << 3) | (evict_dirty.to(i64) << 2)
                | (allocate.to(i64) << 1) | hit.to(i64))
        out[idx[valid]] = word[valid]
        clockw += ways
    return out


cache_replay_plain.calls = 0


def _check(name: str, x: torch.Tensor, device: torch.device,
           length: int | None = None) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.int64:
        raise TypeError(f"{name} has dtype {x.dtype}, expected int64")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"{name} must be 1-D and contiguous")
    if length is not None and x.shape[0] != length:
        raise ValueError(
            f"{name} has {x.shape[0]} elements, expected {length}")


@functools.lru_cache(maxsize=None)
def _launcher():
    """The built library of ``csrc/cache_replay.cu``, its entry points
    typed: the chain's launch and the split replay's launch, scratch size
    and occupancy query."""
    lib = _build.load_library("cache_replay")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.cache_replay_launch.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32,
                                        ptr]
    lib.cache_replay_launch.restype = i32
    lib.cache_replay_split_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, i64,
                                              i32, i32, i32, ptr]
    lib.cache_replay_split_launch.restype = i32
    lib.cache_replay_split_scratch_bytes.argtypes = [i64, i32, i32]
    lib.cache_replay_split_scratch_bytes.restype = i64
    lib.cache_replay_split_resident_warps.argtypes = [i32]
    lib.cache_replay_split_resident_warps.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _resident_warps(device_index: int, ways: int) -> int:
    with torch.cuda.device(device_index):
        warps = _launcher().cache_replay_split_resident_warps(ways)
    if warps <= 0:
        raise RuntimeError(f"cache_replay: occupancy query failed: CUDA "
                           f"error {-warps}")
    return warps


def split_plan(n: int, ways: int, device) -> tuple[int, int]:
    """``(S, chunks)`` of the split replay of ``n`` accesses on a CUDA
    device: the chunk length :func:`split_length` picks from the device's
    SM count and the replay kernel's resident warps, and the chunk count."""
    device = torch.device(device)
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    n_sms = torch.cuda.get_device_properties(index).multi_processor_count
    S = split_length(n, ways, n_sms, _resident_warps(index, ways))
    return S, -(-n // S)


def cache_replay_sorted(packed: torch.Tensor, offsets: torch.Tensor,
                        counts: torch.Tensor, ways: int,
                        write_allocate: bool) -> torch.Tensor:
    """Per-access result words of one level in the set-sorted layout; see
    the module docstring.  CUDA tensors go to the kernels (the split replay
    under write-allocate, the per-set chain otherwise), CPU tensors to the
    plain version; there is no fallback from one to another."""
    dev = packed.device
    _check("packed", packed, dev)
    _check("offsets", offsets, dev)
    _check("counts", counts, dev, offsets.shape[0])
    if ways < 1:
        raise ValueError(f"ways must be at least 1, got {ways}")
    if dev.type == "cpu":
        return cache_replay_plain(packed, offsets, counts, ways,
                                  write_allocate)
    if dev.type != "cuda":
        raise ValueError(f"cache_replay runs on cuda or cpu, not {dev}")
    if ways > MAX_WAYS:
        raise ValueError(f"the cache_replay kernel takes up to {MAX_WAYS} "
                         f"ways, got {ways}")
    n, n_sets = packed.shape[0], offsets.shape[0]
    if n >= 2 ** 31 or n_sets >= 2 ** 31:
        # both designs keep step indices, stamps and counts in 32 bits
        raise ValueError(f"cache_replay takes under 2^31 accesses and "
                         f"sets, got {n} and {n_sets}")
    out = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return out
    with (torch.cuda.device(dev) if dev.index != torch.cuda.current_device()
          else contextlib.nullcontext()):
        lib = _launcher()
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        if write_allocate:
            S, _ = split_plan(n, ways, dev)
            scratch = torch.empty(
                lib.cache_replay_split_scratch_bytes(n, ways, S),
                dtype=torch.uint8, device=dev)
            err = lib.cache_replay_split_launch(
                packed.data_ptr(), offsets.data_ptr(), counts.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), n, n_sets, ways, S,
                stream)
        else:
            err = lib.cache_replay_launch(
                packed.data_ptr(), offsets.data_ptr(), counts.data_ptr(),
                out.data_ptr(), n_sets, ways, 0, stream)
    cache_replay_sorted.launches += 1
    if err != 0:
        raise RuntimeError(
            f"cache_replay kernel launch failed: CUDA error {err}")
    return out


cache_replay_sorted.launches = 0
