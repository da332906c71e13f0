"""The ``lifetime_scan`` kernel: wrapper, plain PyTorch version, launch count.

Contract (inputs already sorted by (addr, time); the sort stays outside, in
``ops.py``):

  t      int64 [N]     cycle stamps
  addr   int64 [N]     block addresses
  w      bool  [N]     True = write
  edges  int64 [NB+1]  ascending integer bin edges (``ops.integer_edges``)

  hist   int64 [NB]    live lifetimes with ``edges[k] <= lt < edges[k+1]``
  stats  int64 [8]     (live, orphans, sum_lt, max_lt, reads, writes, 0, 0)

A segment starts at a new address or at a write and runs to the next
boundary or the end of the stream.  With at least one read it is a live
lifetime of (last read - first event) cycles; with none it is an orphan.

:func:`lifetime_scan_sorted` is the wrapper: on CUDA tensors it launches
the hand-written kernel (``csrc/lifetime_scan.cu``, built at first use) or
raises; on CPU tensors it runs :func:`lifetime_scan_plain`, the same
function in stock torch ops, which is also what the tests and the on-card
comparison hold the kernel against.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

MAX_BINS = 2048          # edges + histogram must fit static shared memory
_BLOCKS_PER_SM = 8       # persistent grid: 8 x 256 threads fill an SM

_I64_MIN = torch.iinfo(torch.int64).min


def lifetime_scan_plain(t: torch.Tensor, addr: torch.Tensor,
                        w: torch.Tensor, edges: torch.Tensor):
    """Plain PyTorch version of the kernel (any device)."""
    n = t.shape[0]
    n_bins = edges.shape[0] - 1
    dev = t.device
    hist = torch.zeros(n_bins, dtype=torch.int64, device=dev)
    stats = torch.zeros(8, dtype=torch.int64, device=dev)
    if n == 0:
        return hist, stats
    boundary = torch.ones(n, dtype=torch.bool, device=dev)
    boundary[1:] = (addr[1:] != addr[:-1]) | w[1:]
    seg = torch.cumsum(boundary, 0) - 1
    n_seg = int(seg[-1]) + 1
    read = ~w

    def seg_reduce(src, reduce, init):
        out = torch.full((n_seg,), init, dtype=torch.int64, device=dev)
        return out.scatter_reduce_(0, seg, src, reduce, include_self=True)

    start = t[boundary]       # events are time-sorted within an address
    last_read = seg_reduce(torch.where(read, t, _I64_MIN), "amax", _I64_MIN)
    n_reads = seg_reduce(read.to(torch.int64), "sum", 0)
    live = n_reads > 0
    lt = (last_read - start)[live]
    # right=True: index i with edges[i-1] <= lt < edges[i], so bin = i - 1
    bins = torch.bucketize(lt, edges, right=True) - 1
    bins = bins[(bins >= 0) & (bins < n_bins)]
    hist += torch.bincount(bins, minlength=n_bins)
    n_writes = int(w.sum())
    stats[0] = live.sum()
    stats[1] = n_seg - stats[0]
    if lt.numel():
        stats[2] = lt.sum()
        stats[3] = lt.max().clamp_min(0)
    stats[4] = n - n_writes
    stats[5] = n_writes
    return hist, stats


def _check(name: str, x: torch.Tensor, dtype: torch.dtype,
           device: torch.device, length: int | None = None) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"{name} must be 1-D and contiguous")
    if length is not None and x.shape[0] != length:
        raise ValueError(
            f"{name} has {x.shape[0]} elements, expected {length}")


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load_library("lifetime_scan").lifetime_scan_launch
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_longlong, ctypes.c_int,
                   ptr, ptr, ctypes.c_int, ptr]
    fn.restype = ctypes.c_int
    return fn


def lifetime_scan_sorted(t: torch.Tensor, addr: torch.Tensor,
                         w: torch.Tensor, edges: torch.Tensor):
    """(hist [NB], stats [8]) of a sorted event stream; see the module
    docstring.  CUDA tensors go to the kernel, CPU tensors to the plain
    version; there is no fallback from one to the other."""
    dev = t.device
    n = t.shape[0]
    _check("t", t, torch.int64, dev)
    _check("addr", addr, torch.int64, dev, n)
    _check("w", w, torch.bool, dev, n)
    _check("edges", edges, torch.int64, dev)
    n_bins = edges.shape[0] - 1
    if not 1 <= n_bins <= MAX_BINS:
        raise ValueError(f"need 1..{MAX_BINS} bins, got {n_bins}")
    if dev.type == "cpu":
        return lifetime_scan_plain(t, addr, w, edges)
    if dev.type != "cuda":
        raise ValueError(f"lifetime_scan runs on cuda or cpu, not {dev}")

    hist = torch.zeros(n_bins, dtype=torch.int64, device=dev)
    stats = torch.zeros(8, dtype=torch.int64, device=dev)
    if n == 0:
        return hist, stats
    launch = _launcher()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(t.data_ptr(), addr.data_ptr(), w.data_ptr(),
                     edges.data_ptr(), n, n_bins, hist.data_ptr(),
                     stats.data_ptr(), sms * _BLOCKS_PER_SM, stream)
    lifetime_scan_sorted.launches += 1
    if err != 0:
        raise RuntimeError(
            f"lifetime_scan kernel launch failed: CUDA error {err}")
    return hist, stats


lifetime_scan_sorted.launches = 0
