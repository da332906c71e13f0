"""The range decomposition of the lifetime-scan kernel, emulated on the CPU.

``csrc/lifetime_scan.cu`` cuts the sorted event stream into slices that
are walked in order, one per warp, eight to a block.  A slice closes every
segment whose start it holds and leaves a summary: where the segment that
entered it ends, if it ends there (its head), and the start of the segment
still open at its end (its tail).  Each block joins its slices' summaries
in order, the last block joins the blocks', and the stream's last segment
closes at its last event.  Nothing walks back through the stream.

``emulate_ranges`` does the same in plain torch with slices of ``r``
events, and is held exactly (int64) against ``lifetime_scan_plain`` and
against the reference's Pallas kernel in interpret mode (hist and counts
exactly, ``sum_lt``/``max_lt`` within rtol 1e-4 of its f32 aggregates, as
``tests/test_torch_lifetime_scan.py`` holds the plain version).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import pytest
import torch

from repro.kernels.lifetime_scan import ops as ref_ops
from repro_torch.kernels.lifetime_scan.kernel import lifetime_scan_plain
from repro_torch.kernels.lifetime_scan.ops import (default_edges,
                                                   integer_edges)

SLICES_PER_BLOCK = 8          # warps per block in the kernel
COUNTS = [0, 1, 4, 5]         # live, orphans, reads, writes
EDGES = default_edges(16, 1, 1e6)


@dataclass
class Summary:
    """As ``struct Summary`` in the kernel; -1 marks "none"."""
    head_end: int = -1
    head_end_t: int = 0
    tail_key: int = -1        # (start index << 1) | start is a read
    tail_t: int = 0


def _close(key, start_t, end, end_t):
    """(live, lifetimes) of segments from the keyed starts to ``end``."""
    n_reads = (end - (key >> 1)) + (key & 1)
    live = n_reads > 0
    return live, (end_t - start_t)[live]


def _slice(t, w, boundary, r0, r1):
    """Closings whose start lies in [r0, r1), and the slice's summary."""
    b = torch.nonzero(boundary[r0:r1]).flatten() + r0
    key = (b << 1) | (~w[b]).to(torch.int64)
    # each boundary after the slice's first closes the segment before it
    live, lts = _close(key[:-1], t[b[:-1]], b[1:] - 1, t[b[1:] - 1])
    s = Summary()
    if len(b) and int(b[0]) > 0:      # the entering segment ends here
        s.head_end, s.head_end_t = int(b[0]) - 1, int(t[int(b[0]) - 1])
    if len(b):
        s.tail_key, s.tail_t = int(key[-1]), int(t[int(b[-1])])
    return s, int(live.sum()), int((~live).sum()), lts


def _join(summaries):
    """The summaries of consecutive ranges, joined in order: one summary
    and the closings of the segments that cross between them, as
    (start key, start time, end, end time)."""
    out, crossing = Summary(), []
    for s in summaries:
        if s.head_end >= 0:
            if out.tail_key >= 0:
                crossing.append((out.tail_key, out.tail_t, s.head_end,
                                 s.head_end_t))
            else:
                out.head_end, out.head_end_t = s.head_end, s.head_end_t
        if s.tail_key >= 0:
            out.tail_key, out.tail_t = s.tail_key, s.tail_t
    return out, crossing


def emulate_ranges(t, addr, w, edges, r):
    """(hist [NB], stats [8]) of a sorted stream through slices of ``r``
    events, eight slices to a block, as the CUDA kernel computes them."""
    n = t.shape[0]
    n_bins = edges.shape[0] - 1
    hist = torch.zeros(n_bins, dtype=torch.int64)
    stats = torch.zeros(8, dtype=torch.int64)
    if n == 0:
        return hist, stats
    boundary = torch.ones(n, dtype=torch.bool)
    boundary[1:] = (addr[1:] != addr[:-1]) | w[1:]

    live, orphans, lts = 0, 0, []
    slices = []
    for r0 in range(0, n, r):
        s, n_live, n_orphans, lt = _slice(t, w, boundary, r0,
                                          min(n, r0 + r))
        slices.append(s)
        live, orphans, lts = live + n_live, orphans + n_orphans, lts + [lt]
    blocks, crossing = [], []
    for k in range(0, len(slices), SLICES_PER_BLOCK):
        s, c = _join(slices[k:k + SLICES_PER_BLOCK])
        blocks.append(s)
        crossing += c
    stream, c = _join(blocks)
    crossing += c
    # the stream's last segment closes at its last event
    crossing.append((stream.tail_key, stream.tail_t, n - 1, int(t[-1])))

    c = torch.tensor(crossing, dtype=torch.int64).reshape(-1, 4)
    c_live, c_lt = _close(c[:, 0], c[:, 1], c[:, 2], c[:, 3])
    live += int(c_live.sum())
    orphans += int((~c_live).sum())
    lt = torch.cat(lts + [c_lt])
    bins = torch.bucketize(lt, edges, right=True) - 1
    hist += torch.bincount(bins[(bins >= 0) & (bins < n_bins)],
                           minlength=n_bins)
    n_writes = int(w.sum())
    stats[:6] = torch.tensor([live, orphans, int(lt.sum()),
                              int(lt.max()) if lt.numel() else 0,
                              n - n_writes, n_writes])
    return hist, stats


def _sorted(t, a, w):
    order = np.lexsort((t, a))
    return t[order], a[order], w[order]


def _random(n, n_addrs, p_write, seed):
    rng = np.random.RandomState(seed)
    return _sorted(np.sort(rng.randint(0, 10 * n + 1, n)).astype(np.int64),
                   rng.randint(0, n_addrs, n).astype(np.int64),
                   rng.rand(n) < p_write)


def _segments_of(n, length, shift):
    """Segments of exactly ``length`` events: a write at index
    ``shift`` mod ``length``, then reads of the same address."""
    i = np.arange(n, dtype=np.int64)
    return 3 * i + 7, (i - shift) // length + 11, (i - shift) % length == 0


CASES = {
    "random": lambda: _random(1000, 37, 0.35, 0),
    "random_few_addresses": lambda: _random(777, 3, 0.05, 1),
    # one write, then only reads: a segment that spans every slice
    "one_long_segment": lambda: (np.arange(1500, dtype=np.int64) * 5 + 2,
                                 np.full(1500, 4, np.int64),
                                 np.arange(1500) == 0),
    "reads_only": lambda: _random(900, 5, 0.0, 2),
    "writes_only": lambda: _random(600, 7, 1.0, 3),
    # boundaries exactly at the starts of 256-event slices, and one later
    "boundary_at_range_start": lambda: _segments_of(768, 256, 0),
    "boundary_after_range_start": lambda: _segments_of(769, 256, 1),
    "n0": lambda: (np.zeros(0, np.int64), np.zeros(0, np.int64),
                   np.zeros(0, bool)),
    "n1_read": lambda: (np.array([9], np.int64), np.array([2], np.int64),
                        np.array([False])),
    "n1_write": lambda: (np.array([9], np.int64), np.array([2], np.int64),
                         np.array([True])),
}
# slice lengths, by the stream's length n (at least one event)
RANGES = {"1": lambda n: 1, "2": lambda n: 2, "7": lambda n: 7,
          "256": lambda n: 256, "n-1": lambda n: n - 1, "n": lambda n: n,
          "n+1": lambda n: n + 1}


def _range_length(name, n):
    return max(1, RANGES[name](n))


def _torch_case(name):
    t, a, w = CASES[name]()
    return (torch.from_numpy(np.asarray(t, np.int64)),
            torch.from_numpy(np.asarray(a, np.int64)),
            torch.from_numpy(np.asarray(w, bool)),
            torch.from_numpy(integer_edges(EDGES)))


@functools.lru_cache(maxsize=None)
def _pallas(name):
    t, a, w = CASES[name]()
    h, s = ref_ops.lifetime_histogram(t, a, w.astype(np.int32), EDGES)
    return np.asarray(h), np.asarray(s)


@pytest.mark.parametrize("r_name", list(RANGES))
@pytest.mark.parametrize("case", list(CASES))
def test_ranges_match_plain_exactly(case, r_name):
    t, a, w, e = _torch_case(case)
    r = _range_length(r_name, t.shape[0])
    hist, stats = emulate_ranges(t, a, w, e, r)
    h_p, s_p = lifetime_scan_plain(t, a, w, e)
    assert hist.tolist() == h_p.tolist()
    assert stats.tolist() == s_p.tolist()


@pytest.mark.parametrize("case", list(CASES))
def test_ranges_match_pallas_kernel(case):
    t, a, w, e = _torch_case(case)
    h_k, s_k = _pallas(case)
    for r_name in RANGES:
        hist, stats = emulate_ranges(t, a, w, e,
                                     _range_length(r_name, t.shape[0]))
        h, s = hist.numpy(), stats.numpy()
        np.testing.assert_array_equal(h, h_k)
        np.testing.assert_array_equal(s[COUNTS], s_k[COUNTS])
        np.testing.assert_allclose(s[2:4], s_k[2:4], rtol=1e-4)


def test_structured_cases_are_what_they_say():
    """The cases reach the shapes they are named for."""
    _, stats = lifetime_scan_plain(*_torch_case("one_long_segment"))
    assert stats[:2].tolist() == [1, 0]          # one live segment
    _, _, w, _ = _torch_case("reads_only")
    assert not w.any()
    _, _, w, _ = _torch_case("writes_only")
    assert w.all()
    for name, shift in (("boundary_at_range_start", 0),
                        ("boundary_after_range_start", 1)):
        _, _, w, _ = _torch_case(name)
        assert torch.nonzero(w).flatten().tolist() == \
            list(range(shift, w.shape[0], 256))
