"""Public entry point of the cache-replay kernel: partition, replay, unsort.

A level's stream (line addresses and write flags, tensors on one device)
is stably sorted by set on that device, replayed by
``kernel.cache_replay_sorted`` and its result words put back into stream
order.  :func:`decode` splits the words into the four per-access arrays.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.cache_replay.kernel import cache_replay_sorted


def partition_by_set(lines: torch.Tensor, n_sets: int):
    """``(order, offsets, counts)``: the stable permutation that sorts the
    accesses by set (``lines % n_sets``), each set's start in the sorted
    stream and its access count (all int64, on ``lines``' device)."""
    set_idx = lines % n_sets
    order = torch.sort(set_idx, stable=True).indices
    counts = torch.bincount(set_idx, minlength=n_sets)
    offsets = torch.cumsum(counts, 0) - counts
    return order, offsets, counts


def cache_replay(lines: torch.Tensor, is_write: torch.Tensor, n_sets: int,
                 ways: int, write_allocate: bool) -> torch.Tensor:
    """Result words of one level in stream order (see ``kernel.py``).

    ``lines`` int64 line addresses in ``[0, 2^59)`` and ``is_write`` bool,
    1-D, on one device; the work runs there.
    """
    order, offsets, counts = partition_by_set(lines, n_sets)
    packed = (lines * 2 + is_write.to(torch.int64))[order]
    words = cache_replay_sorted(packed, offsets, counts, ways,
                                write_allocate)
    out = torch.empty_like(words)
    out[order] = words
    return out


def decode(words):
    """``(hit, fill, evict_addr, evict_dirty)`` of result words (numpy
    arrays or tensors)."""
    return ((words & 1) != 0, ((words >> 1) & 1) != 0, (words >> 3) - 1,
            ((words >> 2) & 1) != 0)
