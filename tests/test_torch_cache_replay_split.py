"""The split cache replay (``csrc/cache_replay.cu`` under write-allocate)
emulated on the CPU and held bit for bit against the JAX reference's padded
``_simulate_cache_sets`` and against ``cache_replay_plain``.

``emulate_cache_replay_split.emulate_split`` repeats the three CUDA kernels'
phases (summaries and tile lists, incoming stacks and the replay with
symbolic dirty bits, the resolve of deferred evictions) with the chunk
length ``S`` and the tile width as parameters.  Every geometry of
``tests/test_torch_cache_replay.py`` runs at S = 1, 2, ways - 1, ways,
ways + 1 and 64, with tiles of 32 chunks (the kernels') and of 2 (many
walks back over tiles), on streams with two or three lines a set (the
incoming stacks stay short and the walks run back to the set's start),
reads only, writes only, mixed writes, a line written and evicted dirty
several chunks later, and line addresses near 2^59.
"""

import functools

import numpy as np
import pytest
import torch

from emulate_cache_replay_split import emulate_split
from repro_torch.kernels.cache_replay import (cache_replay_plain,
                                              partition_by_set)
from repro_torch.kernels.cache_replay.kernel import (SPLIT_MIN_PER_WAY,
                                                     split_length)
from test_torch_cache_replay import GEOMETRIES, N, reference_padded

S_CHOICES = ("1", "2", "ways-1", "ways", "ways+1", "64")
STREAMS = ("mixed", "few_lines", "reads_only", "writes_only", "dirty_far",
           "top")


def chunk_length(label, ways):
    return max(1, {"1": 1, "2": 2, "ways-1": ways - 1, "ways": ways,
                   "ways+1": ways + 1, "64": 64}[label])


def make_stream(kind, n_sets, ways):
    """Line addresses and write flags (numpy) of one named stream."""
    rng = np.random.RandomState(n_sets * 131 + ways * 7 + STREAMS.index(kind))
    if kind == "dirty_far":
        # set 0: line X written once, then read hits on X and on ways - 1
        # other lines for 200 accesses (several chunks at every S tried),
        # then `ways` new lines evict X, dirty; other sets random
        x = n_sets * 1000
        others = [n_sets * (1001 + i) for i in range(ways - 1)]
        hot = rng.choice([x] + others, 200)
        fresh = [n_sets * (2000 + i) for i in range(ways)]
        set0 = np.concatenate([[x], hot, fresh]).astype(np.int64)
        w0 = np.zeros(len(set0), bool)
        w0[0] = True
        rest = rng.randint(0, 4 * n_sets * ways, 64).astype(np.int64)
        rest = rest[rest % n_sets != 0]
        lines = np.concatenate([set0, rest])
        w = np.concatenate([w0, rng.rand(len(rest)) < 0.4])
        return lines, w
    if kind == "few_lines":
        # one line a set in the first half of the stream, then 2 or 3
        distinct = 2 + rng.randint(0, 2, n_sets)
        sets = rng.randint(0, n_sets, N)
        tags = rng.randint(0, 3, N) % distinct[sets]
        tags[:N // 2] = 0
        return (sets + n_sets * tags).astype(np.int64), rng.rand(N) < 0.4
    if kind == "top":
        # ways + 2 lines a set, about 4 * ways accesses a set: evictions
        n = max(N, 4 * n_sets * ways)
        lines = 2 ** 59 - 1 - rng.randint(0, n_sets * (ways + 2), n)
        return lines.astype(np.int64), rng.rand(n) < 0.4
    lines = rng.randint(0, 8 + n_sets * ways * 2, N).astype(np.int64)
    share = {"reads_only": 0.0, "writes_only": 1.0}.get(kind, 0.4)
    return lines, rng.rand(N) < share


@functools.lru_cache(maxsize=None)
def case(kind, n_sets, ways):
    """The stream's set-sorted layout and its reference words (the JAX
    padded scan, checked equal to the plain version here)."""
    lines, w = make_stream(kind, n_sets, ways)
    order, offsets, counts = partition_by_set(torch.from_numpy(lines),
                                              n_sets)
    packed = (lines * 2 + w)[order.numpy()]
    want = reference_padded(lines, w, n_sets, ways, True)
    plain = cache_replay_plain(torch.from_numpy(packed), offsets, counts,
                               ways, True).numpy()
    np.testing.assert_array_equal(plain, want)
    return packed, offsets.numpy(), counts.numpy(), want


@pytest.mark.parametrize("s_label", S_CHOICES)
@pytest.mark.parametrize("n_sets,ways", GEOMETRIES)
def test_split_emulation_matches_reference_and_plain(n_sets, ways, s_label):
    S = chunk_length(s_label, ways)
    seen = {"partial_stacks": 0, "deferred_dirty": 0,
            "longest_tile_walk": 0}
    for kind in STREAMS:
        packed, offsets, counts, want = case(kind, n_sets, ways)
        for tile in (32, 2):
            stats = {}
            got = emulate_split(packed, offsets, counts, ways, S, tile,
                                stats)
            np.testing.assert_array_equal(
                np.asarray(got, np.int64), want,
                err_msg=f"{kind} S={S} tile={tile}")
            for key in seen:
                seen[key] = max(seen[key], stats[key])
        if kind == "dirty_far":
            # X's eviction is dirty and comes chunks after its write
            x_line = n_sets * 1000
            evict = (want >> 3) - 1
            at = np.flatnonzero(evict == x_line)
            assert len(at) == 1 and (want[at[0]] >> 2) & 1
            assert at[0] // S >= 2
        if kind == "top":
            assert ((want >> 3) - 1).max() > 2 ** 58     # evictions seen
    # what the streams were built to reach: deferred evictions resolved
    # dirty, incoming stacks that are not full, walks over several tiles
    assert seen["deferred_dirty"] > 0
    if ways >= 2:
        assert seen["partial_stacks"] > 0
        if S <= ways + 1:
            assert seen["longest_tile_walk"] >= 2


def test_split_length():
    """S fills every resident warp of the card once, one chunk a lane, and
    holds at least SPLIT_MIN_PER_WAY accesses per way."""
    # the full-depth TinyLlama L1 and L2 streams on 132 SMs, 16 warps each
    assert split_length(5_883_923, 8, 132, 16) == 88
    assert split_length(4_706_102, 16, 132, 16) == 70
    assert split_length(1 << 20, 8, 132, 16) == SPLIT_MIN_PER_WAY * 8
    assert split_length(3000, 1, 132, 16) == SPLIT_MIN_PER_WAY
    for n in (1, 1000, 67_584, 67_585, 10 ** 7):
        S = split_length(n, 8, 132, 16)
        assert -(-n // S) <= 132 * 16 * 32
        assert S == SPLIT_MIN_PER_WAY * 8 or -(-n // (S - 1)) > 132 * 16 * 32


def test_split_is_not_exact_without_write_allocate():
    """Why no-write-allocate keeps the per-set chain: there a write miss
    leaves its set untouched, so the last `ways` distinct lines are not the
    resident ones (one way: read A, write B, read A hits A)."""
    packed = np.array([0 * 2, 1 * 2 + 1, 0 * 2], np.int64)
    offsets, counts = np.array([0]), np.array([3])
    no_wa = cache_replay_plain(torch.from_numpy(packed),
                               torch.from_numpy(offsets),
                               torch.from_numpy(counts), 1, False).numpy()
    assert no_wa[2] & 1                                # A hits
    split = emulate_split(packed, offsets, counts, 1, 1)
    assert not split[2] & 1                            # the split says miss
    wa = cache_replay_plain(torch.from_numpy(packed),
                            torch.from_numpy(offsets),
                            torch.from_numpy(counts), 1, True).numpy()
    np.testing.assert_array_equal(split, wa)
