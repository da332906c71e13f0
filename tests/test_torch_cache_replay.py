"""The cache-replay kernel's plain version and the port's per-level replay
against the JAX reference (CPU).

``cache_replay`` replays each set of one cache level through an LRU
write-back state (``kernels/cache_replay``); on the CPU its wrapper runs the
plain PyTorch version.  Here the port's ``_simulate_level`` under both
simulators is held bit for bit against the reference's ``set_parallel`` and
``scalar`` replays on randomized streams (the geometries of
``tests/test_cachesim_parallel.py`` and more), a stream skewed onto one
set, an empty stream and line addresses near 2^59; ``emulate_kernel``
repeats the CUDA kernel's per-thread loop (int32 stamps, a one-hot way, a
32-wide state for ways other than 8 and 16) on the compact set-sorted layout
and is held exactly against the reference's padded scan.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import enable_x64

from repro.backends import cachesim as ref
from repro_torch.backends import cachesim as port
from repro_torch.kernels.cache_replay import (cache_replay,
                                              cache_replay_plain,
                                              cache_replay_sorted, decode,
                                              partition_by_set)

N = 257
GEOMETRIES = [  # (n_sets, ways)
    (1, 2),      # fully-associative corner: every access in one set
    (2, 1),      # direct-mapped corner
    (8, 4),
    (128, 8),    # the paper's 128 KB / 8-way L1 geometry
    (64, 16),    # the default L2's ways
    (16, 3),     # ways the kernel has no template for
    (4, 32),     # the widest the kernel takes
]
FIELDS = ("hit", "fill", "evict_addr", "evict_dirty")
INT_MAX = 2 ** 31 - 1


class _Level:
    def __init__(self, n_sets, ways):
        self.n_sets, self.ways = n_sets, ways


def random_stream(n_sets, ways, trial, n=N):
    rng = np.random.RandomState(n_sets * 31 + ways + 1000 * trial)
    addrs = rng.randint(0, 8 + n_sets * ways * 2, n).astype(np.int64)
    if trial % 2:                     # int64 tags past 2**31
        addrs += 2 ** 31 + 7
    return addrs, rng.rand(n) < 0.4


def assert_same(got, want, what):
    for name, g, e in zip(FIELDS, got, want):
        g, e = np.asarray(g), np.asarray(e)
        assert g.dtype == e.dtype, (name, what)
        np.testing.assert_array_equal(g, e, err_msg=f"{name} {what}")


def ref_level(lines, w, n_sets, ways, wa, simulator):
    return tuple(np.asarray(x) for x in ref._simulate_level(
        lines, w, _Level(n_sets, ways), wa, simulator))


def port_level(lines, w, n_sets, ways, wa, simulator):
    return port._simulate_level(lines, w, _Level(n_sets, ways), wa,
                                simulator, device="cpu")


@pytest.mark.parametrize("n_sets,ways", GEOMETRIES)
@pytest.mark.parametrize("write_allocate", [True, False])
def test_port_level_matches_reference(n_sets, ways, write_allocate):
    """Both of the port's simulators against both of the reference's."""
    for trial in range(4):
        lines, w = random_stream(n_sets, ways, trial)
        what = f"sets={n_sets} ways={ways} wa={write_allocate} {trial}"
        want = ref_level(lines, w, n_sets, ways, write_allocate, "scalar")
        assert_same(ref_level(lines, w, n_sets, ways, write_allocate,
                              "set_parallel"), want, "reference " + what)
        for sim in ("set_parallel", "scalar"):
            assert_same(port_level(lines, w, n_sets, ways, write_allocate,
                                   sim), want, f"port {sim} {what}")


def emulate_kernel(packed, offsets, counts, ways, write_allocate):
    """``csrc/cache_replay.cu``'s thread loop, one set after another, on the
    compact layout: tags with -1 for an invalid way, int32 stamps (the step
    index; initial stamps k - ways, INT_MAX for the unused ways of the
    32-wide instance), dirty bits in one word, the least stamp's way as
    the victim."""
    packed, offsets, counts = (np.asarray(x).tolist()
                               for x in (packed, offsets, counts))
    width = ways if ways in (8, 16) else 32
    out = [0] * len(packed)
    for s, (base, n) in enumerate(zip(offsets, counts)):
        tag = [-1] * width
        stamp = [k - ways if k < ways else INT_MAX for k in range(width)]
        dirty = 0
        for j in range(n):
            v = packed[base + j]
            a, w = v >> 1, v & 1
            least = min(stamp)
            match = lru = 0
            victim = -1
            for k in range(width):
                match |= (tag[k] == a) << k
                if stamp[k] == least:
                    lru |= 1 << k
                    victim = tag[k]
            hit = match != 0
            fill = not hit and (write_allocate or not w)
            way = match if hit else lru
            way_dirty = (dirty & way) != 0
            evict = victim if fill else -1
            evict_dirty = fill and way_dirty and victim >= 0
            if hit or fill:
                for k in range(width):
                    if way >> k & 1:
                        tag[k], stamp[k] = a, j
                dirty = dirty | way if (w or (way_dirty and hit)) \
                    else dirty & ~way
            out[base + j] = ((evict + 1) << 3) | (evict_dirty << 2) \
                | (fill << 1) | hit
    return np.asarray(out, np.int64)


def reference_padded(lines, w, n_sets, ways, wa):
    """The reference's own (L, n_sets) padded scan (pow2 L), read back at
    (slot, set) for every access of the compact layout."""
    set_idx = lines % n_sets
    counts = np.bincount(set_idx, minlength=n_sets)
    L = 1 << (int(counts.max()) - 1).bit_length()
    order = np.argsort(set_idx, kind="stable")
    starts = np.cumsum(counts) - counts
    rows = set_idx[order]
    slots = np.arange(len(lines)) - starts[rows]
    packed = np.zeros((n_sets, L), np.int64)
    packed[rows, slots] = lines[order] * 2 + w[order]
    with enable_x64():
        out_p = np.asarray(ref._simulate_cache_sets(
            jnp.asarray(packed), jnp.asarray(counts.astype(np.int32)),
            ways, wa))
    return out_p[slots, rows]          # in the compact (set-sorted) order


@pytest.mark.parametrize("n_sets,ways", GEOMETRIES)
@pytest.mark.parametrize("write_allocate", [True, False])
def test_kernel_emulation_on_compact_layout_matches_padded_reference(
        n_sets, ways, write_allocate):
    for trial in range(2):
        lines, w = random_stream(n_sets, ways, trial)
        order, offsets, counts = partition_by_set(torch.from_numpy(lines),
                                                  n_sets)
        packed = (lines * 2 + w)[order.numpy()]
        np.testing.assert_array_equal(
            counts.numpy(), np.bincount(lines % n_sets, minlength=n_sets))
        want = reference_padded(lines, w, n_sets, ways, write_allocate)
        got = emulate_kernel(packed, offsets, counts, ways, write_allocate)
        np.testing.assert_array_equal(got, want)
        plain = cache_replay_sorted(torch.from_numpy(packed), offsets,
                                    counts, ways, write_allocate)
        np.testing.assert_array_equal(plain.numpy(), want)


@pytest.mark.parametrize("write_allocate", [True, False])
def test_skewed_stream_is_one_chain_not_a_fallback(write_allocate):
    """Every access in one set: the reference falls back to its scalar scan
    (its padded layout would be mostly padding); the port replays the one
    long chain with the set-parallel path and never calls the scalar
    oracle (ROADMAP D20)."""
    n_sets, ways, n = 128, 8, 4096
    rng = np.random.RandomState(5)
    lines = rng.randint(0, 64, n).astype(np.int64) * n_sets   # all set 0
    w = rng.rand(n) < 0.4
    want = ref_level(lines, w, n_sets, ways, write_allocate, "set_parallel")
    scalar_calls = port._simulate_cache.calls
    plain_calls = cache_replay_plain.calls
    got = port_level(lines, w, n_sets, ways, write_allocate, "set_parallel")
    assert port._simulate_cache.calls == scalar_calls
    assert cache_replay_plain.calls == plain_calls + 1
    assert_same(got, want, "skewed")
    assert_same(port_level(lines, w, n_sets, ways, write_allocate,
                           "scalar"), want, "skewed scalar")


def test_empty_stream():
    for sim in ("set_parallel", "scalar"):
        got = port_level(np.zeros(0, np.int64), np.zeros(0, bool), 8, 4,
                         True, sim)
        want = ref_level(np.zeros(0, np.int64), np.zeros(0, bool), 8, 4,
                         True, sim)
        assert_same(got, want, f"empty {sim}")
    e = torch.zeros(0, dtype=torch.int64)
    assert cache_replay(e, e.bool(), 8, 4, True).shape == (0,)


@pytest.mark.parametrize("write_allocate", [True, False])
def test_line_addresses_near_2_pow_59(write_allocate):
    n_sets, ways = 64, 4
    rng = np.random.RandomState(59)
    lines = (2 ** 59 - 1 - rng.randint(0, 3 * n_sets * ways, N)).astype(
        np.int64)
    w = rng.rand(N) < 0.5
    want = ref_level(lines, w, n_sets, ways, write_allocate, "scalar")
    assert_same(ref_level(lines, w, n_sets, ways, write_allocate,
                          "set_parallel"), want, "reference")
    for sim in ("set_parallel", "scalar"):
        got = port_level(lines, w, n_sets, ways, write_allocate, sim)
        assert_same(got, want, sim)
    assert int(np.asarray(want[2]).max()) > 2 ** 58     # evictions seen


@pytest.mark.parametrize("bad", [-1, 2 ** 59, 2 ** 62])
def test_out_of_range_addresses_raise(bad):
    lines = np.array([0, 5, bad, 3], np.int64)
    w = np.zeros(4, bool)
    for mod in (ref, port):
        kw = {"device": "cpu"} if mod is port else {}
        with pytest.raises(OverflowError, match=r"\[0, 2\^59\)"):
            mod._simulate_cache_set_parallel(lines, w, 8, 4, True, **kw)


def test_decode_and_wrapper_contract():
    words = np.array([0, 1, 2 | (1 << 3), 2 | 4 | (8 << 3)], np.int64)
    hit, fill, ev, ed = decode(words)
    assert hit.tolist() == [False, True, False, False]
    assert fill.tolist() == [False, False, True, True]
    assert ev.tolist() == [-1, -1, 0, 7]
    assert ed.tolist() == [False, False, False, True]
    p = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(TypeError, match="int64"):
        cache_replay_sorted(p.int(), p[:1], p[:1], 4, True)
    with pytest.raises(ValueError, match="elements"):
        cache_replay_sorted(p, p[:1], p[:2], 4, True)
    with pytest.raises(ValueError, match="ways"):
        cache_replay_sorted(p, p[:1], p[:1], 0, True)
    # the plain version takes any ways; the CUDA kernel up to MAX_WAYS
    # (ROADMAP D19), checked in tests/test_torch_gpu.py
    lines = torch.arange(40, dtype=torch.int64) % 37
    got = cache_replay(lines, lines % 3 == 0, 1, 40, True)
    assert (got[:37] & 1).sum() == 0 and (got[37:] & 1).all()
