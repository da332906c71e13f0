"""repro_torch.core.lifetime against the JAX reference, on the CPU.

The same numpy arrays (seeded) go through ``repro.core.lifetime`` and its
port; every ``LifetimeStats`` field must be bit-identical, index by index
(both pad their outputs to ``n_events``).
"""

import numpy as np
import pytest

from repro.core import lifetime as ref
from repro_torch.convert import lifetime_stats_to_numpy, trace_from_arrays
from repro_torch.core import lifetime as port

FIELDS = ("lifetime_cycles", "n_reads", "start_cycles", "addr", "valid",
          "orphan", "seg_id_per_event")
OFFSET = 2 ** 31 + 12345


def _stream(n, n_addrs, seed, p_write=0.4, p_hit=0.7, t_hi=None):
    rng = np.random.RandomState(seed)
    t = np.sort(rng.randint(0, t_hi or 10 * max(n, 1), n)).astype(np.int64)
    a = rng.randint(0, n_addrs, n).astype(np.int64)
    w = rng.rand(n) < p_write
    h = rng.rand(n) < p_hit
    return t, a, w, h


def _assert_identical(t, a, w, h, mode, write_allocate):
    want = ref.extract_lifetimes(t, a, w, h, mode=mode,
                                 write_allocate=write_allocate)
    got = lifetime_stats_to_numpy(port.extract_lifetimes(
        t, a, w, h, mode=mode, write_allocate=write_allocate,
        device="cpu"))
    for f in FIELDS:
        np.testing.assert_array_equal(
            got[f], np.asarray(getattr(want, f)), err_msg=f)
    return want, got


@pytest.mark.parametrize("mode,write_allocate", [
    ("scratchpad", True), ("scratchpad", False),
    ("cache", True), ("cache", False)])
@pytest.mark.parametrize("n,n_addrs,seed", [
    (50, 5, 0), (400, 16, 1), (1500, 97, 2), (257, 3, 3)])
def test_fields_bit_identical(n, n_addrs, seed, mode, write_allocate):
    _assert_identical(*_stream(n, n_addrs, seed), mode, write_allocate)


@pytest.mark.parametrize("mode", ["scratchpad", "cache"])
@pytest.mark.parametrize("n", [0, 1])
def test_empty_and_single_event(n, mode):
    t, a, w, h = _stream(n, 4, 5)
    for wa in (True, False):
        _assert_identical(t, a, w, h, mode, wa)
    # a single write and a single read are distinct cases
    one = np.array([7], np.int64)
    for w1 in (True, False):
        _assert_identical(one, one, np.array([w1]), np.array([True]),
                          mode, True)


@pytest.mark.parametrize("mode", ["scratchpad", "cache"])
def test_same_cycle_ties_keep_input_order(mode):
    """Events sharing (addr, cycle) must stay in input order: both sorts
    are stable, so write-then-read and read-then-write differ."""
    rng = np.random.RandomState(9)
    n = 600
    t = np.sort(rng.randint(0, 40, n)).astype(np.int64)   # heavy ties
    a = rng.randint(0, 6, n).astype(np.int64)
    w = rng.rand(n) < 0.5
    h = rng.rand(n) < 0.6
    _assert_identical(t, a, w, h, mode, True)
    _assert_identical(t, a, w, h, mode, False)


def test_unsorted_input_is_sorted_like_lexsort():
    t, a, w, h = _stream(500, 11, 4)
    perm = np.random.RandomState(4).permutation(len(t))
    _assert_identical(t[perm], a[perm], w[perm], h[perm], "cache", False)


@pytest.mark.parametrize("t_off,a_off", [
    (2 ** 40 + 12345, 0), (0, OFFSET), (OFFSET, OFFSET),
    (2 ** 40, 2 ** 40)])
def test_int64_times_and_addresses(t_off, a_off):
    """Times offset past 2**40 and addresses >= 2**31 stay exact."""
    t, a, w, h = _stream(400, 16, 0)
    want, got = _assert_identical(t + t_off, a + a_off, w, h,
                                  "scratchpad", True)
    v = got["valid"]
    assert got["start_cycles"].dtype == np.int64
    assert got["start_cycles"][v].min() >= t_off
    assert got["addr"][v].min() >= a_off
    # lifetimes are differences: the offsets leave them unchanged
    base = lifetime_stats_to_numpy(port.extract_lifetimes(
        t, a, w, h, device="cpu"))
    np.testing.assert_array_equal(got["lifetime_cycles"],
                                  base["lifetime_cycles"])


@pytest.mark.parametrize("weight_by_accesses", [True, False])
@pytest.mark.parametrize("mode,write_allocate", [
    ("scratchpad", True), ("cache", False)])
def test_short_lived_fraction_equal(mode, write_allocate,
                                    weight_by_accesses):
    t, a, w, h = _stream(800, 23, 6)
    want = ref.extract_lifetimes(t, a, w, h, mode=mode,
                                 write_allocate=write_allocate)
    got = port.extract_lifetimes(t, a, w, h, mode=mode,
                                 write_allocate=write_allocate,
                                 device="cpu")
    for ret in (1e-7, 1e-6, 1e-5, 1.0):
        assert port.short_lived_fraction(
            got, 1e9, ret, weight_by_accesses=weight_by_accesses) == \
            ref.short_lived_fraction(
                want, 1e9, ret, weight_by_accesses=weight_by_accesses)


def test_host_rows_and_histogram_match_reference():
    """``numpy()`` hands over exactly the valid rows, in segment order,
    and the seconds histogram built from them equals the reference's."""
    t, a, w, h = _stream(700, 19, 8)
    want = ref.extract_lifetimes(t, a, w, h, mode="cache",
                                 write_allocate=False)
    got = port.extract_lifetimes(t, a, w, h, mode="cache",
                                 write_allocate=False, device="cpu")
    host = got.numpy()
    v = np.asarray(want.valid)
    for f in ("lifetime_cycles", "n_reads", "start_cycles", "addr",
              "orphan"):
        np.testing.assert_array_equal(getattr(host, f),
                                      np.asarray(getattr(want, f))[v])
    assert host.valid.all() and len(host.valid) == v.sum()
    bins = np.array([0, 1e-7, 1e-6, 1e-5, 1.0])
    np.testing.assert_array_equal(
        port.lifetime_histogram(got, 1e9, bins),
        ref.lifetime_histogram(want, 1e9, bins))


def test_lifetimes_of_trace_and_unknown_mode():
    t, a, w, h = _stream(300, 7, 2)
    tr = trace_from_arrays(t, a, w, h)
    got = lifetime_stats_to_numpy(
        port.lifetimes_of_trace(tr, mode="cache", device="cpu"))
    want = ref.extract_lifetimes(t, a, w, h, mode="cache")
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)))
    with pytest.raises(ValueError, match="unknown mode"):
        port.extract_lifetimes(t, a, w, h, mode="dram", device="cpu")
