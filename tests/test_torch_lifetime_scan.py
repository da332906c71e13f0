"""The lifetime_scan port against the Pallas kernel and two oracles (CPU).

On a CPU tensor ``repro_torch.kernels.lifetime_scan.ops.lifetime_histogram``
runs the plain PyTorch version of the CUDA kernel.  It is held against

  (a) the Pallas kernel in interpret mode, through the reference's public
      ``lifetime_histogram``, on that kernel's own test parameter sets:
      ``hist`` and the four counts exactly; ``sum_lt``/``max_lt`` within
      rtol 1e-4 of the Pallas values, which are f32 aggregates and round
      past 2**24 cycles;
  (b) the int64 oracle ``lifetime_hist_reference`` built on the port's
      ``extract_lifetimes``: everything exactly.
"""

import numpy as np
import pytest
import torch

from repro.kernels.lifetime_scan import ops as ref_ops
from repro_torch.core.lifetime import extract_lifetimes
from repro_torch.kernels.lifetime_scan import kernel as port_kernel
from repro_torch.kernels.lifetime_scan import ops as port_ops
from repro_torch.kernels.lifetime_scan.ref import lifetime_hist_reference

COUNTS = [0, 1, 4, 5]        # live, orphans, reads, writes


def _port(t, a, w, edges):
    hist, stats = port_ops.lifetime_histogram(t, a, w, edges, device="cpu")
    assert hist.dtype == torch.int64 and stats.dtype == torch.int64
    return hist.numpy(), stats.numpy()


def _check_against_pallas_and_oracle(t, a, w, edges):
    h_p, s_p = _port(t, a, w, edges)
    h_k, s_k = ref_ops.lifetime_histogram(t, a, w, edges)
    h_k, s_k = np.asarray(h_k), np.asarray(s_k)
    np.testing.assert_array_equal(h_p, h_k)
    np.testing.assert_array_equal(s_p[COUNTS], s_k[COUNTS])
    np.testing.assert_allclose(s_p[2:4], s_k[2:4], rtol=1e-4)
    h_o, s_o = lifetime_hist_reference(t, a, w, edges, device="cpu")
    np.testing.assert_array_equal(h_p, h_o)
    np.testing.assert_array_equal(s_p, s_o)
    assert h_p.sum() == s_p[0]          # top bin is open: all live binned


@pytest.mark.parametrize("n,n_addr,seed", [(50, 5, 0), (1000, 37, 1),
                                           (3000, 211, 2), (257, 3, 3)])
def test_plain_matches_pallas_kernel_and_oracle(n, n_addr, seed):
    rng = np.random.RandomState(seed)
    edges = ref_ops.default_edges(16, 1, 1e6)
    t = np.sort(rng.randint(0, 10 * n, n)).astype(np.int32)
    a = rng.randint(0, n_addr, n).astype(np.int32)
    w = (rng.rand(n) < 0.35).astype(np.int32)
    _check_against_pallas_and_oracle(t, a, w, edges)


def test_plain_matches_pallas_block_size_case():
    rng = np.random.RandomState(7)
    n = 777
    edges = ref_ops.default_edges(8, 1, 1e5)
    t = np.sort(rng.randint(0, 5000, n)).astype(np.int32)
    a = rng.randint(0, 31, n).astype(np.int32)
    w = (rng.rand(n) < 0.4).astype(np.int32)
    _check_against_pallas_and_oracle(t, a, w, edges)


def test_plain_matches_pallas_int64_times():
    rng = np.random.RandomState(11)
    n = 2000
    t = np.sort(rng.randint(0, 2 ** 41, n).astype(np.int64)) + 2 ** 40
    a = rng.randint(0, 97, n).astype(np.int64)
    w = (rng.rand(n) < 0.35).astype(np.int64)
    _check_against_pallas_and_oracle(
        t, a, w, ref_ops.default_edges(24, 1, 1e13))


def test_rebase_invariance_is_exact():
    """Lifetimes are differences: shifting every stamp past 2**40 gives
    the same histogram and the same exact int64 stats, without rebasing."""
    rng = np.random.RandomState(5)
    n = 500
    t = np.sort(rng.randint(0, 100_000, n).astype(np.int64))
    a = rng.randint(0, 16, n).astype(np.int64)
    w = (rng.rand(n) < 0.4).astype(np.int64)
    edges = port_ops.default_edges(16, 1, 1e6)
    hb, sb = _port(t, a, w, edges)
    hs, ss = _port(t + 2 ** 40 + 12345, a, w, edges)
    np.testing.assert_array_equal(hb, hs)
    np.testing.assert_array_equal(sb, ss)


def test_edges_exact_past_2pow24():
    """A bin edge at 2**24 + 1 separates lifetimes of 2**24 and 2**24 + 1
    cycles (f32 edges cannot), in the port as in the Pallas kernel."""
    assert port_ops.default_edges().dtype == np.float64
    np.testing.assert_array_equal(port_ops.default_edges(),
                                  ref_ops.default_edges())
    boundary = 2 ** 24 + 1
    edges = np.array([0.0, boundary, np.inf], np.float64)
    t = np.array([0, 2 ** 24, 10, 10 + boundary], np.int64)
    a = np.array([1, 1, 2, 2], np.int64)
    w = np.array([1, 0, 1, 0], np.int64)
    hist, stats = _port(t, a, w, edges)
    np.testing.assert_array_equal(hist, [1, 1])
    np.testing.assert_array_equal(
        hist, np.asarray(ref_ops.lifetime_histogram(t, a, w, edges)[0]))
    assert stats[2] == 2 ** 25 + 1 and stats[3] == boundary   # exact int64


def test_integer_edges_are_exact_ceils():
    e = np.array([-np.inf, -2.5, 0.0, 0.5, 3.0, 2.0 ** 53 + 2, 1e30,
                  np.inf])
    ie = port_ops.integer_edges(e)
    assert ie.dtype == np.int64
    assert ie.tolist() == [-2 ** 63, -2, 0, 1, 3, 2 ** 53 + 2, 2 ** 63 - 1,
                           2 ** 63 - 1]
    with pytest.raises(ValueError, match="ascending"):
        port_ops.integer_edges([0.0, 5.0, 2.0])


def test_addresses_past_2pow31_are_taken():
    """The reference kernel refuses addresses outside its int32 window;
    the port takes any int64 address.  Held against the port's own
    ``extract_lifetimes``."""
    rng = np.random.RandomState(13)
    n = 1200
    t = np.sort(rng.randint(0, 50_000, n)).astype(np.int64) + 2 ** 33
    a = rng.randint(0, 40, n).astype(np.int64) * 3 + 2 ** 31 + 7
    a[::5] += 2 ** 45
    w = rng.rand(n) < 0.3
    with pytest.raises(OverflowError, match="lifetime_scan"):
        ref_ops.lifetime_histogram(t, a, w)
    hist, stats = _port(t, a, w, None)
    host = extract_lifetimes(t, a, w, np.ones(n, bool),
                             device="cpu").numpy()
    live = ~host.orphan
    lt = host.lifetime_cycles[live]
    assert stats[0] == live.sum() and stats[1] == host.orphan.sum()
    assert stats[2] == lt.sum() and stats[3] == lt.max()
    assert stats[4] == (~w).sum() and stats[5] == w.sum()
    ie = port_ops.integer_edges(port_ops.default_edges())
    want = np.histogram(lt, bins=ie.astype(np.float64))[0]
    np.testing.assert_array_equal(hist, want)
    # and against the small-address twin: addresses only need to differ
    h0, s0 = _port(t, np.unique(a, return_inverse=True)[1], w, None)
    np.testing.assert_array_equal(hist, h0)
    np.testing.assert_array_equal(stats, s0)


@pytest.mark.parametrize("p_write", [0.0, 0.05, 0.95, 1.0])
def test_segment_shapes(p_write):
    """Very long read runs, single-event segments, all reads, all writes."""
    rng = np.random.RandomState(17)
    n = 900
    t = np.sort(rng.randint(0, 3000, n)).astype(np.int64)
    a = rng.randint(0, 3, n).astype(np.int64)
    w = rng.rand(n) < p_write
    edges = port_ops.default_edges(12, 1, 1e4)
    h_p, s_p = _port(t, a, w, edges)
    h_o, s_o = lifetime_hist_reference(t, a, w, edges, device="cpu")
    np.testing.assert_array_equal(h_p, h_o)
    np.testing.assert_array_equal(s_p, s_o)


def test_empty_and_single_event():
    hist, stats = _port(np.zeros(0, np.int64), np.zeros(0, np.int64),
                        np.zeros(0, bool), None)
    assert hist.shape == (64,) and not hist.any() and not stats.any()
    _, s_w = _port([5], [9], [True], None)
    assert s_w.tolist() == [0, 1, 0, 0, 0, 1, 0, 0]     # one orphan write
    h_r, s_r = _port([5], [9], [False], None)
    assert s_r.tolist() == [1, 0, 0, 0, 1, 0, 0, 0]     # a 0-cycle lifetime
    assert h_r[0] == 1


def test_wrapper_rejects_what_the_kernel_does_not_take():
    t = torch.arange(4)
    a = torch.zeros(4, dtype=torch.int64)
    w = torch.zeros(4, dtype=torch.bool)
    e = torch.tensor([0, 10])
    with pytest.raises(TypeError, match="dtype"):
        port_kernel.lifetime_scan_sorted(t, a, w.to(torch.uint8), e)
    with pytest.raises(ValueError, match="elements"):
        port_kernel.lifetime_scan_sorted(t, a[:3], w, e)
    with pytest.raises(ValueError, match="contiguous"):
        port_kernel.lifetime_scan_sorted(torch.arange(8)[::2], a, w, e)
    with pytest.raises(ValueError, match="bins"):
        port_kernel.lifetime_scan_sorted(t, a, w, e[:1])


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_on_the_card():
    """Needs the card: run with ``pytest -m gpu`` on a CUDA machine (the
    full on-card check is ``python3 chip_smoke.py``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(3)
    n = 100_000
    t = np.sort(rng.randint(0, 10 * n, n)).astype(np.int64)
    a = rng.randint(0, 997, n).astype(np.int64)
    w = rng.rand(n) < 0.35
    before = port_kernel.lifetime_scan_sorted.launches
    hist, stats = port_ops.lifetime_histogram(t, a, w, device="cuda")
    assert port_kernel.lifetime_scan_sorted.launches == before + 1
    h_p, s_p = _port(t, a, w, None)
    np.testing.assert_array_equal(hist.cpu().numpy(), h_p)
    np.testing.assert_array_equal(stats.cpu().numpy(), s_p)
