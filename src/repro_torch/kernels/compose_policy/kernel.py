"""The ``compose_policy`` kernels (B7): wrappers, plain PyTorch versions,
launch counts.

Contract (float64 throughout; C candidates, D device slots, cheapest device
first, the first ``n_dev[c]`` slots of row ``c`` real, the rest padding that
is never read):

  ret, read_fj, write_fj   float64 [C, D]  retention (s) at the observed
                                           write frequency, per-bit read and
                                           write energy (fJ)
  n_dev                    int32 [C]       real devices per candidate, 1..D

:func:`policy_rf` (refresh-free, the reference's ``_rf_fused``): first-fit
device of lifetime ``t`` is the first ``d`` with ``t <= cummax(ret)[d]``, so
per-device totals are differences of prefix sums at ``searchsorted`` positions
into the value-sorted lifetimes, and per-device address counts are position
differences into the sorted per-address max-lifetimes; lifetimes past every
retention bill the last device.  Returns ``energy`` [C] in J and ``counts``
[C, D] int64.

:func:`policy_ra_grouped` (refresh-aware, the reference's ``_ra_grouped``):
with ``refresh = max(ceil(lt / ret) - 1, 0)``, the energy of a lifetime on a
device is :func:`energy_plain` ``(bits, read_bits, refresh * bits)``; the
candidate's energy is the sum over lifetimes of the device minimum, and each
address (a run of equal ``seg`` ids in the address-sorted arrays) picks the
device of least :func:`energy_plain` ``(addr_bits, addr_read_bits, sum of
refresh * bits)``, ties to the lowest index.  Returns per-block energy
partials [C, P] in fJ (the caller sums each row in a fixed order) and the pick
``counts`` [C, D] int64.

:func:`policy_ra_ungrouped` (``_ra_ungrouped``): every lifetime picks its
least-energy device; returns energy partials [C, P] in fJ and ``picks`` [C,
L] int8.

On CUDA tensors each wrapper launches its hand-written kernel
(``csrc/compose_policy.cu``, built at first use; ``D`` up to
:data:`MAX_DEVICES`) and counts the call in ``.launches``; on CPU tensors it
runs the plain version (``.calls``), which is also what the tests and the
on-card comparison hold the kernel against.  There is no fallback from one to
the other.  The plain versions compute the same expressions op by op in the
same order as the kernels (which round every product and sum on its own), so
per-lifetime and per-address energies are bit-equal; only the order of the
energy sums differs.  They work on slices of candidates so that no
``[C, D, L]`` tensor larger than :data:`SLICE_BYTES` is built.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from repro_torch.kernels import _build

MAX_DEVICES = 16                 # csrc: device slots of the widest instance
SLICE_BYTES = 256 * 1024 * 1024  # plain versions: [c, D, L] float64 budget
_TEMPS = 6                       # live [c, D, L] float64 temporaries


def energy_plain(bits, read_bits, refresh_bits, rf, wf):
    """The Algorithm-1 energy (fJ) in the kernels' order of operations:
    ``(E_w*bits + E_r*read_bits) + (E_r + E_w)*refresh_bits``."""
    return wf * bits + rf * read_bits + (rf + wf) * refresh_bits


def refresh_plain(lt, ret):
    """Refresh count ``max(ceil(lt / ret) - 1, 0)`` (IEEE division)."""
    return torch.clamp(torch.ceil(lt / ret) - 1.0, min=0.0)


def _pad_mask(n_dev: torch.Tensor, D: int) -> torch.Tensor:
    return (torch.arange(D, device=n_dev.device)[None, :]
            >= n_dev.to(torch.int64)[:, None])


def _slice_len(D: int, L: int) -> int:
    return max(1, SLICE_BYTES // max(1, D * L * 8 * _TEMPS))


def policy_rf_plain(ret, read_fj, write_fj, n_dev, lt_sorted, prefix_bits,
                    prefix_read_bits, maxlt_sorted):
    """Plain PyTorch version of the refresh-free kernel (any device)."""
    policy_rf_plain.calls += 1
    C, D = ret.shape
    n_lt, n_addr = lt_sorted.shape[0], maxlt_sorted.shape[0]
    pad = _pad_mask(n_dev, D)
    chi = torch.cummax(torch.where(pad, -torch.inf, ret), dim=1).values
    pos = torch.searchsorted(lt_sorted, chi, right=True).clamp(max=n_lt)
    zero = torch.zeros(C, 1, dtype=torch.int64, device=ret.device)
    prev = torch.cat([zero, pos[:, :-1]], dim=1)
    rf0 = torch.where(pad, 0.0, read_fj)
    wf0 = torch.where(pad, 0.0, write_fj)
    pb, prb = prefix_bits, prefix_read_bits
    e = energy_plain(pb[pos] - pb[prev], prb[pos] - prb[prev], 0.0, rf0, wf0)
    fb = (n_dev.to(torch.int64) - 1)[:, None]
    last = pos.gather(1, fb)[:, 0]
    tail = energy_plain(pb[-1] - pb[last], prb[-1] - prb[last], 0.0,
                        rf0.gather(1, fb)[:, 0], wf0.gather(1, fb)[:, 0])
    energy = (e.sum(dim=1) + tail) * 1e-15
    if n_addr:
        apos = torch.searchsorted(maxlt_sorted, chi,
                                  right=True).clamp(max=n_addr)
    else:
        apos = torch.zeros_like(pos)
    counts = apos - torch.cat([zero, apos[:, :-1]], dim=1)
    counts = torch.where(pad, 0, counts)
    counts.scatter_add_(1, fb, n_addr - apos.gather(1, fb))
    return energy, counts


def policy_ra_grouped_plain(ret, read_fj, write_fj, n_dev, lt, read_bits,
                            bits, seg, addr_bits, addr_read_bits):
    """Plain PyTorch version of the grouped refresh-aware kernel (any
    device): broadcasts over candidate slices, ``index_add_`` of the
    refresh terms over the segment ids, ``argmin`` per address."""
    policy_ra_grouped_plain.calls += 1
    C, D = ret.shape
    L, A = lt.shape[0], addr_bits.shape[0]
    dev = ret.device
    pad = _pad_mask(n_dev, D)
    energy_part = torch.empty(C, 1, dtype=torch.float64, device=dev)
    counts = torch.zeros(C, D, dtype=torch.int64, device=dev)
    step = _slice_len(D, L)
    for lo in range(0, C, step):
        hi = min(lo + step, C)
        p = pad[lo:hi, :, None]
        rf = read_fj[lo:hi, :, None]
        wf = write_fj[lo:hi, :, None]
        rbits = refresh_plain(lt, ret[lo:hi, :, None]) * bits
        e = torch.where(p, torch.inf,
                        energy_plain(bits, read_bits, rbits, rf, wf))
        energy_part[lo:hi, 0] = e.min(dim=1).values.sum(dim=1)
        del e
        rsum = torch.zeros(hi - lo, D, A, dtype=torch.float64, device=dev)
        rsum.index_add_(2, seg, torch.where(p, 0.0, rbits))
        per_addr = torch.where(p, torch.inf, energy_plain(
            addr_bits, addr_read_bits, rsum, rf, wf))
        pick = per_addr.argmin(dim=1)
        counts[lo:hi].scatter_add_(1, pick, torch.ones_like(pick))
    return energy_part, counts


def policy_ra_ungrouped_plain(ret, read_fj, write_fj, n_dev, lt, read_bits,
                              bits):
    """Plain PyTorch version of the ungrouped refresh-aware kernel."""
    policy_ra_ungrouped_plain.calls += 1
    C, D = ret.shape
    L = lt.shape[0]
    dev = ret.device
    pad = _pad_mask(n_dev, D)
    energy_part = torch.empty(C, 1, dtype=torch.float64, device=dev)
    picks = torch.empty(C, L, dtype=torch.int8, device=dev)
    step = _slice_len(D, L)
    for lo in range(0, C, step):
        hi = min(lo + step, C)
        rbits = refresh_plain(lt, ret[lo:hi, :, None]) * bits
        e = torch.where(pad[lo:hi, :, None], torch.inf, energy_plain(
            bits, read_bits, rbits, read_fj[lo:hi, :, None],
            write_fj[lo:hi, :, None]))
        best = e.min(dim=1)
        energy_part[lo:hi, 0] = best.values.sum(dim=1)
        picks[lo:hi] = best.indices.to(torch.int8)
    return energy_part, picks


for _fn in (policy_rf_plain, policy_ra_grouped_plain,
            policy_ra_ungrouped_plain):
    _fn.calls = 0


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(name, x, device, dtype, shape):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous with shape "
                         f"{tuple(shape)}, got {tuple(x.shape)}")


def _check_candidates(ret, read_fj, write_fj, n_dev):
    dev = ret.device
    if ret.dim() != 2:
        raise ValueError(f"ret must be [C, D], got {tuple(ret.shape)}")
    C, D = ret.shape
    if C < 1 or D < 1:
        raise ValueError(f"need at least one candidate and one device slot, "
                         f"got [C, D] = [{C}, {D}]")
    for name, x in (("ret", ret), ("read_fj", read_fj),
                    ("write_fj", write_fj)):
        _check(name, x, dev, torch.float64, (C, D))
    _check("n_dev", n_dev, dev, torch.int32, (C,))
    if dev.type == "cpu":
        return dev, C, D
    if dev.type != "cuda":
        raise ValueError(f"compose_policy runs on cuda or cpu, not {dev}")
    if D > MAX_DEVICES:
        raise ValueError(f"the compose_policy kernels take up to "
                         f"{MAX_DEVICES} device slots, got {D}")
    return dev, C, D


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _build.load_library("compose_policy")
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    cand = [P, P, P, P, I, I]
    lib.compose_policy_rf_launch.argtypes = cand + [P, LL, P, P, P, LL, P, P,
                                                    P]
    lib.compose_policy_ra_grouped_launch.argtypes = cand + [
        P, P, P, P, LL, P, P, LL, P, P, P, P, P]
    lib.compose_policy_ra_ungrouped_launch.argtypes = cand + [
        P, P, P, LL, LL, P, P, P]
    for fn in (lib.compose_policy_rf_launch,
               lib.compose_policy_ra_grouped_launch,
               lib.compose_policy_ra_ungrouped_launch,
               lib.compose_policy_range_lifetimes,
               lib.compose_policy_thread_lifetimes,
               lib.compose_policy_ungrouped_block,
               lib.compose_policy_max_devices):
        fn.restype = ctypes.c_int
    if lib.compose_policy_max_devices() != MAX_DEVICES:
        raise RuntimeError("compose_policy library and wrapper disagree on "
                           "the device-slot limit")
    return lib


def _on_device(dev):
    return (torch.cuda.device(dev) if dev.index != torch.cuda.current_device()
            else contextlib.nullcontext())


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"compose_policy {what} launch failed: CUDA "
                           f"error {err}")


def _ptrs(*xs):
    return [x.data_ptr() for x in xs]


def policy_rf(ret, read_fj, write_fj, n_dev, lt_sorted, prefix_bits,
              prefix_read_bits, maxlt_sorted):
    """Refresh-free energy [C] (J) and address counts [C, D] (int64); see
    the module docstring.  ``lt_sorted`` [n_lt] ascending, the prefix sums
    [n_lt + 1], ``maxlt_sorted`` [n_addr] ascending (empty without address
    groups: the counts are then zero), all float64."""
    dev, C, D = _check_candidates(ret, read_fj, write_fj, n_dev)
    n_lt, n_addr = lt_sorted.shape[0], maxlt_sorted.shape[0]
    f64 = torch.float64
    _check("lt_sorted", lt_sorted, dev, f64, (n_lt,))
    _check("prefix_bits", prefix_bits, dev, f64, (n_lt + 1,))
    _check("prefix_read_bits", prefix_read_bits, dev, f64, (n_lt + 1,))
    _check("maxlt_sorted", maxlt_sorted, dev, f64, (n_addr,))
    if dev.type == "cpu":
        return policy_rf_plain(ret, read_fj, write_fj, n_dev, lt_sorted,
                               prefix_bits, prefix_read_bits, maxlt_sorted)
    energy = torch.empty(C, dtype=f64, device=dev)
    counts = torch.empty(C, D, dtype=torch.int64, device=dev)
    with _on_device(dev):
        err = _launcher().compose_policy_rf_launch(
            *_ptrs(ret, read_fj, write_fj, n_dev), C, D,
            lt_sorted.data_ptr(), n_lt,
            *_ptrs(prefix_bits, prefix_read_bits, maxlt_sorted), n_addr,
            *_ptrs(energy, counts),
            torch._C._cuda_getCurrentRawStream(dev.index))
    policy_rf.launches += 1
    _raise_on(err, "refresh-free")
    return energy, counts


def _check_lifetimes(dev, lt, read_bits, bits):
    L = lt.shape[0]
    if L < 1:
        raise ValueError("compose_policy needs at least one lifetime")
    for name, x in (("lt", lt), ("read_bits", read_bits), ("bits", bits)):
        _check(name, x, dev, torch.float64, (L,))
    return L


def policy_ra_grouped(ret, read_fj, write_fj, n_dev, lt, read_bits, bits,
                      seg, addr_bits, addr_read_bits):
    """Refresh-aware energy partials [C, P] (fJ) and address pick counts
    [C, D] (int64).  ``lt``, ``read_bits`` (reads * bits), ``bits`` [L]
    float64 sorted by address; ``seg`` [L] int32 segment ids 0..A-1,
    ascending; ``addr_bits``, ``addr_read_bits`` [A] float64 per-address
    sums.  On CUDA one call is two launches (the grouped pass and its
    join)."""
    dev, C, D = _check_candidates(ret, read_fj, write_fj, n_dev)
    L = _check_lifetimes(dev, lt, read_bits, bits)
    A = addr_bits.shape[0]
    _check("seg", seg, dev, torch.int32, (L,))
    _check("addr_bits", addr_bits, dev, torch.float64, (A,))
    _check("addr_read_bits", addr_read_bits, dev, torch.float64, (A,))
    if A < 1:
        raise ValueError("the grouped kernel needs at least one address")
    if dev.type == "cpu":
        return policy_ra_grouped_plain(ret, read_fj, write_fj, n_dev, lt,
                                       read_bits, bits, seg, addr_bits,
                                       addr_read_bits)
    lib = _launcher()
    rng = lib.compose_policy_range_lifetimes()
    n_ranges = -(-L // rng)
    f64 = torch.float64
    energy_part = torch.empty(C, n_ranges, dtype=f64, device=dev)
    pieces = torch.empty(2, C, n_ranges, D, dtype=f64, device=dev)
    counts = torch.zeros(C, D, dtype=torch.int64, device=dev)
    with _on_device(dev):
        err = lib.compose_policy_ra_grouped_launch(
            *_ptrs(ret, read_fj, write_fj, n_dev), C, D,
            *_ptrs(lt, read_bits, bits, seg), L,
            *_ptrs(addr_bits, addr_read_bits), n_ranges,
            energy_part.data_ptr(), pieces[0].data_ptr(),
            pieces[1].data_ptr(), counts.data_ptr(),
            torch._C._cuda_getCurrentRawStream(dev.index))
    policy_ra_grouped.launches += 1
    _raise_on(err, "refresh-aware grouped")
    return energy_part, counts


def policy_ra_ungrouped(ret, read_fj, write_fj, n_dev, lt, read_bits, bits):
    """Refresh-aware energy partials [C, P] (fJ) and per-lifetime device
    picks [C, L] (int8), lifetimes in the caller's order."""
    dev, C, D = _check_candidates(ret, read_fj, write_fj, n_dev)
    L = _check_lifetimes(dev, lt, read_bits, bits)
    if dev.type == "cpu":
        return policy_ra_ungrouped_plain(ret, read_fj, write_fj, n_dev, lt,
                                         read_bits, bits)
    lib = _launcher()
    n_blocks = -(-L // lib.compose_policy_ungrouped_block())
    energy_part = torch.empty(C, n_blocks, dtype=torch.float64, device=dev)
    picks = torch.empty(C, L, dtype=torch.int8, device=dev)
    with _on_device(dev):
        err = lib.compose_policy_ra_ungrouped_launch(
            *_ptrs(ret, read_fj, write_fj, n_dev), C, D,
            *_ptrs(lt, read_bits, bits), L, n_blocks,
            *_ptrs(energy_part, picks),
            torch._C._cuda_getCurrentRawStream(dev.index))
    policy_ra_ungrouped.launches += 1
    _raise_on(err, "refresh-aware ungrouped")
    return energy_part, picks


for _fn in (policy_rf, policy_ra_grouped, policy_ra_ungrouped):
    _fn.launches = 0
del _fn
