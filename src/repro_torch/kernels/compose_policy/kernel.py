"""The ``compose_policy`` kernels (B7): wrappers, plain PyTorch versions,
launch counts.

Contract (float64 throughout; C candidates, D device slots, cheapest device
first, the first ``n_dev[c]`` slots of row ``c`` real, the rest padding that
is never used):

  ret, read_fj, write_fj   float64 [C, D]  retention (s) at the observed
                                           write frequency, per-bit read and
                                           write energy (fJ)
  n_dev                    int32 [C]       real devices per candidate, 1..D
  ret_u                    float64 [R]     the batch's distinct finite
                                           retentions (the retention index)
  ridx                     int32 [C, D]    each slot's row of ``ret_u``; -1
                                           for an infinite retention (and
                                           padding), which refreshes nothing

:func:`policy_rf` (refresh-free, the reference's ``_rf_fused``): first-fit
device of lifetime ``t`` is the first ``d`` with ``t <= cummax(ret)[d]``, so
per-device totals are differences of prefix sums at ``searchsorted`` positions
into the value-sorted lifetimes, and per-device address counts are position
differences into the sorted per-address max-lifetimes; lifetimes past every
retention bill the last device.  Returns ``energy`` [C] in J and ``counts``
[C, D] int64.

Refresh-aware (the reference's ``_ra_grouped`` and ``_ra_ungrouped``), with
``q = lt / ret`` by one IEEE division per (retention, lifetime):

* :func:`policy_retention`, the retention pass: per retention, with address
  groups the policy's refresh bits ``max(ceil(q) - 1, 0) * bits`` summed per
  address (``rs`` [R, A]); without, Algorithm 1's ``floor(q) * bits``
  summed into per-range partials ``[R, P]`` (the monolithic baselines).
* :func:`policy_ra_grouped` and :func:`policy_ra_ungrouped`, the candidate
  pass: the energy of a lifetime on a device is :func:`energy_plain`
  ``(bits, read_bits, refresh bits of its retention)``; a candidate's energy
  is the sum over lifetimes of the device minimum, returned as per-block
  partials [C, P] in fJ (the caller sums each row in a fixed order); the
  ungrouped form also returns the per-lifetime picks [C, L] int8.
* :func:`policy_ra_decide`: each address picks the device of least
  :func:`energy_plain` ``(addr_bits, addr_read_bits, rs[ridx])``, ties to the
  lowest index; pick ``counts`` [C, D] int64.

On CUDA tensors each wrapper launches its hand-written kernel
(``csrc/compose_policy.cu``, built at first use; ``D`` up to
:data:`MAX_DEVICES`, a candidate pass up to :data:`MAX_RETENTIONS` rows) and
counts the call in ``.launches``; on CPU tensors it runs the plain version
(``.calls``), which is also what the tests and the on-card comparison hold
the kernel against.  There is no fallback from one to the other.  The plain
versions compute the same expressions op by op in the same order as the
kernels (which round every product and sum on its own), so per-lifetime and
per-address energies are bit-equal; only the order of the sums differs.
They work on slices of candidates and retentions so that no ``[c, D, L]``
temporary exceeds :data:`SLICE_BYTES`; a candidate pass's plain version
holds the whole ``[R + 1, L]`` refresh table that the kernel's blocks hold
a share of each.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from repro_torch.kernels import _build

MAX_DEVICES = 16                 # csrc: device slots of the widest instance
MAX_RETENTIONS = 96              # csrc: retention rows of a candidate pass
SLICE_BYTES = 256 * 1024 * 1024  # plain versions: float64 budget a step
_TEMPS = 6                       # live [c, D, L] float64 temporaries


def energy_plain(bits, read_bits, refresh_bits, rf, wf):
    """The Algorithm-1 energy (fJ) in the kernels' order of operations:
    ``(E_w*bits + E_r*read_bits) + (E_r + E_w)*refresh_bits``."""
    return wf * bits + rf * read_bits + (rf + wf) * refresh_bits


def refresh_plain(lt, ret):
    """Refresh count ``max(ceil(lt / ret) - 1, 0)`` (IEEE division)."""
    return torch.clamp(torch.ceil(lt / ret) - 1.0, min=0.0)


def floor_plain(lt, ret):
    """Algorithm 1's refresh count ``floor(lt / ret)``, from the same
    division as :func:`refresh_plain`."""
    return torch.floor(lt / ret)


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


def _rows(ridx: torch.Tensor, R: int) -> torch.Tensor:
    """``ridx`` as int64 rows of a table whose row ``R`` is zero (an
    infinite retention, or padding, refreshes nothing)."""
    return torch.where(ridx < 0, R, ridx).to(torch.int64)


def policy_retention_plain(ret_u, lt, bits, seg=None, n_addr=0):
    """Plain PyTorch version of the retention pass (any device): with
    ``seg``, ``(rs [R, A], None)``, ``index_add_`` of the refresh bits over
    the segment ids; without, ``(None, floor_part [R, 1])``."""
    policy_retention_plain.calls += 1
    R, L = ret_u.shape[0], lt.shape[0]
    dev = lt.device
    if seg is not None:
        out = torch.zeros(R, n_addr, dtype=torch.float64, device=dev)
    else:
        out = torch.empty(R, 1, dtype=torch.float64, device=dev)
    step = max(1, SLICE_BYTES // max(1, L * 8 * _TEMPS))
    for lo in range(0, R, step):
        hi = min(lo + step, R)
        ret = ret_u[lo:hi, None]
        if seg is not None:
            out[lo:hi].index_add_(1, seg, refresh_plain(lt, ret) * bits)
        else:
            out[lo:hi, 0] = (floor_plain(lt, ret) * bits).sum(dim=1)
    return (out, None) if seg is not None else (None, out)


def _refresh_table(ret_u, lt, bits):
    """``[R + 1, L]``: every retention's refresh bits per lifetime, the last
    row zero (the candidate pass's shared table, whole)."""
    R, L = ret_u.shape[0], lt.shape[0]
    tab = torch.zeros(R + 1, L, dtype=torch.float64, device=lt.device)
    step = max(1, SLICE_BYTES // max(1, L * 8 * _TEMPS))
    for lo in range(0, R, step):
        hi = min(lo + step, R)
        tab[lo:hi] = refresh_plain(lt, ret_u[lo:hi, None]) * bits
    return tab


def _candidate_pass_plain(ret_u, ridx, read_fj, write_fj, n_dev, lt,
                          read_bits, bits, want_picks):
    C, D = ridx.shape
    L = lt.shape[0]
    dev = lt.device
    tab = _refresh_table(ret_u, lt, bits)
    rows = _rows(ridx, ret_u.shape[0])
    pad = _pad_mask(n_dev, D)
    energy_part = torch.empty(C, 1, dtype=torch.float64, device=dev)
    picks = (torch.empty(C, L, dtype=torch.int8, device=dev) if want_picks
             else None)
    step = _slice_len(D, L)
    for lo in range(0, C, step):
        hi = min(lo + step, C)
        e = torch.where(pad[lo:hi, :, None], torch.inf, energy_plain(
            bits, read_bits, tab[rows[lo:hi]], read_fj[lo:hi, :, None],
            write_fj[lo:hi, :, None]))
        best = e.min(dim=1)
        energy_part[lo:hi, 0] = best.values.sum(dim=1)
        if want_picks:
            picks[lo:hi] = best.indices.to(torch.int8)
    return energy_part, picks


def policy_ra_grouped_plain(ret_u, ridx, read_fj, write_fj, n_dev, lt,
                            read_bits, bits):
    """Plain PyTorch version of the grouped candidate pass (any device):
    the whole ``[R + 1, L]`` refresh table, gathered per candidate slice,
    the device minimum per lifetime; energy partials [C, 1]."""
    policy_ra_grouped_plain.calls += 1
    return _candidate_pass_plain(ret_u, ridx, read_fj, write_fj, n_dev, lt,
                                 read_bits, bits, False)[0]


def policy_ra_ungrouped_plain(ret_u, ridx, read_fj, write_fj, n_dev, lt,
                              read_bits, bits):
    """Plain PyTorch version of the ungrouped candidate pass: energy
    partials [C, 1] and picks [C, L] int8."""
    policy_ra_ungrouped_plain.calls += 1
    return _candidate_pass_plain(ret_u, ridx, read_fj, write_fj, n_dev, lt,
                                 read_bits, bits, True)


def policy_ra_decide_plain(ridx, read_fj, write_fj, n_dev, rs, addr_bits,
                           addr_read_bits):
    """Plain PyTorch version of the decision per address: ``argmin`` over
    the devices of the per-address energies, counted per (c, d)."""
    policy_ra_decide_plain.calls += 1
    C, D = ridx.shape
    R, A = rs.shape
    dev = rs.device
    table = torch.cat([rs, torch.zeros(1, A, dtype=torch.float64,
                                       device=dev)])
    rows = _rows(ridx, R)
    pad = _pad_mask(n_dev, D)
    counts = torch.zeros(C, D, dtype=torch.int64, device=dev)
    step = _slice_len(D, A)
    for lo in range(0, C, step):
        hi = min(lo + step, C)
        per_addr = torch.where(pad[lo:hi, :, None], torch.inf, energy_plain(
            addr_bits, addr_read_bits, table[rows[lo:hi]],
            read_fj[lo:hi, :, None], write_fj[lo:hi, :, None]))
        pick = per_addr.argmin(dim=1)
        counts[lo:hi].scatter_add_(1, pick, torch.ones_like(pick))
    return counts


PLAIN = (policy_rf_plain, policy_retention_plain, policy_ra_grouped_plain,
         policy_ra_ungrouped_plain, policy_ra_decide_plain)
for _fn in PLAIN:
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


def _device_of(x):
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"compose_policy runs on cuda or cpu, not {dev}")
    return dev


def _check_slots(dev, C, D, read_fj, write_fj, n_dev):
    if C < 1 or D < 1:
        raise ValueError(f"need at least one candidate and one device slot, "
                         f"got [C, D] = [{C}, {D}]")
    for name, x in (("read_fj", read_fj), ("write_fj", write_fj)):
        _check(name, x, dev, torch.float64, (C, D))
    _check("n_dev", n_dev, dev, torch.int32, (C,))
    if dev.type == "cuda" and D > MAX_DEVICES:
        raise ValueError(f"the compose_policy kernels take up to "
                         f"{MAX_DEVICES} device slots, got {D}")


def _check_candidates(ret, read_fj, write_fj, n_dev):
    dev = _device_of(ret)
    if ret.dim() != 2:
        raise ValueError(f"ret must be [C, D], got {tuple(ret.shape)}")
    C, D = ret.shape
    _check_slots(dev, C, D, read_fj, write_fj, n_dev)
    _check("ret", ret, dev, torch.float64, (C, D))
    return dev, C, D


def _check_index(ret_u, ridx, read_fj, write_fj, n_dev):
    """The retention index and the energies of a refresh-aware call."""
    dev = _device_of(ridx)
    if ridx.dim() != 2:
        raise ValueError(f"ridx must be [C, D], got {tuple(ridx.shape)}")
    C, D = ridx.shape
    _check_slots(dev, C, D, read_fj, write_fj, n_dev)
    _check("ridx", ridx, dev, torch.int32, (C, D))
    if ret_u.dim() != 1:
        raise ValueError(f"ret_u must be [R], got {tuple(ret_u.shape)}")
    _check("ret_u", ret_u, dev, torch.float64, (ret_u.shape[0],))
    return dev, C, D


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _build.load_library("compose_policy")
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.compose_policy_rf_launch.argtypes = [P, P, P, P, I, I, P, LL, P, P,
                                             P, LL, P, P, P]
    lib.compose_policy_retention_launch.argtypes = [P, I, P, P, P, LL, LL,
                                                    LL, P, P, P, P, P]
    lib.compose_policy_ra_candidates_launch.argtypes = [
        P, I, P, P, P, P, I, I, P, P, P, LL, LL, I, P, P, P]
    lib.compose_policy_ra_decide_launch.argtypes = [P, P, P, P, I, I, P, LL,
                                                    P, P, P, P]
    for fn in (lib.compose_policy_rf_launch,
               lib.compose_policy_retention_launch,
               lib.compose_policy_ra_candidates_launch,
               lib.compose_policy_ra_decide_launch,
               lib.compose_policy_range_lifetimes,
               lib.compose_policy_thread_lifetimes,
               lib.compose_policy_candidate_block,
               lib.compose_policy_max_retentions,
               lib.compose_policy_max_devices):
        fn.restype = ctypes.c_int
    if (lib.compose_policy_max_devices() != MAX_DEVICES
            or lib.compose_policy_max_retentions() != MAX_RETENTIONS):
        raise RuntimeError("compose_policy library and wrapper disagree on "
                           "the device-slot or retention limit")
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
        if x is not None:
            _check(name, x, dev, torch.float64, (L,))
    return L


def _stream(dev):
    return torch._C._cuda_getCurrentRawStream(dev.index)


def policy_retention(ret_u, lt, bits, seg=None, n_addr=0):
    """The retention pass: ``(rs, floor_part)``, one of them None.
    ``ret_u`` [R] float64, ``lt``, ``bits`` [L] float64.  With ``seg`` [L]
    int32 (segment ids 0..n_addr-1, ascending: the lifetimes sorted by
    address), ``rs`` [R, n_addr] float64 holds each address's sum of
    ``max(ceil(lt / ret) - 1, 0) * bits`` (on CUDA the pass and its join).
    Without, ``floor_part`` [R, P] float64 holds partial sums of
    ``floor(lt / ret) * bits`` (the caller sums each row in a fixed order;
    one launch).  With R = 0 nothing launches."""
    dev = _device_of(lt)
    L = _check_lifetimes(dev, lt, None, bits)
    R = ret_u.shape[0]
    _check("ret_u", ret_u, dev, torch.float64, (R,))
    if seg is not None:
        _check("seg", seg, dev, torch.int32, (L,))
        if n_addr < 1:
            raise ValueError("the retention pass needs at least one address "
                             "with seg")
    if dev.type == "cpu":
        return policy_retention_plain(ret_u, lt, bits, seg, n_addr)
    f64 = torch.float64
    if R == 0:
        return ((torch.empty(0, n_addr, dtype=f64, device=dev), None)
                if seg is not None else
                (None, torch.zeros(0, 1, dtype=f64, device=dev)))
    lib = _launcher()
    n_ranges = -(-L // lib.compose_policy_range_lifetimes())
    rs = pieces = floor_part = None
    if seg is not None:
        rs = torch.empty(R, n_addr, dtype=f64, device=dev)
        pieces = torch.empty(2, R, n_ranges, dtype=f64, device=dev)
    else:
        floor_part = torch.empty(R, n_ranges, dtype=f64, device=dev)
    with _on_device(dev):
        err = lib.compose_policy_retention_launch(
            ret_u.data_ptr(), R, lt.data_ptr(), bits.data_ptr(),
            None if seg is None else seg.data_ptr(), L, n_addr, n_ranges,
            None if rs is None else rs.data_ptr(),
            None if floor_part is None else floor_part.data_ptr(),
            None if pieces is None else pieces[0].data_ptr(),
            None if pieces is None else pieces[1].data_ptr(), _stream(dev))
    policy_retention.launches += 1
    _raise_on(err, "retention pass")
    return rs, floor_part


def _check_candidate_pass(ret_u, ridx, read_fj, write_fj, n_dev, lt,
                          read_bits, bits):
    dev, C, D = _check_index(ret_u, ridx, read_fj, write_fj, n_dev)
    L = _check_lifetimes(dev, lt, read_bits, bits)
    if dev.type == "cuda" and ret_u.shape[0] > MAX_RETENTIONS:
        raise ValueError(f"a candidate pass takes up to {MAX_RETENTIONS} "
                         f"distinct retentions, got {ret_u.shape[0]}: split "
                         "the candidates (ops.retention_groups)")
    return dev, C, D, L


def _launch_candidates(wrapper, ret_u, ridx, read_fj, write_fj, n_dev, lt,
                       read_bits, bits, C, D, L, want_picks):
    dev = lt.device
    lib = _launcher()
    n_blocks = -(-L // lib.compose_policy_candidate_block())
    energy_part = torch.empty(C, n_blocks, dtype=torch.float64, device=dev)
    picks = (torch.empty(C, L, dtype=torch.int8, device=dev) if want_picks
             else None)
    with _on_device(dev):
        err = lib.compose_policy_ra_candidates_launch(
            ret_u.data_ptr(), ret_u.shape[0],
            *_ptrs(ridx, read_fj, write_fj, n_dev), C, D,
            *_ptrs(lt, read_bits, bits), L, n_blocks, int(want_picks),
            energy_part.data_ptr(),
            None if picks is None else picks.data_ptr(), _stream(dev))
    wrapper.launches += 1
    _raise_on(err, "refresh-aware candidate")
    return energy_part, picks


def policy_ra_grouped(ret_u, ridx, read_fj, write_fj, n_dev, lt, read_bits,
                      bits):
    """The candidate pass with address groups: energy partials [C, P] (fJ).
    ``lt``, ``read_bits`` (reads * bits), ``bits`` [L] float64 in any one
    order; on CUDA at most :data:`MAX_RETENTIONS` rows in ``ret_u``."""
    args = (ret_u, ridx, read_fj, write_fj, n_dev, lt, read_bits, bits)
    dev, C, D, L = _check_candidate_pass(*args)
    if dev.type == "cpu":
        return policy_ra_grouped_plain(*args)
    return _launch_candidates(policy_ra_grouped, *args, C, D, L, False)[0]


def policy_ra_ungrouped(ret_u, ridx, read_fj, write_fj, n_dev, lt, read_bits,
                        bits):
    """The candidate pass without address groups: energy partials [C, P]
    (fJ) and per-lifetime device picks [C, L] (int8), lifetimes in the
    caller's order."""
    args = (ret_u, ridx, read_fj, write_fj, n_dev, lt, read_bits, bits)
    dev, C, D, L = _check_candidate_pass(*args)
    if dev.type == "cpu":
        return policy_ra_ungrouped_plain(*args)
    return _launch_candidates(policy_ra_ungrouped, *args, C, D, L, True)


def policy_ra_decide(ridx, read_fj, write_fj, n_dev, rs, addr_bits,
                     addr_read_bits):
    """Pick counts [C, D] (int64) of the per-address decision: ``rs`` [R,
    A] float64 from :func:`policy_retention`, ``addr_bits``,
    ``addr_read_bits`` [A] float64 per-address sums."""
    dev = _device_of(ridx)
    if ridx.dim() != 2:
        raise ValueError(f"ridx must be [C, D], got {tuple(ridx.shape)}")
    C, D = ridx.shape
    _check_slots(dev, C, D, read_fj, write_fj, n_dev)
    _check("ridx", ridx, dev, torch.int32, (C, D))
    if rs.dim() != 2 or rs.shape[1] < 1:
        raise ValueError("the decision needs at least one address, got rs "
                         f"of shape {tuple(rs.shape)}")
    R, A = rs.shape
    _check("rs", rs, dev, torch.float64, (R, A))
    _check("addr_bits", addr_bits, dev, torch.float64, (A,))
    _check("addr_read_bits", addr_read_bits, dev, torch.float64, (A,))
    if dev.type == "cpu":
        return policy_ra_decide_plain(ridx, read_fj, write_fj, n_dev, rs,
                                      addr_bits, addr_read_bits)
    counts = torch.zeros(C, D, dtype=torch.int64, device=dev)
    with _on_device(dev):
        err = _launcher().compose_policy_ra_decide_launch(
            *_ptrs(ridx, read_fj, write_fj, n_dev), C, D, rs.data_ptr(), A,
            *_ptrs(addr_bits, addr_read_bits, counts), _stream(dev))
    policy_ra_decide.launches += 1
    _raise_on(err, "refresh-aware decide")
    return counts


KERNELS = (policy_rf, policy_retention, policy_ra_grouped,
           policy_ra_ungrouped, policy_ra_decide)
for _fn in KERNELS:
    _fn.launches = 0
del _fn
