"""Fused sweep executor: device-resident trace state + the policy kernels.

``evaluate(..., engine="torch")`` hands the whole candidate grid to
:func:`run_batch`, which evaluates it against one subpartition's trace
with the hand-written policy kernels of ``kernels/compose_policy`` (B7):

* **Device residency** — the trace arrays a policy kernel reads are
  uploaded once per subpartition and device (memoized on the identity of
  the host-side :func:`repro_torch.compose.engine.sorted_trace_view`,
  itself memoized per ``(stats, raw)`` pair) and reused across every
  candidate batch, policy and geometry: the value-sorted lifetimes with
  their ``[n_lt + 1]`` prefix sums and the sorted per-address
  max-lifetimes (refresh-free), the address-sorted lifetimes, read bits,
  bits and segment ids with the per-address sums of bits and read bits
  (refresh-aware, taken once on the host in a fixed order), and the
  original-order arrays (refresh-aware without addresses).

* **Refresh work once per distinct retention** — a refresh-aware call
  indexes the batch's distinct finite retentions (``ops.retention_index``)
  and runs the retention pass over them, then the candidate pass (and, with
  address groups, the decision per address).  The kernels take runtime
  extents, so there are no shape buckets, no padding of ``L``/``A``/``D``/
  ``C`` and no compile per shape (the reference's pow2 buckets exist
  because its jitted kernels need fixed shapes).  Two candidate splits
  are left: a slab bounds the ``[C, L]`` int8 picks of the ungrouped
  refresh-aware kernel, which come back to the host, and a candidate pass
  takes at most ``MAX_RETENTIONS`` distinct retentions
  (``ops.retention_groups``).

* **Monolithic baselines on the card** — :func:`floor_refresh_bits` gives
  each distinct retention's Algorithm-1 refresh bits
  ``sum(floor(lt / ret) * bits)`` from the retention pass without address
  groups, memoized in the residence by retention, so they live as long as
  the trace view.  The engine bills each device's baseline from them on
  the host; no pass over the lifetimes is left there.  The sums run in the
  kernel's fixed order, not NumPy's pairwise one (ROADMAP D28).

Knife-edge reductions (capacity count division, bits-weighted fractions)
finish on the host exactly as the reference's executor does, keeping
capacity fractions — and therefore bank quantization — bit-identical to
the NumPy oracle; energy agrees within 1e-9 relative.

Thread safety: the residence memo and each residence's lazy uploads and
floor sums are guarded by locks; calls allocate their own outputs, so a
thread-parallel sweep gives the serial sweep's results bit for bit.
"""

from __future__ import annotations

import threading
import weakref

import numpy as np
import torch

from repro_torch.compose.policies import RefreshFreePolicy
from repro_torch.compose.torch_engine import (_base_policy,
                                              _host_weighted_fracs, supports)
from repro_torch.device import resolve_device
from repro_torch.kernels.compose_policy import ops

_F64 = np.float64
# bound on the [slab, L] int8 picks of one ungrouped refresh-aware launch
_PICKS_BYTES = 256 * 1024 * 1024


class TraceResidence:
    """Device-resident twins of one subpartition's ``sorted_trace_view``
    arrays on one torch device, uploaded lazily per policy family and
    reused across every candidate batch, policy and geometry."""

    def __init__(self, view, device):
        self.device = torch.device(device)
        self.n_lt = int(view.n_lt)
        self.n_addr = int(view.n_addr)
        self._lock = threading.RLock()
        self._value = None   # (lt_sorted, prefix_bits, prefix_rb, maxlt)
        self._addr_lt = None  # (lt, bits) address-sorted
        self._addr = None    # (lt, read_bits, bits, seg, a_bits, a_rbits)
        self._orig = None    # (lt, read_bits, bits) original order
        self._floor = {}     # retention (s) -> floor refresh bits

    def _put(self, a, dtype=_F64):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
            self.device)

    def value_sorted(self, view):
        """Value-sorted lifetimes, their prefix sums of bits and read
        bits, and the sorted per-address max-lifetimes (empty without
        address groups)."""
        with self._lock:
            if self._value is None:
                ml = (view.maxlt_sorted if view.maxlt_sorted is not None
                      else np.zeros(0))
                self._value = tuple(self._put(a) for a in (
                    view.lt_sorted, view.prefix_bits,
                    view.prefix_read_bits, ml))
            return self._value

    def addr_lifetimes(self, view):
        """Address-sorted lifetimes and bits (all a floor sum reads)."""
        with self._lock:
            if self._addr_lt is None:
                self._addr_lt = (self._put(view.lt_addr),
                                 self._put(view.bits_addr))
            return self._addr_lt

    def addr_sorted(self, view):
        """Address-sorted lifetimes, read bits (reads * bits), bits and
        int32 segment ids, plus the per-address sums of bits and read
        bits, each summed in address order on the host."""
        with self._lock:
            if self._addr is None:
                lt, bits = self.addr_lifetimes(view)
                rb = view.reads_addr * view.bits_addr
                seg = view.seg
                starts = np.flatnonzero(
                    np.concatenate([[True], seg[1:] != seg[:-1]]))
                a_bits = np.add.reduceat(view.bits_addr, starts)
                a_rbits = np.add.reduceat(rb, starts)
                self._addr = (lt, self._put(rb), bits,
                              self._put(seg, np.int32), self._put(a_bits),
                              self._put(a_rbits))
            return self._addr

    def original(self, lt, reads, bits):
        """Original-order lifetimes, read bits and bits (ungrouped
        refresh-aware: the per-lifetime picks must come back in oracle
        element order)."""
        with self._lock:
            if self._orig is None:
                lt, reads, bits = (np.asarray(a, _F64)
                                   for a in (lt, reads, bits))
                self._orig = (self._put(lt), self._put(reads * bits),
                              self._put(bits))
            return self._orig

    def floor_bits(self, view, batch, ret_u) -> dict:
        """``{retention: sum(floor(lt / ret) * bits)}`` for the distinct
        retentions ``ret_u``, computed on the card for those not yet held:
        over the address-sorted lifetimes when the view has addresses,
        else over the original order."""
        with self._lock:
            keys = [float(r) for r in ret_u]
            missing = [r for r in keys if r not in self._floor]
            if missing:
                if self.n_addr > 0:
                    lt, bits = self.addr_lifetimes(view)
                else:
                    lt, _, bits = self.original(batch.lt_s, batch.reads,
                                                batch.bits)
                floor = ops.floor_refresh_bits(np.asarray(missing, _F64),
                                               lt, bits)
                self._floor.update(zip(missing, floor.tolist()))
            return {r: self._floor[r] for r in keys}


# (id(view), device) -> (weakref(view), residence); the weakref guards id
# reuse and frees the device buffers when the host view (and with it the
# originating stats/raw pair) is collected.
_residence_memo: dict = {}
_memo_lock = threading.Lock()


def _residence_for(view, device) -> TraceResidence:
    device = torch.device(device)
    key = (id(view), str(device))
    with _memo_lock:
        hit = _residence_memo.get(key)
        if hit is not None and hit[0]() is view:
            return hit[1]
        res = TraceResidence(view, device)
        try:
            ref = weakref.ref(
                view, lambda _, k=key: _residence_memo.pop(k, None))
            _residence_memo[key] = (ref, res)
        except TypeError:
            pass                # view not weakref-able: skip the memo
        return res


def _rf_ungrouped_host_fracs(batch, d_max: int) -> np.ndarray:
    """raw=None capacity: reconstruct the per-lifetime first-fit picks
    on the host (``searchsorted`` into each candidate's retention
    cummax — the same interval identity as the kernel, exact integer
    picks) and reduce with the oracle's masked weighted sums."""
    chi = np.maximum.accumulate(batch.ret_s, axis=1)
    lt = np.asarray(batch.lt_s)
    ff = np.empty((chi.shape[0], lt.size), np.int64)
    for c in range(chi.shape[0]):
        ff[c] = np.searchsorted(chi[c], lt, side="left")
    np.minimum(ff, np.asarray(batch.fallback), out=ff)  # no fit -> fallback
    return _host_weighted_fracs(ff, np.asarray(batch.bits, _F64), d_max)


def evaluate_resident(base, batch, view, res: TraceResidence):
    """``(energy_j [C], capacity_fractions [C, D])`` of a batch against a
    residence of its trace view, under the base energy policy ``base``."""
    C, d_max = batch.ret_s.shape
    grouped = batch.groups is not None and view.n_addr > 0
    cands = ops.candidate_tensors(batch.ret_s, batch.read_fj,
                                  batch.write_fj, batch.pad, res.device)
    if isinstance(base, RefreshFreePolicy):
        lt_s, pbits, prbits, ml = res.value_sorted(view)
        energy, counts = ops.refresh_free(cands, lt_s, pbits, prbits, ml)
        if grouped:
            # integer counts / A on the host: correctly rounded,
            # bit-identical to the oracle's bincount / A
            return energy, counts / view.n_addr
        return energy, _rf_ungrouped_host_fracs(batch, d_max)
    ret_u, ridx = ops.retention_index(batch.ret_s, batch.pad)
    if grouped:
        energy, counts = ops.refresh_aware_grouped(
            cands, ret_u, ridx, *res.addr_sorted(view))
        return energy, counts / view.n_addr
    lt_o, rb_o, bits_o = res.original(batch.lt_s, batch.reads, batch.bits)
    bits_host = np.asarray(batch.bits, _F64)
    slab = max(1, _PICKS_BYTES // max(1, res.n_lt))
    energy = np.empty(C)
    frac = np.empty((C, d_max))
    for lo in range(0, C, slab):
        hi = min(lo + slab, C)
        e, picks = ops.refresh_aware_ungrouped(
            tuple(x[lo:hi] for x in cands), ret_u, ridx[lo:hi], lt_o, rb_o,
            bits_o)
        energy[lo:hi] = e
        frac[lo:hi] = _host_weighted_fracs(picks, bits_host, d_max)
    return energy, frac


def run_batch(pol, batch, view, device=None):
    """Evaluate the *whole* candidate batch on ``device`` (``None``: the
    CUDA device, raising without one); returns ``(energy_j [C],
    capacity_fractions [C, D])`` as NumPy arrays (D = padded width; the
    engine slices each candidate's real device count).

    ``batch`` is the engine's full-grid :class:`PolicyBatch`; ``view``
    the memoized :func:`repro_torch.compose.engine.sorted_trace_view` of
    the same ``(stats, raw)`` pair.  Capacity fractions are bit-identical
    to the NumPy oracle (integer counts / exact host sums); energy agrees
    to ~1e-9 relative."""
    base = _base_policy(pol)
    if not supports(pol):
        raise ValueError(
            f"engine='torch' has no fused kernel for policy "
            f"{base.name!r}; use engine='numpy'")
    res = _residence_for(view, resolve_device(device))
    return evaluate_resident(base, batch, view, res)


def floor_refresh_bits(batch, view, device=None) -> dict:
    """``{retention (s): sum(floor(lt / ret) * bits)}`` for every finite
    retention of ``batch``'s real device slots: the monolithic baselines'
    refresh bits (Algorithm 1's ``AnalyzeRefresh``), from the retention
    pass on ``device``, memoized with the residence of ``view``.  A
    retention's float value is its key: for the positive finite retentions
    it names the same values as the index's bit patterns."""
    res = _residence_for(view, resolve_device(device))
    ret_u, _ = ops.retention_index(batch.ret_s, batch.pad)
    return res.floor_bits(view, batch, ret_u)
