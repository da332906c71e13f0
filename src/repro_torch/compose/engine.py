"""The policy-driven composition engine: datum→device assignment,
natively batched over candidate device sets.

One kernel owns the assignment end-to-end: :func:`evaluate` takes *N*
candidate device sets (a single set, or a whole ``DeviceGrid``'s worth)
and evaluates the selected :class:`~repro_torch.compose.policies.
AssignmentPolicy` for all of them through one NumPy broadcast per
chunk — ``repro_torch.core.composer.compose()`` is a thin single-candidate
wrapper and a sweep feeds its whole grid through the same call, so
there is exactly one implementation of the assignment math in the tree.

Batching contract (shared with the policy kernels): candidates are
processed in chunks sized so the ``[chunk, devices, lifetimes]``
broadcast stays under ``_MAX_BROADCAST_BYTES`` at the policy's
``broadcast_itemsize`` — the per-element peak footprint *including*
concurrent temporaries (bool fit matrix + a temporary for
refresh-free, ~4 float64 arrays for refresh-aware); the per-address
grouping is computed once per subpartition and monolithic baselines
are memoized by device, so only the float reductions that define the
exact summation order remain per-candidate.

Accounting granularity (both inherited from the seed ``compose()``):
*energy* is billed per lifetime on the device the policy picks for
that lifetime; *capacity* is assigned per address (an address lives on
one device — refresh-free hosts its longest-lived value refresh-free,
refresh-aware minimizes the address's summed total energy).  With
``raw=None`` (no per-lifetime addresses available) capacity falls back
to bits-weighted per-lifetime fractions.

Guarantee: ``policy="refresh-free"`` is bit-for-bit identical to the
pre-refactor scalar ``compose()`` — device ordering, comparison
results, and float accumulation order are preserved exactly
(the reference package's tests lock it against a frozen copy of the
seed implementation, and ``tests/test_torch_pipeline.py`` holds this
engine against the reference's).

Engines: ``evaluate(..., engine="torch")`` (default; the reference's
``engine="jax"``) hands the *whole* candidate batch to the fused executor
in :mod:`repro_torch.compose.executor` (imported lazily), which keeps the
trace state resident on the torch device across calls (see
:func:`sorted_trace_view`) and runs the hand-written policy kernels of
``kernels/compose_policy`` there; the monolithic baselines' refresh bits
come from the same kernels' retention pass, once per distinct retention
and memoized with the trace view (the reference, and ``engine="numpy"``,
run ``analyze_energy`` over the lifetimes per device).  ``device=``
names that torch device (``None``: the CUDA device, raising without
one).  ``engine="numpy"`` is
the oracle: it runs the policy kernels and reductions here in NumPy,
carries the bit-for-bit guarantee above and ignores ``device``.  The two
agree bit-identically on capacity and to ~1e-9 relative energy
(``tests/test_torch_compose_engine.py``, ``tests/test_torch_executor.py``).
Any other engine raises a ``ValueError`` naming :data:`ENGINES`.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import TYPE_CHECKING, Mapping, Sequence

import numpy as np

from repro_torch.compose.policies import (AddressGroups, AssignmentPolicy,
                                          PolicyBatch, get_policy)
from repro_torch.compose.torch_engine import _segment_ids
from repro_torch.compose.types import Composition
# repro_torch.core is imported lazily (function scope): its package
# __init__ pulls the torch-backed lifetime stack, and this module is part
# of the repro_torch.compose torch-free-at-import contract
# (`python -m repro_torch check`, import-purity)
if TYPE_CHECKING:
    from repro_torch.core.devices import DeviceModel
    from repro_torch.core.frontend import SubpartitionStats

#: evaluation engines that exist
ENGINES = ("numpy", "torch")

# Cap on one candidate-chunk broadcast: chunk x devices x lifetimes
# elements at the policy's item size.  256 MB keeps the matrices
# cache-friendly without limiting total grid size.
_MAX_BROADCAST_BYTES = 256 * 1024 * 1024


def analyze_energy(stats: SubpartitionStats, device: DeviceModel):
    """:func:`repro_torch.core.frontend.analyze_energy`, imported on first
    call (see the import note above)."""
    from repro_torch.core.frontend import analyze_energy as analyze
    return analyze(stats, device)


def _access_energy_fj(device: DeviceModel) -> float:
    """Refresh-free per-bit access energy: the device-ordering key."""
    return device.read_fj_per_bit + device.write_fj_per_bit


def _device_sort_key(device: DeviceModel) -> tuple:
    """Deterministic device order: cheapest refresh-free access energy
    first, ties broken by name (equal-energy candidates are common on
    interpolated grids; input order must never matter)."""
    return (_access_energy_fj(device), device.name)


# Memo for address_groups: id(raw) -> (weakref(raw), clock_hz, groups).
# Raw lifetime records are frozen dataclasses treated as immutable
# analysis artifacts, so the grouping (a pure function of raw and the
# clock) is computed once per subpartition and reused across every
# evaluate() call — policies, engines, and benches alike.  The weakref
# guards against id reuse and evicts the entry when raw is collected.
_groups_memo: dict = {}


def address_groups(raw, clock_hz: float) -> AddressGroups:
    """Group the valid lifetimes of ``raw`` by address (stable order),
    carrying each address's max lifetime — computed once per
    subpartition (memoized on ``raw``'s identity) and shared across
    every candidate and policy."""
    key = id(raw)
    hit = _groups_memo.get(key)
    if hit is not None and hit[0]() is raw and hit[1] == clock_hz:
        return hit[2]
    # device-resident LifetimeStats hand over their host rows
    host = raw.numpy() if hasattr(raw, "numpy") else raw
    valid = np.asarray(host.valid)
    addr = np.asarray(host.addr)[valid]
    lt_cyc = np.asarray(host.lifetime_cycles)[valid]
    order = np.argsort(addr, kind="stable")
    addr_s, lt_sorted = addr[order], lt_cyc[order]
    new = np.concatenate([[True], addr_s[1:] != addr_s[:-1]])
    grp = np.cumsum(new) - 1
    max_lt = np.zeros(grp[-1] + 1 if len(grp) else 0)
    np.maximum.at(max_lt, grp, lt_sorted)
    groups = AddressGroups(order=order, starts=np.flatnonzero(new),
                           max_lt_s=max_lt / clock_hz)
    try:
        ref = weakref.ref(raw, lambda _, k=key: _groups_memo.pop(k, None))
        _groups_memo[key] = (ref, clock_hz, groups)
    except TypeError:
        pass          # raw not weakref-able: skip the memo
    return groups


def _per_address_max_lifetime_s(raw, clock_hz: float) -> np.ndarray:
    """Per-address maximum lifetime in seconds (legacy helper; the
    grouping now lives in :func:`address_groups`)."""
    return address_groups(raw, clock_hz).max_lt_s


@dataclasses.dataclass(frozen=True)
class TraceView:
    """Host-side sorted twins of one subpartition's trace arrays — every
    permutation and prefix sum the engines need, computed once per
    ``(stats, raw)`` pair (see :func:`sorted_trace_view`).

    Value-sorted side (refresh-free interval arithmetic): ``lt_sorted``
    plus ``[n_lt + 1]`` prefix sums of bits and read·bits in lifetime
    order, accumulated in ``np.longdouble`` and rounded once to float64
    so any prefix *difference* matches a direct float64 sum to ~1e-16
    relative.  Address-sorted side (refresh-aware segment reductions):
    the lifetime arrays gathered through ``groups.order`` with dense
    segment ids, and each address's max lifetime value-sorted for the
    capacity searchsorted.  Address fields are ``None`` when built with
    ``raw=None``.
    """
    n_lt: int
    n_addr: int
    lt_sorted: np.ndarray
    prefix_bits: np.ndarray
    prefix_read_bits: np.ndarray
    maxlt_sorted: np.ndarray | None
    lt_addr: np.ndarray | None
    reads_addr: np.ndarray | None
    bits_addr: np.ndarray | None
    seg: np.ndarray | None


def _view_from_arrays(lt: np.ndarray, reads: np.ndarray, bits: np.ndarray,
                      groups: AddressGroups | None) -> TraceView:
    """The :class:`TraceView` of per-lifetime arrays and their address
    grouping (``None``: no address side)."""
    n_lt = len(lt)
    order = np.argsort(lt, kind="stable")

    def prefix(a: np.ndarray) -> np.ndarray:
        p = np.zeros(n_lt + 1, np.longdouble)
        np.cumsum(a[order].astype(np.longdouble), out=p[1:])
        return p.astype(np.float64)

    maxlt_sorted = lt_addr = reads_addr = bits_addr = seg = None
    n_addr = 0
    if groups is not None:
        n_addr = len(groups.max_lt_s)
        maxlt_sorted = np.sort(groups.max_lt_s, kind="stable")
        g_order = np.asarray(groups.order)
        lt_addr = lt[g_order]
        reads_addr = reads[g_order]
        bits_addr = bits[g_order]
        seg = _segment_ids(np.asarray(groups.starts), n_lt)
    return TraceView(
        n_lt=n_lt, n_addr=n_addr, lt_sorted=lt[order],
        prefix_bits=prefix(bits), prefix_read_bits=prefix(reads * bits),
        maxlt_sorted=maxlt_sorted, lt_addr=lt_addr,
        reads_addr=reads_addr, bits_addr=bits_addr, seg=seg)


def _build_trace_view(stats: SubpartitionStats, raw,
                      clock_hz: float) -> TraceView:
    """The one host pre-sort per ``(stats, raw)`` pair (spied on by
    ``tests/test_torch_executor.py`` to prove the sweep never re-sorts)."""
    groups = address_groups(raw, clock_hz) if raw is not None else None
    return _view_from_arrays(stats.lifetimes_s,
                             stats.accesses_per_lifetime - 1.0,
                             stats.lifetime_bits, groups)


# Memo for sorted_trace_view: (id(stats), id(raw)) -> (weakref(stats),
# weakref(raw) | None, clock_hz, view) — the trace-view twin of
# _groups_memo, extending the numpy-side memoization to everything the
# torch executor keeps resident on its device.  Keyed by identity only:
# the view is a pure function of the trace and the clock, so ``engine``,
# policy and device deliberately stay out of the key — every engine
# shares one view.
_view_memo: dict = {}


def sorted_trace_view(stats: SubpartitionStats, raw,
                      clock_hz: float = 1.0e9) -> TraceView:
    """Memoized :class:`TraceView` for a ``(stats, raw)`` pair: the
    host pre-sort is done once per subpartition and reused across every
    candidate batch, policy, geometry, and engine.  Weakrefs guard id
    reuse and evict the entry (and with it the executor's device-
    resident twin) when the stats object is collected."""
    key = (id(stats), id(raw))
    hit = _view_memo.get(key)
    if (hit is not None and hit[0]() is stats
            and (hit[1] is None or hit[1]() is raw)
            and hit[2] == clock_hz):
        return hit[3]
    view = _build_trace_view(stats, raw, clock_hz)
    try:
        cb = lambda _, k=key: _view_memo.pop(k, None)  # noqa: E731
        sref = weakref.ref(stats, cb)
        rref = weakref.ref(raw, cb) if raw is not None else None
        _view_memo[key] = (sref, rref, clock_hz, view)
    except TypeError:
        pass          # stats/raw not weakref-able: skip the memo
    return view


def _area_accounting(
    devs: Sequence[DeviceModel],
    frac: np.ndarray,
    capacity_bits: float,
) -> tuple:
    """(area_um2, area_vs_sram) of a capacity-weighted hetero array.

    The baseline is the in-set SRAM device, so an all-SRAM composition
    is exactly 1.0 whatever the SRAM cell model in use.  Quantized
    fractions may sum past 1 — the slack is real silicon and is billed.
    """
    areas = np.array([d.area_um2_per_bit for d in devs])
    per_bit = float((frac * areas).sum())
    sram_per_bit = next(d.area_um2_per_bit for d in devs if d.name == "SRAM")
    return per_bit * capacity_bits, per_bit / sram_per_bit


def _energy_per_lifetime_j(
    device: DeviceModel, reads: np.ndarray, bits: np.ndarray) -> np.ndarray:
    """Refresh-free active energy of each lifetime on ``device`` (J).

    Each lifetime = 1 write (its initiation) + n reads, at block
    granularity.
    """
    e_fj = (device.write_fj_per_bit * bits
            + device.read_fj_per_bit * reads * bits)
    return e_fj * 1e-15


def _validate_sets(sets: Sequence[tuple]) -> None:
    for ds in sets:
        if not ds:
            raise ValueError("compose() needs a non-empty device set")
        if not any(d.name == "SRAM" for d in ds):
            raise ValueError(
                "compose() needs SRAM in the device set as the "
                "infinite-retention baseline; got "
                f"{sorted(d.name for d in ds)}")


def _empty_composition(stats: SubpartitionStats, devs: list,
                       device_set: tuple,
                       pol: AssignmentPolicy) -> Composition:
    """No valid lifetimes (empty trace, or every segment dead under
    no-write-allocate).  The monolithic baselines still exist: the
    accesses themselves cost energy even if no datum ever lived."""
    frac = np.zeros(len(devs))
    frac[-1] = 1.0
    frac, quant = pol.capacity(frac, devs)
    mono = {d.name: analyze_energy(stats, d)[0] for d in device_set}
    sram_e = mono["SRAM"]
    area_um2, area_ratio = _area_accounting(devs, frac, stats.capacity_bits)
    return Composition(
        devices=tuple(d.name for d in devs),
        capacity_fractions=frac,
        energy_j=0.0,
        energy_vs_sram=0.0 / sram_e if sram_e > 0 else math.nan,
        monolithic_energy_j=mono,
        area_um2=area_um2,
        area_vs_sram=area_ratio,
        policy=pol.name,
        quantization=quant,
    )


def _baseline_energy_j(stats: SubpartitionStats, device: DeviceModel,
                       floor_bits: Mapping[float, float]) -> float:
    """``analyze_energy(stats, device)[0]`` with the refresh bits taken from
    ``floor_bits`` (retention -> ``sum(floor(lt / ret) * bits)``,
    :func:`repro_torch.compose.executor.floor_refresh_bits`); an infinite
    retention refreshes nothing."""
    t_ret = device.retention_at(stats.write_freq_hz)
    refresh = floor_bits[t_ret] if math.isfinite(t_ret) else 0.0
    read_bits = stats.n_reads * stats.block_bits
    write_bits = stats.n_writes * stats.block_bits
    return device.op_energy_fj(read_bits, write_bits, refresh) * 1e-15


def _numpy_candidate(asg, k: int, devs, reads, bits, w):
    """Energy + raw capacity fractions for candidate ``k`` of a chunk's
    policy assignment — the NumPy oracle's per-candidate reductions.

    The energy loop keeps the exact float accumulation order of the
    seed ``compose()``: per-device masked sums, accumulated
    cheapest-device first.  Capacity counts come from one ``bincount``
    over the per-address picks (an exact integer count / size, so
    bit-identical to the former per-device ``np.mean(ad == i)`` loop
    without being O(D·A) per candidate); the bits-weighted ``w``
    fallback stays a masked sum — reweighting it would change the
    summation order the seed contract freezes.
    """
    ff = asg.lifetime_dev[k]
    refresh = (None if asg.refresh_per_lifetime is None
               else asg.refresh_per_lifetime[k])
    energy = 0.0
    for i, d in enumerate(devs):
        sel = ff == i
        if refresh is None:
            energy += float(_energy_per_lifetime_j(
                d, reads[sel], bits[sel]).sum())
        else:
            e_fj = (d.write_fj_per_bit * bits[sel]
                    + d.read_fj_per_bit * reads[sel] * bits[sel]
                    + refresh[sel] * d.refresh_energy_fj_per_bit()
                    * bits[sel])
            energy += float((e_fj * 1e-15).sum())
    if asg.addr_dev is not None:
        ad = asg.addr_dev[k]
        frac = np.bincount(ad, minlength=len(devs))[:len(devs)] / ad.size
    else:
        frac = np.array([w[ff == i].sum() for i in range(len(devs))])
    return energy, frac


def evaluate(
    device_sets: Sequence[Sequence[DeviceModel]],
    stats: SubpartitionStats,
    raw=None,
    *,
    clock_hz: float = 1.0e9,
    policy: AssignmentPolicy | str = "refresh-free",
    engine: str = "torch",
    device=None,
) -> list:
    """One :class:`Composition` per candidate device set, all evaluated
    through the same batched policy kernel.

    ``evaluate([devices])[0]`` is ``compose()``; ``evaluate(grid)`` is
    the sweep's inner loop.  Candidates are processed in chunks
    end-to-end (policy broadcast and reductions alike), so peak memory
    is bounded however large the grid.

    ``engine`` selects the executor (see :data:`ENGINES`): ``"torch"``
    (default; the fused executor on ``device``, ~1e-9-relative energy,
    see :mod:`repro_torch.compose.executor`) or ``"numpy"`` (the oracle,
    bit-for-bit seed contract).
    """
    if engine not in ENGINES:
        raise ValueError(
            f"engine must be one of {ENGINES}, got {engine!r}")
    pol = get_policy(policy)
    if engine == "torch":
        from repro_torch.compose import torch_engine
        from repro_torch.device import resolve_device
        if not torch_engine.supports(pol):
            raise ValueError(
                f"engine='torch' has no fused kernel for policy "
                f"{pol.name!r}; use engine='numpy'")
        device = resolve_device(device)
    sets = [tuple(ds) for ds in device_sets]
    if not sets:
        return []
    _validate_sets(sets)

    # Deterministic device order: cheapest refresh-free access energy
    # first, name-tie-broken; SRAM (infinite retention) is the usual
    # last resort.
    sorted_devs = [sorted(ds, key=_device_sort_key) for ds in sets]

    lt = stats.lifetimes_s
    if len(lt) == 0:
        return [_empty_composition(stats, devs, ds, pol)
                for devs, ds in zip(sorted_devs, sets)]

    bits = stats.lifetime_bits
    reads = stats.accesses_per_lifetime - 1.0
    groups = address_groups(raw, clock_hz) if raw is not None else None
    # capacity fallback when ungrouped: bits-weighted per-lifetime fractions
    w = bits / bits.sum() if groups is None else None

    # Monolithic baselines depend on (stats, device); memoized by device
    # — SRAM is shared by every candidate, scale variants recur.  The
    # torch engine takes each device's refresh bits from the retention
    # pass on the card (``floor_bits``, set below), the oracle from
    # ``analyze_energy``'s pass over the lifetimes.
    mono_cache: dict = {}
    floor_bits = None

    def mono_energy(d: DeviceModel) -> float:
        if d not in mono_cache:
            if floor_bits is None:
                mono_cache[d] = analyze_energy(stats, d)[0]
            else:
                mono_cache[d] = _baseline_energy_j(stats, d, floor_bits)
        return mono_cache[d]

    n_dev = np.array([len(ds) for ds in sorted_devs])
    d_max = int(n_dev.max())

    # Padded device matrices ([candidate, device], small): -inf
    # retention never fits, +inf energies never win an argmin.
    ret = np.full((len(sets), d_max), -np.inf)
    read_fj = np.full((len(sets), d_max), np.inf)
    write_fj = np.full((len(sets), d_max), np.inf)
    for ci, devs in enumerate(sorted_devs):
        ret[ci, :len(devs)] = [d.retention_at(stats.write_freq_hz)
                               for d in devs]
        read_fj[ci, :len(devs)] = [d.read_fj_per_bit for d in devs]
        write_fj[ci, :len(devs)] = [d.write_fj_per_bit for d in devs]
    pad = np.arange(d_max)[None, :] >= n_dev[:, None]
    fallback = (n_dev - 1)[:, None]

    e_all = f_all = None
    if engine == "torch":
        # The fused executor takes the whole grid at once, reuses the
        # memoized trace view's device-resident twin, and returns the
        # full [C] energy / [C, D] fraction arrays — the chunk loop
        # below only runs the host epilogue.
        from repro_torch.compose import executor
        view = sorted_trace_view(stats, raw, clock_hz)
        full = PolicyBatch(
            devs=tuple(sorted_devs), ret_s=ret, read_fj=read_fj,
            write_fj=write_fj, pad=pad, fallback=fallback,
            lt_s=lt, reads=reads, bits=bits, groups=groups)
        e_all, f_all = executor.run_batch(pol, full, view, device)
        floor_bits = executor.floor_refresh_bits(full, view, device)

    chunk = max(1, _MAX_BROADCAST_BYTES
                // max(1, d_max * len(lt) * pol.broadcast_itemsize))
    out = []
    for lo in range(0, len(sets), chunk):
        hi = min(lo + chunk, len(sets))
        if e_all is not None:
            asg = None
        else:
            batch = PolicyBatch(
                devs=tuple(sorted_devs[lo:hi]), ret_s=ret[lo:hi],
                read_fj=read_fj[lo:hi], write_fj=write_fj[lo:hi],
                pad=pad[lo:hi], fallback=fallback[lo:hi],
                lt_s=lt, reads=reads, bits=bits, groups=groups)
            asg = pol.assign(batch)
        for ci in range(lo, hi):
            devs, dset = sorted_devs[ci], sets[ci]
            if asg is None:
                energy = float(e_all[ci])
                frac = f_all[ci, :len(devs)].copy()
            else:
                energy, frac = _numpy_candidate(
                    asg, ci - lo, devs, reads, bits, w)
            frac, quant = pol.capacity(frac, devs)
            mono = {d.name: mono_energy(d) for d in dset}
            sram_e = mono["SRAM"]
            area_um2, area_ratio = _area_accounting(
                devs, frac, stats.capacity_bits)
            out.append(Composition(
                devices=tuple(d.name for d in devs),
                capacity_fractions=frac,
                energy_j=energy,
                energy_vs_sram=energy / sram_e if sram_e > 0 else math.nan,
                monolithic_energy_j=mono,
                area_um2=area_um2,
                area_vs_sram=area_ratio,
                policy=pol.name,
                quantization=quant,
            ))
    return out


def compose(
    stats: SubpartitionStats,
    raw=None,
    devices: Sequence[DeviceModel] | None = None,
    clock_hz: float = 1.0e9,
    policy: AssignmentPolicy | str = "refresh-free",
    engine: str = "torch",
    device=None,
) -> Composition:
    """Derive the composition for one subpartition under one policy —
    the single-candidate entry into :func:`evaluate` (``device``: the
    torch device of ``engine="torch"``).  ``devices=None``
    (the default) uses ``repro_torch.core.devices.DEFAULT_DEVICES``."""
    if devices is None:
        from repro_torch.core.devices import DEFAULT_DEVICES  # lazy export
        devices = DEFAULT_DEVICES
    (comp,) = evaluate([tuple(devices)], stats, raw=raw,
                       clock_hz=clock_hz, policy=policy, engine=engine,
                       device=device)
    return comp


def composition_csv_rows(compositions: Mapping[str, Composition]) -> list:
    """``subpartition,policy,area_vs_sram,energy_vs_sram,
    capacity_fractions`` rows for a ``{subpartition: Composition}`` map
    (header included) — the profile-report twin of
    ``SweepResult.csv_rows()``, sharing its formatting conventions
    (``%.9g`` ratios, ``dev:frac|...`` capacity maps, comma-safe
    quoting)."""
    import csv
    import io
    buf = io.StringIO()
    w = csv.writer(buf, lineterminator="\n")
    w.writerow(["subpartition", "policy", "area_vs_sram",
                "energy_vs_sram", "capacity_fractions"])
    for name, comp in compositions.items():
        caps = "|".join(
            f"{d}:{c:.6g}" for d, c in
            zip(comp.devices, comp.capacity_fractions))
        w.writerow([name, comp.policy, f"{comp.area_vs_sram:.9g}",
                    f"{comp.energy_vs_sram:.9g}", caps])
    return buf.getvalue().splitlines()
