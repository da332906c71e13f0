"""Analytical frontend (paper §6, Algorithm 1).

Consumes the canonical trace format from any backend, extracts lifetimes and
access statistics per subpartition, and correlates them with memory-device
mockups to project refresh counts, active energy and area.  Lifetimes are
extracted on the torch ``device``; everything after runs in numpy on the
valid lifetimes copied back to the host.

All quantities are accounted in *bits*: an access of one block touches
``block_bits`` bits; one refresh of a block is a read plus a write of its
bits (Algorithm 1, AnalyzeEnergy).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Sequence

import numpy as np

from repro_torch.core.devices import DEFAULT_DEVICES, DeviceModel
from repro_torch.core.lifetime import LifetimeStats, lifetimes_of_trace
from repro_torch.core.trace import Trace


@dataclasses.dataclass(frozen=True)
class SubpartitionStats:
    """Architecture-agnostic statistics for one memory subpartition."""
    name: str
    n_reads: int
    n_writes: int
    n_unique_addrs: int
    duration_s: float
    write_freq_hz: float
    read_freq_hz: float
    lifetimes_s: np.ndarray        # valid lifetimes, seconds
    lifetime_bits: np.ndarray      # bits per lifetime (block granularity)
    accesses_per_lifetime: np.ndarray
    orphan_fraction: float
    block_bits: int

    @property
    def capacity_bits(self) -> int:
        return self.n_unique_addrs * self.block_bits


@dataclasses.dataclass(frozen=True)
class DeviceReport:
    device: str
    refresh_bits: float
    read_bits: float
    write_bits: float
    active_energy_j: float
    area_mm2: float
    area_vs_sram: float
    retention_s: float

    def asdict(self):
        return dataclasses.asdict(self)


def compute_stats(
    trace: Trace,
    sub: int,
    mode: str = "scratchpad",
    write_allocate: bool = True,
    device=None,
) -> SubpartitionStats:
    """Phase 1 + lifetime analysis for one subpartition."""
    t = trace.select(sub)
    stats = lifetimes_of_trace(t, mode=mode, write_allocate=write_allocate,
                               device=device)
    return stats_from_lifetimes(t, sub, stats)


def stats_from_lifetimes(
    t: Trace,
    sub: int,
    stats: LifetimeStats,
) -> SubpartitionStats:
    """Build SubpartitionStats from a single-subpartition trace and its
    already-extracted lifetimes (shared by compute_stats and the
    ProfileSession pipeline, which reuses the extraction for compose())."""
    n_reads, n_writes = t.counts()
    addrs = np.asarray(t.addr)
    n_unique = int(len(np.unique(addrs))) if len(addrs) else 0
    dur = max(t.duration_s, 1e-30)

    host = stats.numpy()        # valid rows only, copied to the host once
    lt_s = host.lifetime_cycles / t.clock_hz
    n_rd = host.n_reads
    orphan = host.orphan

    return SubpartitionStats(
        name=t.names[sub] if sub < len(t.names) else f"sub{sub}",
        n_reads=n_reads,
        n_writes=n_writes,
        n_unique_addrs=n_unique,
        duration_s=dur,
        write_freq_hz=n_writes / dur,
        read_freq_hz=n_reads / dur,
        lifetimes_s=lt_s,
        lifetime_bits=np.full(lt_s.shape, t.block_bits, np.float64),
        accesses_per_lifetime=(n_rd + 1).astype(np.float64),
        orphan_fraction=float(orphan.mean()) if len(orphan) else 0.0,
        block_bits=t.block_bits,
    )


def analyze_refresh(
    stats: SubpartitionStats, device: DeviceModel) -> float:
    """AnalyzeRefresh: R_r = sum_k floor(T_k / t_ret(f_w)) * B_k."""
    t_ret = device.retention_at(stats.write_freq_hz)
    if not math.isfinite(t_ret):
        return 0.0
    return float(
        (np.floor(stats.lifetimes_s / t_ret) * stats.lifetime_bits).sum())


def analyze_area(stats: SubpartitionStats, device: DeviceModel) -> float:
    """AnalyzeArea: A_r = A_cell * B_addr * N_addr, in mm^2."""
    return device.area_um2_per_bit * stats.capacity_bits * 1e-6


def analyze_energy(
    stats: SubpartitionStats, device: DeviceModel) -> tuple[float, float]:
    """AnalyzeEnergy: E = E_r*(N_r + R) + E_w*(N_w + R), joules.

    Returns (energy_j, refresh_bits).
    """
    refresh = analyze_refresh(stats, device)
    read_bits = stats.n_reads * stats.block_bits
    write_bits = stats.n_writes * stats.block_bits
    e_fj = device.op_energy_fj(read_bits, write_bits, refresh)
    return e_fj * 1e-15, refresh


def device_report(
    stats: SubpartitionStats, device: DeviceModel) -> DeviceReport:
    energy, refresh = analyze_energy(stats, device)
    return DeviceReport(
        device=device.name,
        refresh_bits=refresh,
        read_bits=float(stats.n_reads * stats.block_bits),
        write_bits=float(stats.n_writes * stats.block_bits),
        active_energy_j=energy,
        area_mm2=analyze_area(stats, device),
        area_vs_sram=device.area_vs_sram,
        retention_s=device.retention_at(stats.write_freq_hz),
    )


def subpartition_entry(
    st: SubpartitionStats,
    devices: Sequence[DeviceModel] = DEFAULT_DEVICES,
) -> dict:
    """One subpartition's JSON report entry (paper §6.3)."""
    entry = {
        "n_reads": st.n_reads,
        "n_writes": st.n_writes,
        "unique_addrs": st.n_unique_addrs,
        "capacity_bits": st.capacity_bits,
        "duration_s": st.duration_s,
        "write_freq_hz": st.write_freq_hz,
        "orphan_fraction": st.orphan_fraction,
        "n_lifetimes": int(len(st.lifetimes_s)),
        "mean_lifetime_s": float(st.lifetimes_s.mean())
        if len(st.lifetimes_s) else 0.0,
        "max_lifetime_s": float(st.lifetimes_s.max())
        if len(st.lifetimes_s) else 0.0,
        "devices": {},
    }
    for dev in devices:
        entry["devices"][dev.name] = device_report(st, dev).asdict()
    return entry


def analyze_trace(
    trace: Trace,
    mode: str = "scratchpad",
    write_allocate: bool = True,
    devices: Sequence[DeviceModel] = DEFAULT_DEVICES,
    device=None,
) -> dict:
    """Full Algorithm-1 pipeline over every subpartition of a trace.

    Returns the JSON-serializable report described in paper §6.3.
    """
    report = {"mode": mode, "write_allocate": write_allocate,
              "subpartitions": {}}
    subs = np.unique(np.asarray(trace.subpartition))
    for sub in subs.tolist():
        st = compute_stats(trace, int(sub), mode, write_allocate,
                           device=device)
        report["subpartitions"][st.name] = subpartition_entry(st, devices)
    return report


def dump_report(report: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(report, f, indent=2)


def energy_ratio_vs_sram(report: dict, sub_name: str, device: str) -> float:
    """Active-energy ratio of a device over SRAM for one subpartition
    (paper Table 6)."""
    subs = report.get("subpartitions", {})
    if sub_name not in subs:
        raise ValueError(
            f"subpartition {sub_name!r} not in report "
            f"(have {sorted(subs)})")
    devs = subs[sub_name].get("devices", {})
    if not devs:
        raise ValueError(
            f"subpartition {sub_name!r} was analyzed with an empty "
            "device set; re-run analyze with at least SRAM")
    if "SRAM" not in devs:
        raise ValueError(
            "energy_ratio_vs_sram needs an SRAM baseline but the device "
            f"set is {sorted(devs)}; include SRAM in `devices`")
    if device not in devs:
        raise ValueError(
            f"device {device!r} not in report (have {sorted(devs)})")
    return devs[device]["active_energy_j"] / devs["SRAM"]["active_energy_j"]
