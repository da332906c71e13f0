"""Bit-cell level mockups of on-chip memory devices (paper §6.2).

All devices are modeled at the TSMC N5 node. SRAM numbers follow the
0.021 um^2/bit cell reported for the 5 nm platform [69, 70]; GCRAM numbers
are scaled so the paper's headline *ratios* reproduce exactly:

  - Si-GCRAM:     41.97% of SRAM area, 33.23% of SRAM access energy,
                  retention 1 us independent of write frequency.
  - Hybrid-GCRAM: 22.63% of SRAM area, 84.81% of SRAM access energy,
                  retention 10 us at low write frequency, declining ~1/f_w
                  past a knee (paper Fig. 5, [34]).

Refresh semantics (Algorithm 1): one refresh = one read + one write of the
bit.  A device with infinite retention never refreshes.

Per-operation accounting: reads bill ``read_fj_per_bit``, writes bill
``write_fj_per_bit``, and a refresh bills both — nothing in the stack
collapses them into a single per-access energy (asymmetric families
like SOT-MRAM depend on it).  :meth:`DeviceModel.op_energy_fj` is the
canonical billing expression.

``DEFAULT_DEVICES`` is a lazy re-export built by the device-family
registry (``repro_torch.devices.get_device_family("sram-gaincell-default")``)
— object-for-object the historical ``(SRAM, SI_GCRAM, HYBRID_GCRAM)``
tuple, kept for backward compatibility; new code should resolve device
sets through the registry.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

SRAM_AREA_UM2_PER_BIT = 0.021
SRAM_READ_FJ_PER_BIT = 15.0
SRAM_WRITE_FJ_PER_BIT = 18.0


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    name: str
    area_um2_per_bit: float
    read_fj_per_bit: float
    write_fj_per_bit: float
    retention_s: float  # base retention (inf for SRAM / long-term NVM)
    retention_knee_hz: float = math.inf  # write freq where retention degrades

    @property
    def area_vs_sram(self) -> float:
        """Cell-area ratio over the N5 SRAM bit cell (paper Table 5)."""
        return self.area_um2_per_bit / SRAM_AREA_UM2_PER_BIT

    def area_um2(self, bits: float) -> float:
        """Array area for a capacity of ``bits`` bits, in um^2."""
        return self.area_um2_per_bit * bits

    def retention_at(self, write_freq_hz: float) -> float:
        """Retention time under a given write frequency (paper Fig. 5)."""
        if not math.isfinite(self.retention_s):
            return math.inf
        if not math.isfinite(self.retention_knee_hz) or write_freq_hz <= 0:
            return self.retention_s
        degr = max(1.0, write_freq_hz / self.retention_knee_hz)
        return self.retention_s / degr

    def refresh_energy_fj_per_bit(self) -> float:
        return self.read_fj_per_bit + self.write_fj_per_bit

    def op_energy_fj(self, read_bits: float, write_bits: float,
                     refresh_bits: float = 0.0) -> float:
        """Per-operation billing: ``E_r*(N_r + R) + E_w*(N_w + R)``.

        Reads and writes bill their own energies; one refresh = one
        read + one write of the bit (Algorithm 1).  Every energy path
        in the stack reduces to this expression — read and write costs
        are never collapsed into a single per-access number.
        """
        return (self.read_fj_per_bit * (read_bits + refresh_bits)
                + self.write_fj_per_bit * (write_bits + refresh_bits))


SRAM = DeviceModel(
    name="SRAM",
    area_um2_per_bit=SRAM_AREA_UM2_PER_BIT,
    read_fj_per_bit=SRAM_READ_FJ_PER_BIT,
    write_fj_per_bit=SRAM_WRITE_FJ_PER_BIT,
    retention_s=math.inf,
)

SI_GCRAM = DeviceModel(
    name="Si-GCRAM",
    area_um2_per_bit=0.4197 * SRAM_AREA_UM2_PER_BIT,
    read_fj_per_bit=0.3323 * SRAM_READ_FJ_PER_BIT,
    write_fj_per_bit=0.3323 * SRAM_WRITE_FJ_PER_BIT,
    retention_s=1.0e-6,
)

HYBRID_GCRAM = DeviceModel(
    name="Hybrid-GCRAM",
    area_um2_per_bit=0.2263 * SRAM_AREA_UM2_PER_BIT,
    read_fj_per_bit=0.8481 * SRAM_READ_FJ_PER_BIT,
    write_fj_per_bit=0.8481 * SRAM_WRITE_FJ_PER_BIT,
    retention_s=1.0e-5,
    retention_knee_hz=1.0e7,
)

_DEFAULT_DEVICES_CACHE: tuple | None = None


def _default_devices() -> tuple:
    """The paper device set, routed through the family registry.  The
    ``sram-gaincell-default`` build returns the exact module-level
    objects above, so the lazy re-export is bit-for-bit the historical
    literal tuple."""
    global _DEFAULT_DEVICES_CACHE
    if _DEFAULT_DEVICES_CACHE is None:
        from repro_torch.devices import get_device_family
        _DEFAULT_DEVICES_CACHE = get_device_family(
            "sram-gaincell-default").build()
    return _DEFAULT_DEVICES_CACHE


def __getattr__(name: str):
    # lazy back-compat re-export (see module docstring)
    if name == "DEFAULT_DEVICES":
        return _default_devices()
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")


def device_by_name(name: str) -> DeviceModel:
    for d in _default_devices():
        if d.name.lower() == name.lower():
            return d
    raise KeyError(name)


def refresh_counts(
    lifetimes_s: np.ndarray,
    bits: np.ndarray,
    device: DeviceModel,
    write_freq_hz: float,
) -> np.ndarray:
    """Bit-refresh count per lifetime: floor(T_k / t_ret(f_w)) * B_k."""
    t_ret = device.retention_at(write_freq_hz)
    if not math.isfinite(t_ret):
        return np.zeros_like(np.asarray(lifetimes_s))
    return np.floor(np.asarray(lifetimes_s) / t_ret) * np.asarray(bits)
