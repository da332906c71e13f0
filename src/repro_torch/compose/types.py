"""Composition result schema (paper §7.1.5, Table 7).

``Composition`` is the output of the policy engine
(:mod:`repro_torch.compose.engine`): one datum→device assignment for one
subpartition, expressed as capacity fractions per device plus active
energy and area against the in-set SRAM baselines.  It lives in its own
dependency-free module so ``repro_torch.core.composer`` (the legacy front
door) and the engine can share it without an import cycle.

Fields added by the policy engine on top of the seed schema:

  ``policy``        the canonical name of the assignment policy that
                    produced this composition (``"refresh-free"`` for
                    the seed semantics)
  ``quantization``  bank-quantization report (``None`` unless a
                    ``bank-quantized`` policy ran): ``n_banks``, per
                    device ``banks`` counts, the ``unquantized_fractions``
                    the snap started from, and the capacity ``slack``
                    (quantized minus unquantized total, always >= 0)
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Composition:
    devices: tuple                      # device names, cheapest-energy first
    capacity_fractions: np.ndarray      # per device; sums to 1 unquantized,
                                        # >= 1 under bank quantization
    energy_j: float                     # hetero active energy (+ refresh
                                        # where the policy bills it)
    energy_vs_sram: float               # ratio over monolithic SRAM
    monolithic_energy_j: dict           # device -> monolithic energy (with refresh)
    area_um2: float = 0.0               # hetero array area (capacity-weighted)
    area_vs_sram: float = 1.0           # ratio over an all-SRAM array
    policy: str = "refresh-free"        # assignment policy (canonical name)
    quantization: dict | None = None    # bank-quantization report, or None

    def summary(self) -> str:
        caps = " / ".join(
            f"{d}:{100 * c:.1f}%" for d, c in
            zip(self.devices, self.capacity_fractions))
        s = (f"[{caps}] E={self.energy_j:.3e} J "
             f"({100 * self.energy_vs_sram:.1f}% of SRAM), "
             f"A={100 * self.area_vs_sram:.1f}% of SRAM")
        if self.policy != "refresh-free":
            s += f" [{self.policy}]"
        if self.quantization is not None:
            s += f" (bank slack {100 * self.quantization['slack']:.1f}%)"
        return s
