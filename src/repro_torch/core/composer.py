"""Heterogeneous on-chip memory composition (paper §7.1.5, Table 7).

Given lifetime statistics for a subpartition, assign every datum to a
device under an assignment policy and report capacity proportions per
device plus active energy/area vs an SRAM baseline and vs monolithic
single-device arrays.  The assignment itself lives in the policy-driven
engine (:mod:`repro_torch.compose`) — this module is the single-candidate
front door kept at its seed location:

  ``policy="refresh-free"`` (default)  every datum on the cheapest
      device whose retention covers it, so the array never refreshes —
      the seed semantics, bit-for-bit.
  ``policy="refresh-aware"``  minimum total-energy device per datum,
      refresh billed per Algorithm 1.
  ``policy="bank-quantized[:<base>][@<n_banks>]"``  capacity fractions
      snapped to power-of-two bank granularity atop either base.

Assignment granularity: the paper expresses compositions as *capacity*
percentages, so capacity is assigned at address granularity (refresh-free
hosts each address's longest-lived value refresh-free; refresh-aware
minimizes the address's summed total energy), while energy is accounted
per lifetime.

Energy-accounting note: each lifetime is billed as one write (its
initiating event) plus its reads.  In cache mode a lifetime may be
initiated by a read *miss*; billing it at write energy makes the hetero
estimate conservative (an all-SRAM composition can read a few percent
above the Algorithm-1 SRAM baseline on miss-heavy L2 traces).
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.compose.types import Composition
from repro_torch.core.devices import DEFAULT_DEVICES, DeviceModel
from repro_torch.core.frontend import SubpartitionStats

__all__ = ["Composition", "compose"]


def compose(
    stats: SubpartitionStats,
    raw=None,
    devices: Sequence[DeviceModel] = DEFAULT_DEVICES,
    clock_hz: float = 1.0e9,
    policy="refresh-free",
    engine="torch",
    device=None,
) -> Composition:
    """Derive the optimal composition for one subpartition under one
    assignment policy (see :mod:`repro_torch.compose`).  ``engine=``
    selects the evaluation backend (``"torch"``, the default, runs the
    policy kernels on ``device``: ``None`` is the CUDA device and raises
    without one; ``"numpy"`` is the oracle)."""
    # function scope: the engine imports repro_torch.core, whose package
    # init imports this module
    from repro_torch.compose.engine import compose as _compose
    return _compose(stats, raw=raw, devices=devices, clock_hz=clock_hz,
                    policy=policy, engine=engine, device=device)
