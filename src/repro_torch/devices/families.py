"""Built-in device families: sram, gaincell (OpenGCRAM-style), sot-mram.

All numbers anchor on the N5 cell mockups in ``repro_torch.core.devices``;
the family factories lazy-import that module so this package stays stdlib-only
at import (the campaign planner and ``python -m repro_torch devices`` list
schemas without touching numpy).

``gaincell`` is the parametric Si <-> Hybrid continuum the
``DeviceGrid`` sweep has always interpolated (OpenGCRAM, arXiv
2507.10849: transistor flavor, storage-node sizing, and periphery trade
retention against area and access energy).  ``DeviceGrid.gain_cell``
now delegates to :func:`gain_cell_model`, so the family *is* the old
interpolation — default params rebuild ``DEFAULT_DEVICES``
object-for-object, which keeps every degenerate-sweep oracle
bit-for-bit (the ``sram-gaincell-default`` alias names that point).

``sot-mram`` models a non-volatile spin-orbit-torque MRAM with strongly
asymmetric per-operation energy: resistive reads are cheaper than SRAM
while the write pulse driving the magnetization switch costs several
SRAM writes — exactly the device class where collapsing read/write into
one per-access energy mis-assigns data (the STCO line of work).
Retention follows thermal activation ``tau0 * exp(delta)`` with
``tau0 = 1 ns``, so the default stability factor ``delta = 60`` is
non-volatile on any trace timescale and never refreshes.
"""

from __future__ import annotations

import math

from repro_torch.devices.registry import FamilyParam, register_device_family

#: delta at/above which retention is reported as exactly infinite
#: (exp() would overflow long before float math becomes meaningful)
_SOT_DELTA_INF = 200.0


def _geo(a: float, b: float, t: float) -> float:
    """Geometric interpolation a^(1-t) * b^t (log-linear)."""
    return a ** (1.0 - t) * b ** t


def _gc_name(mix, r, a, e) -> str:
    return f"GC[m={mix:g},r={r:g},a={a:g},e={e:g}]"


def gain_cell_model(
    mix: float,
    retention_scale: float = 1.0,
    area_scale: float = 1.0,
    energy_scale: float = 1.0,
    periphery_area_frac: float = 0.0,
    periphery_energy_frac: float = 0.0,
):
    """One parametric gain-cell device on the Si <-> Hybrid continuum.

    ``mix=0`` with unit scales and zero periphery returns ``SI_GCRAM``
    itself and ``mix=1`` returns ``HYBRID_GCRAM`` (exact objects, so
    degenerate grids reproduce the paper's fixed device set
    bit-for-bit).  Interior mixes interpolate area, access energy, and
    retention geometrically; the write-frequency knee interpolates in
    ``1/knee`` space (Si has no knee, so ``mix -> 0`` pushes the knee
    to infinity).  The periphery fractions model sense-amp/periphery
    overhead: area and read+write energy each scale by ``1 + frac``.
    """
    from repro_torch.core.devices import HYBRID_GCRAM, SI_GCRAM, DeviceModel
    if not 0.0 <= mix <= 1.0:
        raise ValueError(f"mix must be in [0, 1], got {mix}")
    scales = (retention_scale, area_scale, energy_scale)
    if any(s <= 0 for s in scales):
        raise ValueError(f"scales must be positive, got {scales}")
    periph = (periphery_area_frac, periphery_energy_frac)
    if any(p < 0 for p in periph):
        raise ValueError(f"periphery fractions must be >= 0, got {periph}")
    if scales == (1.0, 1.0, 1.0) and periph == (0.0, 0.0):
        if mix == 0.0:
            return SI_GCRAM
        if mix == 1.0:
            return HYBRID_GCRAM
    si, hy = SI_GCRAM, HYBRID_GCRAM
    knee_hz = math.inf if mix == 0.0 else hy.retention_knee_hz / mix
    area_scale = area_scale * (1.0 + periphery_area_frac)
    energy_scale = energy_scale * (1.0 + periphery_energy_frac)
    return DeviceModel(
        name=_gc_name(mix, retention_scale, area_scale, energy_scale),
        area_um2_per_bit=_geo(si.area_um2_per_bit, hy.area_um2_per_bit,
                              mix) * area_scale,
        read_fj_per_bit=_geo(si.read_fj_per_bit, hy.read_fj_per_bit,
                             mix) * energy_scale,
        write_fj_per_bit=_geo(si.write_fj_per_bit, hy.write_fj_per_bit,
                              mix) * energy_scale,
        retention_s=_geo(si.retention_s, hy.retention_s,
                         mix) * retention_scale,
        retention_knee_hz=knee_hz,
    )


# ---------------------------------------------------------------------------
# sram — the anchor family
# ---------------------------------------------------------------------------

@register_device_family(
    "sram",
    description="all-SRAM anchor: the N5 6T cell every composition is "
                "normalized against (optionally area/energy rescaled)",
    params=(
        FamilyParam("area_scale", 1.0, "cell-area multiplier"),
        FamilyParam("energy_scale", 1.0, "read+write energy multiplier"),
    ),
)
def _build_sram(params):
    from repro_torch.core.devices import SRAM, DeviceModel
    a, e = params["area_scale"], params["energy_scale"]
    if a <= 0 or e <= 0:
        raise ValueError(f"scales must be positive, got {(a, e)}")
    if (a, e) == (1.0, 1.0):
        return (SRAM,)
    return (DeviceModel(
        name="SRAM",
        area_um2_per_bit=SRAM.area_um2_per_bit * a,
        read_fj_per_bit=SRAM.read_fj_per_bit * e,
        write_fj_per_bit=SRAM.write_fj_per_bit * e,
        retention_s=math.inf),)


# ---------------------------------------------------------------------------
# gaincell — the OpenGCRAM-style parametric continuum
# ---------------------------------------------------------------------------

@register_device_family(
    "gaincell",
    description="OpenGCRAM-style parametric gain cells on the Si<->Hybrid "
                "continuum: SRAM anchor + one device per mix, with "
                "retention/area/energy cell knobs and periphery overheads",
    aliases=("opengcram", "sram-gaincell-default"),
    params=(
        FamilyParam("mixes", (0.0, 1.0),
                    "Si<->Hybrid process-flavor points in [0,1] "
                    "(':'-separated in one axis value)", kind="floats"),
        FamilyParam("retention_scale", 1.0,
                    "retention multiplier (storage-node sizing)"),
        FamilyParam("area_scale", 1.0, "cell-area multiplier"),
        FamilyParam("energy_scale", 1.0, "access-energy multiplier"),
        FamilyParam("periphery_area_frac", 0.0,
                    "sense-amp/periphery area overhead fraction"),
        FamilyParam("periphery_energy_frac", 0.0,
                    "sense-amp/periphery energy overhead fraction"),
    ),
    default_axes={"retention_scale": (0.5, 1.0, 2.0)},
)
def _build_gaincell(params):
    from repro_torch.core.devices import SRAM
    gcs = tuple(gain_cell_model(
        m,
        retention_scale=params["retention_scale"],
        area_scale=params["area_scale"],
        energy_scale=params["energy_scale"],
        periphery_area_frac=params["periphery_area_frac"],
        periphery_energy_frac=params["periphery_energy_frac"],
    ) for m in params["mixes"])
    return (SRAM,) + gcs


# ---------------------------------------------------------------------------
# sot-mram — non-volatile, strongly asymmetric read vs. write
# ---------------------------------------------------------------------------

@register_device_family(
    "sot-mram",
    description="non-volatile SOT-MRAM: cheap resistive reads, expensive "
                "write pulses (read_fj << write_fj), retention "
                "tau0*exp(delta) — never refreshes at default stability",
    params=(
        FamilyParam("delta", 60.0,
                    "thermal stability factor; retention = 1ns*exp(delta)"
                    f" (inf at >= {_SOT_DELTA_INF:g})"),
        FamilyParam("write_pulse_ns", 1.0,
                    "write pulse width; write energy scales linearly"),
        FamilyParam("read_ratio", 0.35,
                    "read energy vs the SRAM read (resistive sensing)"),
        FamilyParam("write_ratio", 6.0,
                    "write energy vs the SRAM write, at a 1 ns pulse"),
        FamilyParam("area_ratio", 0.9, "cell area vs the SRAM cell"),
    ),
    default_axes={"delta": (40.0, 60.0),
                  "write_pulse_ns": (0.5, 1.0, 2.0)},
)
def _build_sot_mram(params):
    from repro_torch.core.devices import (SRAM, SRAM_AREA_UM2_PER_BIT,
                                          SRAM_READ_FJ_PER_BIT,
                                          SRAM_WRITE_FJ_PER_BIT, DeviceModel)
    delta = params["delta"]
    pulse = params["write_pulse_ns"]
    if delta <= 0 or pulse <= 0:
        raise ValueError(
            f"delta and write_pulse_ns must be positive, got "
            f"{(delta, pulse)}")
    retention_s = (math.inf if delta >= _SOT_DELTA_INF
                   else 1.0e-9 * math.exp(delta))
    defaults = (delta == 60.0 and pulse == 1.0
                and params["read_ratio"] == 0.35
                and params["write_ratio"] == 6.0
                and params["area_ratio"] == 0.9)
    name = "SOT-MRAM" if defaults else (
        f"SOT-MRAM[d={delta:g},p={pulse:g},r={params['read_ratio']:g},"
        f"w={params['write_ratio']:g},a={params['area_ratio']:g}]")
    dev = DeviceModel(
        name=name,
        area_um2_per_bit=params["area_ratio"] * SRAM_AREA_UM2_PER_BIT,
        read_fj_per_bit=params["read_ratio"] * SRAM_READ_FJ_PER_BIT,
        write_fj_per_bit=(params["write_ratio"] * pulse
                          * SRAM_WRITE_FJ_PER_BIT),
        retention_s=retention_s,
    )
    return (SRAM, dev)
