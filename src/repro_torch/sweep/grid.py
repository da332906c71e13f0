"""Design-space grid of candidate gain-cell device sets.

The paper's headline numbers are an *optimum over a design space*: the 3x
active-energy / 4x area reductions come from picking the best StRAM
composition, not from one fixed device tuple.  Gain-cell compilers
(OpenGCRAM, arXiv 2507.10849; the Gain Cell Memory Compiler line of work)
expose that space as a continuum: transistor flavor, cell sizing, and
refresh policy trade retention against area and access energy.

``DeviceGrid`` models that continuum with four axes:

  ``mixes``            parametric Si <-> Hybrid interpolation points
                       ``t in [0, 1]``; ``t=0`` is exactly ``SI_GCRAM``,
                       ``t=1`` exactly ``HYBRID_GCRAM``, interior points
                       interpolate geometrically (area / energy /
                       retention are log-linear across process flavors)
  ``retention_scales`` multiplies retention (longer-retention cells, e.g.
                       larger storage node -> pair with ``area_scales``)
  ``area_scales``      multiplies the cell area
  ``energy_scales``    multiplies read/write access energy

Each grid point is a :class:`Candidate`: SRAM plus one gain-cell device
per mix (``per_mix=False``, the default, puts *all* mixes in one device
set — the composition chooses per datum; ``per_mix=True`` emits one
candidate per single-flavor set instead).  ``include_sram_only`` adds the
degenerate all-SRAM candidate — the Pareto anchor every frontier is
normalized against.

The default grid (``DeviceGrid()`` with ``include_sram_only=False``) has
exactly one candidate whose device tuple is ``DEFAULT_DEVICES``
bit-for-bit, so a degenerate sweep reproduces ``compose()`` unchanged
(``tests/test_sweep.py`` locks this).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator, Mapping, Sequence

from repro_torch.core.devices import SRAM, DeviceModel
from repro_torch.devices.families import gain_cell_model

SRAM_ONLY_ID = "sram-only"


def gain_cell(
    mix: float,
    retention_scale: float = 1.0,
    area_scale: float = 1.0,
    energy_scale: float = 1.0,
) -> DeviceModel:
    """A parametric gain-cell device on the Si <-> Hybrid continuum.

    Compatibility wrapper over the ``gaincell`` device family's cell
    model (:func:`repro_torch.devices.families.gain_cell_model`): ``mix=0``
    with unit scales returns ``SI_GCRAM`` itself and ``mix=1`` returns
    ``HYBRID_GCRAM`` (exact objects, so degenerate grids reproduce the
    paper's fixed device set bit-for-bit).  Interior mixes interpolate
    area, access energy, and retention geometrically; the
    write-frequency knee interpolates in ``1/knee`` space (Si has no
    knee, so ``mix -> 0`` pushes the knee to infinity).
    """
    return gain_cell_model(mix, retention_scale=retention_scale,
                           area_scale=area_scale,
                           energy_scale=energy_scale)


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One design point: a device set plus the grid parameters behind it."""
    cid: str
    devices: tuple          # (SRAM, gain cells...), compose() input order
    params: dict

    def __post_init__(self):
        if not any(d.name == "SRAM" for d in self.devices):
            raise ValueError(
                f"candidate {self.cid!r} has no SRAM baseline device")


@dataclasses.dataclass(frozen=True)
class DeviceGrid:
    """Cartesian grid of candidate device sets (see module docstring)."""
    mixes: tuple = (0.0, 1.0)
    retention_scales: tuple = (1.0,)
    area_scales: tuple = (1.0,)
    energy_scales: tuple = (1.0,)
    per_mix: bool = False
    include_sram_only: bool = True

    def __post_init__(self):
        for axis in ("mixes", "retention_scales", "area_scales",
                     "energy_scales"):
            vals = tuple(float(v) for v in getattr(self, axis))
            if not vals:
                raise ValueError(f"DeviceGrid axis {axis!r} is empty")
            object.__setattr__(self, axis, vals)

    def __len__(self) -> int:
        n = (len(self.retention_scales) * len(self.area_scales)
             * len(self.energy_scales))
        if self.per_mix:
            n *= len(self.mixes)
        return n + (1 if self.include_sram_only else 0)

    def __iter__(self) -> Iterator[Candidate]:
        return iter(self.candidates())

    def candidates(self) -> tuple:
        """All candidate device sets, in deterministic grid order."""
        out = []
        if self.include_sram_only:
            out.append(Candidate(
                cid=SRAM_ONLY_ID, devices=(SRAM,),
                params={"sram_only": True}))
        scale_axes = itertools.product(
            self.retention_scales, self.area_scales, self.energy_scales)
        for r, a, e in scale_axes:
            if self.per_mix:
                for m in self.mixes:
                    out.append(self._candidate((m,), r, a, e))
            else:
                out.append(self._candidate(self.mixes, r, a, e))
        return tuple(out)

    def _candidate(self, mixes: Sequence[float], r, a, e) -> Candidate:
        gcs = tuple(gain_cell(m, r, a, e) for m in mixes)
        mix_tag = ",".join(f"{m:g}" for m in mixes)
        return Candidate(
            cid=f"m[{mix_tag}]_r{r:g}_a{a:g}_e{e:g}",
            devices=(SRAM,) + gcs,
            params={"mixes": tuple(mixes), "retention_scale": r,
                    "area_scale": a, "energy_scale": e})

    def max_devices(self) -> int:
        """Widest candidate device set in the grid — the ``D`` extent of
        the policy kernels' candidate matrices (at most
        ``kernels.compose_policy.MAX_DEVICES`` on the card); also a cheap
        sizing hint for benches."""
        return max(len(c.devices) for c in self.candidates())

    @classmethod
    def default_point(cls) -> "DeviceGrid":
        """The degenerate 1-point grid: exactly ``DEFAULT_DEVICES``."""
        return cls(include_sram_only=False)


@dataclasses.dataclass(frozen=True)
class FamilyGrid:
    """Family-backed candidate source: a registered device family swept
    over parameter axes (``axes``: param -> tuple of values, each value
    one axis point; list-valued params like the gaincell ``mixes`` take
    tuples as points).

    ``axes=None`` uses the family's registered ``default_axes``;
    ``axes={}`` pins every parameter at its default (one candidate).
    Candidates enumerate the cartesian product in the family's declared
    parameter order, so sweeps over technology x composition are
    deterministic.  Duck-types ``DeviceGrid`` for ``SweepRunner`` /
    ``ProfileSession.sweep`` / the CLI.
    """
    family: str
    axes: Mapping | None = None
    include_sram_only: bool = True

    def __post_init__(self):
        from repro_torch.devices import get_device_family
        fam = get_device_family(self.family)      # validates the name
        object.__setattr__(self, "family", fam.name)
        raw = fam.default_axes if self.axes is None else self.axes
        axes = {}
        for key in (p.name for p in fam.params):  # declaration order
            if key not in raw:
                continue
            vals = tuple(fam.param_dict[key].coerce(v)
                         for v in raw[key])
            if not vals:
                raise ValueError(f"FamilyGrid axis {key!r} is empty")
            axes[key] = vals
        unknown = sorted(set(raw) - set(axes))
        if unknown:
            raise ValueError(
                f"device family {fam.name!r} has no parameter(s) "
                f"{unknown}; available: {sorted(fam.param_dict)}")
        object.__setattr__(self, "axes", axes)

    def _family(self):
        from repro_torch.devices import get_device_family
        return get_device_family(self.family)

    def __len__(self) -> int:
        n = 1
        for vals in self.axes.values():
            n *= len(vals)
        return n + (1 if self.include_sram_only else 0)

    def __iter__(self) -> Iterator[Candidate]:
        return iter(self.candidates())

    def candidates(self) -> tuple:
        """SRAM anchor + one candidate per family-parameter point."""
        fam = self._family()
        out = []
        if self.include_sram_only:
            out.append(Candidate(
                cid=SRAM_ONLY_ID, devices=(SRAM,),
                params={"sram_only": True, "family": None}))
        keys = list(self.axes)
        for combo in itertools.product(
                *(self.axes[k] for k in keys)) if keys else [()]:
            point = dict(zip(keys, combo))
            out.append(Candidate(
                cid=self._cid(point), devices=fam.build(**point),
                params={"family": fam.name, **point}))
        return tuple(out)

    def max_devices(self) -> int:
        """Widest candidate device set in the grid (duck-typed with
        :meth:`DeviceGrid.max_devices`)."""
        return max(len(c.devices) for c in self.candidates())

    def _cid(self, point: Mapping) -> str:
        def fmt(v):
            if isinstance(v, tuple):
                return ":".join(f"{x:g}" for x in v)
            return f"{v:g}"
        tag = ",".join(f"{k}={fmt(v)}" for k, v in point.items())
        return f"{self.family}[{tag}]" if tag else f"{self.family}[]"
