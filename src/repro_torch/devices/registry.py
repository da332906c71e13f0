"""The device-family registry: parametric specs -> DeviceModel candidates.

The third first-class registry next to ``@register_backend`` and
``@register_workload`` (ROADMAP, "Technology axis").  A *device family*
lowers a parametric spec — cell topology, banking/periphery overheads,
process knobs — into a concrete candidate *device set* (always carrying
the SRAM anchor, since every composition is normalized against it):

    @register_device_family(
        "sot-mram",
        description="non-volatile, asymmetric read/write",
        params=(FamilyParam("delta", 60.0, "thermal stability"),),
    )
    def _build(params):
        from repro_torch.core.devices import SRAM, DeviceModel
        ...
        return (SRAM, DeviceModel(...))

Contract (mirrors the workload registry):

  * names and aliases are unique across one shared lookup namespace;
  * a factory takes exactly one required positional — ``factory(params)``
    with ``params`` the fully-resolved ``{name: value}`` dict;
  * this package is **stdlib-only at import** (an import-purity
    contract): factories lazy-import ``repro_torch.core.devices`` so
    ``python -m repro_torch devices`` never loads numpy or torch.

``DeviceFamily.content(overrides)`` is the family's cache identity —
name, version, and the fully-resolved params as one JSON-able dict.
Campaigns fold it into the trace-cache key, so any change to a family's
parametrization that shifts built devices must bump the family
``version`` (same discipline as ``SCHEMA_VERSION``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class FamilyParam:
    """One declared family parameter.

    ``kind`` drives CLI coercion: ``"float"`` parses one float,
    ``"floats"`` parses a ``:``-separated float tuple (so a list-valued
    parameter like the gain-cell ``mixes`` still fits the
    ``--family-param k=v1,v2`` axis grammar, where ``,`` separates axis
    points).
    """
    name: str
    default: object
    doc: str = ""
    kind: str = "float"          # "float" | "floats"

    def coerce(self, value):
        """One axis point for this parameter, from a CLI string or an
        already-typed value."""
        if self.kind == "floats":
            if isinstance(value, str):
                parts = [p for p in value.split(":") if p.strip()]
                return tuple(float(p) for p in parts)
            if isinstance(value, (int, float)):
                return (float(value),)
            return tuple(float(v) for v in value)
        return float(value)


@dataclasses.dataclass(frozen=True)
class DeviceFamily:
    """One registered family: a factory plus its parameter schema."""
    name: str
    factory: Callable            # factory(params: dict) -> tuple[DeviceModel]
    description: str = ""
    params: tuple = ()           # FamilyParam, declaration order
    aliases: tuple = ()
    version: int = 1
    default_axes: Mapping = dataclasses.field(default_factory=dict)
                                 # param -> axis values (sweep/CLI default)

    @property
    def param_dict(self) -> dict:
        return {p.name: p for p in self.params}

    def defaults(self) -> dict:
        return {p.name: p.default for p in self.params}

    def resolve_params(self, overrides: Mapping | None = None) -> dict:
        """Defaults merged with ``overrides`` (coerced), rejecting
        unknown parameter names."""
        schema = self.param_dict
        out = self.defaults()
        for k, v in (overrides or {}).items():
            if k not in schema:
                raise ValueError(
                    f"device family {self.name!r} has no parameter "
                    f"{k!r}; available: {sorted(schema)}")
            out[k] = schema[k].coerce(v)
        return out

    def build(self, **overrides) -> tuple:
        """Lower the spec into a concrete device set (SRAM anchor
        included).  Validates params; the factory lazy-imports
        ``repro_torch.core.devices``."""
        devices = tuple(self.factory(self.resolve_params(overrides)))
        if not any(d.name == "SRAM" for d in devices):
            raise ValueError(
                f"device family {self.name!r} built a set without the "
                "SRAM anchor device")
        return devices

    def content(self, overrides: Mapping | None = None) -> dict:
        """JSON-able cache identity: family, version, resolved params."""
        params = {k: (list(v) if isinstance(v, tuple) else v)
                  for k, v in self.resolve_params(overrides).items()}
        return {"name": self.name, "version": self.version,
                "params": params}

    def describe(self) -> str:
        alias = f" ({', '.join(self.aliases)})" if self.aliases else ""
        keys = ",".join(p.name for p in self.params) or "-"
        return f"{self.name:22s} v{self.version}{alias:24s} params={keys}"


_FAMILIES: dict = {}
_ALIASES: dict = {}


def register_device_family(name: str, *, description: str = "",
                           params: Sequence = (),
                           aliases: Sequence[str] = (),
                           version: int = 1,
                           default_axes: Mapping | None = None):
    """Class/function decorator registering ``factory(params)`` as a
    device family.  Duplicate names or alias collisions raise at
    registration."""
    def deco(factory):
        if name in _FAMILIES or name in _ALIASES:
            raise ValueError(
                f"device family {name!r} is already registered")
        fam = DeviceFamily(
            name=name, factory=factory, description=description,
            params=tuple(params), aliases=tuple(aliases),
            version=int(version), default_axes=dict(default_axes or {}))
        for alias in fam.aliases:
            if alias in _FAMILIES or alias in _ALIASES:
                raise ValueError(
                    f"device-family alias {alias!r} collides with an "
                    "existing family name or alias")
        _FAMILIES[name] = fam
        for alias in fam.aliases:
            _ALIASES[alias] = name
        return factory
    return deco


def get_device_family(name: str) -> DeviceFamily:
    """Family by name or alias; raises ``ValueError`` with the full
    list when unknown (mirrors ``get_workload``)."""
    key = _ALIASES.get(name, name)
    if key not in _FAMILIES:
        known = sorted(set(_FAMILIES) | set(_ALIASES))
        raise ValueError(
            f"unknown device family {name!r}; registered: {known}")
    return _FAMILIES[key]


def available_device_families() -> list:
    """Sorted canonical family names."""
    return sorted(_FAMILIES)


def parse_family_params(specs: Sequence[str],
                        family: DeviceFamily) -> dict:
    """CLI ``--family-param k=v1,v2`` strings -> ``{param: (axis
    values...)}``, coerced against the family's schema.  ``,``
    separates axis points; ``:`` separates floats inside one
    list-valued point (``kind="floats"`` params)."""
    axes: dict = {}
    for spec in specs or ():
        if "=" not in spec:
            raise ValueError(
                f"--family-param needs k=v1[,v2,...], got {spec!r}")
        key, _, vals = spec.partition("=")
        key = key.strip()
        param = family.param_dict.get(key)
        if param is None:
            raise ValueError(
                f"device family {family.name!r} has no parameter "
                f"{key!r}; available: {sorted(family.param_dict)}")
        points = [p for p in vals.split(",") if p.strip()]
        if not points:
            raise ValueError(f"--family-param {key}= has no values")
        axes[key] = tuple(param.coerce(p) for p in points)
    return axes
