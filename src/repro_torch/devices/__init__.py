"""Device-family registry: ``@register_device_family`` + built-ins.

The technology axis as a first-class registry (see ``docs/API.md``,
"Device families"): a family lowers a parametric spec into a concrete
``DeviceModel`` candidate set, and sweeps/campaigns enumerate family
parameters as axes next to the composition axes.

Built-in families (``python -m repro_torch devices`` lists schemas):

  sram        the all-SRAM anchor
  gaincell    OpenGCRAM-style parametric Si<->Hybrid gain cells
              (aliases: opengcram, sram-gaincell-default — the latter
              rebuilds ``DEFAULT_DEVICES`` object-for-object)
  sot-mram    non-volatile, strongly asymmetric read vs. write energy

Stdlib-only at import: family factories lazy-import ``repro_torch.core.devices``.
"""

from repro_torch.devices.registry import (DeviceFamily, FamilyParam,
                                          available_device_families,
                                          get_device_family,
                                          parse_family_params,
                                          register_device_family)
from repro_torch.devices import families as _families  # register built-ins
from repro_torch.devices.families import gain_cell_model

_ = _families

__all__ = [
    "DeviceFamily", "FamilyParam", "available_device_families",
    "get_device_family", "parse_family_params", "register_device_family",
    "gain_cell_model",
]
