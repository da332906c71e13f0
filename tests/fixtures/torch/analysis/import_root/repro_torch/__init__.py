"""A package root that imports torch at module level: every module of the
package runs it first on import."""

from repro_torch.device import default_device

__all__ = ["default_device"]
