"""Device resolution for every entry point of the package.

The analysis path runs on the CUDA device.  ``None`` resolves to it and
raises where there is none; the CPU is used only when a caller names it
(``device="cpu"``), never because no GPU was found.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The CUDA device; ``RuntimeError`` when CUDA is unavailable."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' explicitly to run on the host")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``None`` -> :func:`default_device`; anything else -> ``torch.device``."""
    if device is None:
        return default_device()
    return torch.device(device)
