"""GainSight in PyTorch/CUDA: data-lifetime profiling and heterogeneous
on-chip memory composition.

A second package beside ``repro`` with the same subpackage names, so a
reader finds each module's counterpart.  Traces are built with numpy on the
host; lifetime extraction and the ``lifetime_scan`` kernel run on the CUDA
device; Algorithm 1 and the composition engine consume the result on the
host.  Front door::

    from repro_torch.core import ProfileSession
    report = ProfileSession("systolic").run(layers, rows=128, cols=128)

Every entry point takes ``device=``; ``None`` means the CUDA device and
raises when there is none (see :mod:`repro_torch.device`).

The package root imports nothing, so the planning modules (``workloads``,
``devices``, ``cluster``, ``analysis``, ``launch.campaign``, ``__main__``)
import without torch; ``default_device`` and ``resolve_device`` load
:mod:`repro_torch.device` on first use.
"""

__all__ = ["default_device", "resolve_device"]


def __getattr__(name):
    if name in __all__:
        from repro_torch import device
        return getattr(device, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
