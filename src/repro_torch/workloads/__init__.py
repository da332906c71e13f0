"""Unified workload registry: one spec, every backend.

A :class:`WorkloadSpec` describes a workload once and lowers itself to
each backend's native input via ``build(backend_name)``; the built-in
suites (``archs`` / ``polybench``) register on import.

Importing this package is light by contract: lowerings import backend
modules lazily inside ``build()``.
"""

from repro_torch.workloads.spec import (WorkloadSpec, available_suites,
                                        available_workloads,
                                        canonical_backend, get_workload,
                                        register_workload,
                                        resolve_workloads)
from repro_torch.workloads import suites as _suites  # noqa: F401  (registers)
from repro_torch.workloads.suites import transformer_gemms

__all__ = [
    "WorkloadSpec", "available_suites", "available_workloads",
    "canonical_backend", "get_workload", "register_workload",
    "resolve_workloads", "transformer_gemms",
]
