"""GainSight core: the paper's contribution as a composable PyTorch library.

The front door is ``repro_torch.core.api`` (see ``docs/API.md``): a ``Backend``
registry plus a ``ProfileSession`` that chains the whole paper workflow
``profile() -> analyze() -> compose() -> report()`` over any backend::

    from repro_torch.core import ProfileSession
    report = ProfileSession("systolic").run(layers, rows=128, cols=128)

Modules:

  api        - Backend protocol, @register_backend registry, ProfileSession
  trace      - canonical memory-access trace schema (any backend -> frontend)
  accumulate - TraceAccumulator: streaming/chunked lifetime analysis
  lifetime   - data-lifetime extraction (Definitions 4.1-4.3)
  devices    - bit-cell mockups: SRAM / Si-GCRAM / Hybrid-GCRAM @ N5
  frontend   - Algorithm 1: refresh / area / active-energy projection
  composer   - heterogeneous memory composition (Table 7)
  orphans    - orphaned-access / write-allocation ablation (Table 8)
  pka        - Principal Kernel Analysis kernel sampling (Table 4)
"""

from repro_torch.core.devices import (DEFAULT_DEVICES, HYBRID_GCRAM, SI_GCRAM,
                                      SRAM, DeviceModel, device_by_name)
from repro_torch.core.frontend import (analyze_trace, compute_stats,
                                       device_report, dump_report,
                                       energy_ratio_vs_sram,
                                       stats_from_lifetimes,
                                       subpartition_entry)
from repro_torch.core.lifetime import (HostLifetimes, LifetimeStats,
                                       extract_lifetimes,
                                       lifetime_histogram,
                                       lifetimes_of_trace,
                                       short_lived_fraction)
from repro_torch.core.composer import Composition, compose
from repro_torch.core.trace import Trace, chunk_trace, concat_traces, make_trace
from repro_torch.core.accumulate import (FoldedLifetimes, TraceAccumulator,
                                         folded_short_lived_fraction)
from repro_torch.core.orphans import orphaned_access_fraction, policy_ablation
from repro_torch.core.pka import PKAResult, select_kernels, weighted_estimate
from repro_torch.core.api import (Backend, ProfileResult, ProfileSession,
                                  available_backends, get_backend,
                                  register_backend, resolve_devices)

__all__ = [
    "DEFAULT_DEVICES", "HYBRID_GCRAM", "SI_GCRAM", "SRAM", "DeviceModel",
    "device_by_name", "analyze_trace", "compute_stats", "device_report",
    "dump_report", "energy_ratio_vs_sram", "stats_from_lifetimes",
    "subpartition_entry", "HostLifetimes", "LifetimeStats", "extract_lifetimes",
    "lifetime_histogram", "lifetimes_of_trace", "short_lived_fraction",
    "Composition", "compose", "Trace",
    "chunk_trace", "concat_traces", "make_trace", "FoldedLifetimes",
    "TraceAccumulator", "folded_short_lived_fraction", "Backend",
    "ProfileResult", "ProfileSession",
    "available_backends", "get_backend", "register_backend",
    "resolve_devices", "orphaned_access_fraction", "policy_ablation",
    "PKAResult", "select_kernels", "weighted_estimate",
]
