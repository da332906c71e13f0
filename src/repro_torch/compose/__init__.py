"""Policy-driven composition engine: datum→device assignment end-to-end.

The paper's headline claim is *optimal* StRAM compositions; this package
owns the assignment that produces them, as one natively batched engine
behind an :class:`AssignmentPolicy` abstraction:

  policies  - ``refresh-free`` (seed ``compose()`` semantics, locked
              bit-for-bit), ``refresh-aware`` (minimum total energy with
              refresh billed per Algorithm 1), ``bank-quantized``
              (power-of-two bank capacity snapping atop either), plus
              ``get_policy`` spec parsing
  engine    - ``evaluate``: one policy kernel over a single device set
              *or* a whole grid of candidates via the fused torch
              executor (``engine="torch"``, the default) or the NumPy
              broadcast oracle (``engine="numpy"``); ``compose``
              (single-candidate wrapper); ``composition_csv_rows``;
              ``sorted_trace_view``
  executor  - ``run_batch``: the whole grid through the hand-written
              policy kernels against device-resident trace arrays
  torch_engine - ``run_chunk``: the same kernels for one ``PolicyBatch``
  types     - the ``Composition`` result schema

``repro_torch.core.composer.compose()`` and ``repro_torch.sweep.SweepRunner`` are
thin callers of this engine.  Importing ``repro_torch.compose`` stays light
(numpy + stdlib); the engine module — which pulls in the torch-backed
analysis stack — loads lazily on first attribute access, so policy specs
can be resolved without it.
"""

from repro_torch.compose.policies import (AddressGroups, AssignmentPolicy,
                                          BankQuantizedPolicy,
                                          PolicyAssignment, PolicyBatch,
                                          RefreshAwarePolicy,
                                          RefreshFreePolicy,
                                          available_policies, get_policy)
from repro_torch.compose.types import Composition

_ENGINE_EXPORTS = ("evaluate", "compose", "composition_csv_rows",
                   "address_groups", "sorted_trace_view", "ENGINES")

__all__ = [
    "AddressGroups", "AssignmentPolicy", "BankQuantizedPolicy",
    "PolicyAssignment", "PolicyBatch", "RefreshAwarePolicy",
    "RefreshFreePolicy", "available_policies", "get_policy",
    "Composition", *_ENGINE_EXPORTS,
]


def __getattr__(name):
    if name in _ENGINE_EXPORTS:
        from repro_torch.compose import engine
        return getattr(engine, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
