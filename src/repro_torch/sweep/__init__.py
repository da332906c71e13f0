"""Composition design-space sweep: grid x subpartitions -> Pareto curve.

The paper's headline claim ("optimal StRAM memory compositions achieving
up to 3x active energy and 4x area reductions") is an optimum over a
device design space.  This package explores that space:

  grid     - ``DeviceGrid``: candidate device sets from retention / area /
             energy scaling axes + parametric Si<->Hybrid interpolation;
             ``FamilyGrid``: a registered device family (``repro_torch.devices``)
             swept over its parameter axes (technology x composition)
  runner   - ``SweepRunner``: the shared ``repro_torch.compose`` engine over
             grid x subpartitions x cache geometries (one batched policy
             kernel per subpartition, ``policy=`` selectable,
             thread-parallel outer loop;
             ``engine="torch"`` runs the policy kernels on the card)
  pareto   - ``ParetoFrontier``: dominated-free (area, energy) curves
             with the all-SRAM anchor

Front doors: ``ProfileSession.sweep(...)`` and ``python -m repro_torch sweep``.
"""

from repro_torch.sweep.grid import (SRAM_ONLY_ID, Candidate, DeviceGrid,
                              FamilyGrid, gain_cell)
from repro_torch.sweep.pareto import ParetoFrontier, dominates, pareto_frontier
from repro_torch.sweep.runner import (SweepPoint, SweepResult, SweepRunner,
                                evaluate_candidates)

__all__ = [
    "SRAM_ONLY_ID", "Candidate", "DeviceGrid", "FamilyGrid", "gain_cell",
    "ParetoFrontier", "dominates", "pareto_frontier",
    "SweepPoint", "SweepResult", "SweepRunner", "evaluate_candidates",
]
