"""Runtime fault tolerance: supervised training, stragglers, elasticity."""

from repro_torch.runtime.elastic import choose_mesh_shape
from repro_torch.runtime.fault_tolerance import (StepTimer, StragglerMonitor,
                                                 TrainSupervisor)

__all__ = ["StepTimer", "TrainSupervisor", "StragglerMonitor",
           "choose_mesh_shape"]
