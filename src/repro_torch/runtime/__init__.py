"""Runtime fault tolerance: supervised training, stragglers."""

from repro_torch.runtime.fault_tolerance import (StepTimer, StragglerMonitor,
                                                 TrainSupervisor)

__all__ = ["StepTimer", "TrainSupervisor", "StragglerMonitor"]
