"""Carry state between the reference package and this one.

There are no weights; the state both packages must agree on is the trace
and the device models.  These functions take plain arrays and dicts (the
fields of a reference ``Trace``, ``dataclasses.asdict`` of a reference
``DeviceModel``) and import nothing of the reference package, so a test
can feed both packages the same inputs.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.devices import DeviceModel
from repro_torch.core.lifetime import LifetimeStats
from repro_torch.core.trace import Trace, make_trace


def trace_from_arrays(time_cycles, addr, is_write, hit=None,
                      subpartition=None, names=("mem",),
                      clock_hz: float = 1.0e9,
                      block_bits: int = 1024) -> Trace:
    """This package's ``Trace`` from the fields of any trace, as arrays."""
    return make_trace(
        np.asarray(time_cycles), np.asarray(addr), np.asarray(is_write),
        hit=None if hit is None else np.asarray(hit),
        subpartition=None if subpartition is None
        else np.asarray(subpartition),
        clock_hz=float(clock_hz), block_bits=int(block_bits),
        names=tuple(names))


def device_from_fields(fields: dict) -> DeviceModel:
    """This package's ``DeviceModel`` from ``dataclasses.asdict`` of one."""
    return DeviceModel(**fields)


def lifetime_stats_to_numpy(stats: LifetimeStats) -> dict:
    """Every field of a ``LifetimeStats`` (padded to ``n_events``, as the
    reference lays them out) as numpy arrays on the host."""
    return {name: getattr(stats, name).cpu().numpy()
            for name in ("lifetime_cycles", "n_reads", "start_cycles",
                         "addr", "valid", "orphan", "seg_id_per_event")}
