"""Violating twin: every way int32 sneaks into time/addr payloads."""

import numpy as np


class Trace:
    def __init__(self, time_cycles=None, addr=None):
        self.time_cycles = time_cycles
        self.addr = addr


class Recorder:
    def __init__(self, n):
        # int32 on an addr-ish attribute: wraps addresses >= 2**31
        self.addr_buf = np.zeros(n, dtype=np.int32)

    def finish(self, events):
        # dtype-less construction bound to a time-ish name: inferred
        time_arr = np.asarray(events)
        # raw Trace() does no coercion: literal ints infer a dtype
        t = Trace(time_cycles=[1, 2, 3], addr=np.asarray(events))
        # explicit narrowing of a cycle payload
        cycle_stamps = np.asarray(events, dtype=np.int64)
        clipped = cycle_stamps.astype(np.int32)
        return time_arr, t, clipped
