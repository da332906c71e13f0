"""Clean twin: explicit int64 everywhere, int32 only off-payload."""

import numpy as np


class Recorder:
    def __init__(self, n):
        self.addr_buf = np.zeros(n, dtype=np.int64)
        # int32 is fine on non-time/addr names (subpartition schema)
        self.subpartition = np.zeros(n, dtype=np.int32)

    def finish(self, events):
        time_arr = np.asarray(events, dtype=np.int64)
        # dtype-preserving re-wrap of an already-typed field: exempt
        view = np.asarray(self.addr_buf)[: len(events)]
        return time_arr, view
