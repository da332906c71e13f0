"""Clean twin: explicit int64 everywhere, int32 only off-payload."""

import numpy as np
import torch


def record(events, n, device):
    addr_t = torch.tensor(events, dtype=torch.int64)
    time_z = torch.zeros(n, dtype=torch.int64, device=device)
    time_r = torch.arange(n, device=device, dtype=torch.int64)
    # int32 is fine on non-time/addr names (subpartition schema)
    subpartition = torch.zeros(n, dtype=torch.int32)
    # from_numpy and *_like inherit their input's dtype: exempt
    addr_n = torch.from_numpy(np.asarray(events, dtype=np.int64))
    time_l = torch.zeros_like(time_r)
    return addr_t, time_z, subpartition, addr_n, time_l


def widen(time_cycles, addr_lines, counts):
    a = time_cycles.to(torch.int64)
    b = addr_lines.to(device="cpu", dtype=torch.int64)
    # .int() and .to(int32) off time/addr names are fine
    c = counts.int()
    d = counts.to(torch.int32)
    return a, b, c, d
