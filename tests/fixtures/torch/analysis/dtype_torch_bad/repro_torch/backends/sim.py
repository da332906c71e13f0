"""Violating twin: every way torch narrows time/addr payloads."""

import torch


def record(events, n):
    # constructors without a dtype: float32 or the source's dtype
    addr_t = torch.tensor(events)
    time_t = torch.as_tensor(events)
    addr_a = torch.asarray(events)
    time_z = torch.zeros(n)
    addr_o = torch.ones(n)
    time_e = torch.empty(n)
    addr_f = torch.full((n,), -1)
    time_r = torch.arange(n)
    # an explicit int32 dtype on an addr-ish name
    addr_32 = torch.zeros(n, dtype=torch.int32)
    return (addr_t, time_t, addr_a, time_z, addr_o, time_e, addr_f, time_r,
            addr_32)


def narrow(time_cycles, addr_lines, cycle_stamps, line_ids):
    # the four int32 narrowings
    a = time_cycles.to(torch.int32)
    b = addr_lines.to(dtype=torch.int32)
    c = cycle_stamps.int()
    d = line_ids.type(torch.int32)
    return a, b, c, d
