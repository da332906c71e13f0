"""K2 (flash-attention forward) against its roofline over the traced
steps of a training cell: the bound of every launch (the forward and,
under remat, its recomputation) over K2's device seconds."""

from bench.harness import kernel_seconds
from bench.yardstick import kernels
from bench.yardstick.peaks import bound_s


def read(run):
    device = kernel_seconds(run, kernels.K2_KERNELS)
    c = run.counts
    if device is None or not c.get("k2_calls"):
        return None
    m = run.cfg["model"]
    H, KV = m["n_heads"], m["kv_heads"]
    hd = m.get("head_dim") or m["d_model"] // H
    per_call = bound_s(*kernels.k2(c["batch"], H, KV, c["seq"], c["seq"], hd))
    return 100.0 * c["k2_calls"] * per_call / device
