"""K3 + K4 (flash-attention backward, dq and dk/dv passes) against their
roofline over the traced steps: both passes' bounds over both kernels'
device seconds."""

from bench.harness import kernel_seconds
from bench.yardstick import kernels
from bench.yardstick.peaks import bound_s


def read(run):
    device = kernel_seconds(run, kernels.K34_KERNELS)
    c = run.counts
    if device is None or not c.get("k3_calls"):
        return None
    m = run.cfg["model"]
    H, KV = m["n_heads"], m["kv_heads"]
    hd = m.get("head_dim") or m["d_model"] // H
    shape = (c["batch"], H, KV, c["seq"], hd)
    bound = c["k3_calls"] * bound_s(*kernels.k3(*shape)) \
        + c["k4_calls"] * bound_s(*kernels.k4(*shape))
    return 100.0 * bound / device
