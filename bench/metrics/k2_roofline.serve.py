"""K2 (flash-attention forward) against its roofline over the traced
sub-window of a serving cell: the bound of every call (each attention
application of each traced prefill) over K2's device seconds."""

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
    per_prefill = c["k2_calls"] / len(c["traced_lengths"])
    bound = sum(per_prefill * bound_s(*kernels.k2(
        c["traced_rows"], H, KV, length, length, hd, True))
        for length in c["traced_lengths"])
    return 100.0 * bound / device
