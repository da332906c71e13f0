"""K5 (SSD scan) against its roofline over the traced sub-window: the
bound of every call (each Mamba-2 block of each traced prefill) over the
device seconds of K5's three kernels."""

from bench.harness import kernel_seconds
from bench.yardstick import kernels
from bench.yardstick.peaks import bound_s


def read(run):
    device = kernel_seconds(run, kernels.K5_KERNELS)
    c = run.counts
    if device is None or not c.get("k5_calls"):
        return None
    m = run.cfg["model"]
    d_in = m["ssm_expand"] * m["d_model"]
    nh, p = d_in // m["ssm_head_dim"], m["ssm_head_dim"]
    per_prefill = c["k5_calls"] / len(c["traced_lengths"])
    bound = sum(per_prefill * bound_s(*kernels.k5(
        c["traced_rows"], length, nh, p, m["ssm_state"],
        m.get("ssm_chunk", 256))) for length in c["traced_lengths"])
    return 100.0 * bound / device
