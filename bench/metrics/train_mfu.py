"""The training steps' share of the chip's bf16 peak: the yardstick's
FLOPs of every step of the window (three times the forward, no
recomputation counted) over the window's seconds, against 989 TFLOP/s."""

from bench.yardstick import flops
from bench.yardstick.peaks import BF16_FLOPS_PER_S


def read(run):
    recs = [r for r in run.records if "step" in r]
    if not recs or not run.window_s:
        return None
    t = run.traffic
    work = len(recs) * flops.moe_train_step(run.cfg["model"], int(t["batch"]),
                                            int(t["seq"]))
    return 100.0 * work / run.window_s / BF16_FLOPS_PER_S
