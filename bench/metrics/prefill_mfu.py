"""The prefills' share of the chip's bf16 peak: the yardstick's FLOPs of
every batch of the window over the batches' host seconds, against
989 TFLOP/s."""

from bench.yardstick import flops
from bench.yardstick.peaks import BF16_FLOPS_PER_S


def read(run):
    recs = [r for r in run.records if "prompt_len" in r]
    if not recs:
        return None
    m = run.cfg["model"]
    work = sum(flops.hybrid_prefill(m, r["rows"], r["prompt_len"])
               for r in recs)
    seconds = sum(r["end_s"] - r["start_s"] for r in recs)
    return 100.0 * work / seconds / BF16_FLOPS_PER_S
