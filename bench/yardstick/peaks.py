"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at 700 W).

The same constants as ``chip_smoke.py``'s bound arithmetic, frozen here
with the benchmark."""

BF16_FLOPS_PER_S = 989e12        # tensor cores, bf16 / fp16
HBM_BYTES_PER_S = 3.35e12
# float32 outside the tensor cores peaks at 67 TFLOP/s counting a fused
# multiply-add as two; taken as 33.5e12 instructions/s for integer work
INT_OPS_PER_S = 33.5e12
FP64_FLOPS_PER_S = 34e12         # fp64 outside the tensor cores


def bound_s(n_bytes: float, n_ops: float, ops_per_s: float) -> float:
    """The least time the chip could take: the larger of the bytes over
    the memory's rate and the operations over the compute peak."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s)
