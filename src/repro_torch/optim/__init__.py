"""Optimizer substrate: AdamW (fp32 master + moments), LR schedules,
int8 gradient compression with error feedback."""

from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.optim.compression import (compress_gradients,
                                           compressed_psum)

__all__ = ["AdamW", "cosine_schedule", "compress_gradients",
           "compressed_psum"]
