"""Second exempt backend: imports torch directly and via torch_engine."""

import torch

from repro_torch.compose.torch_engine import run_chunk


def run_batch(pol, batch):
    return torch.as_tensor(run_chunk(pol, batch))
