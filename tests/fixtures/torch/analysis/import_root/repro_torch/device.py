"""Device resolution: needs torch at import."""

import torch


def default_device():
    return torch.device("cuda")
