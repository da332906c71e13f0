"""How the benchmark hands its inputs to the program: the model of a
configuration built by the program without storage, its parameters then
taken from the weights the benchmark drew (``reference/weights.py``).
"""

from __future__ import annotations

import importlib

import torch


def reference_module(cfg: dict):
    """``reference/<cfg["reference"]>.py``: the configuration's plain
    reference, which also lists its parameters (``specs``)."""
    return importlib.import_module(f"bench.reference.{cfg['reference']}")


def program_config(cfg: dict):
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(**cfg["model"])


def load_program(cfg: dict, weights: dict, device, trainable=False):
    """The program's ``ModelApi`` for ``cfg`` with ``weights`` as its
    parameters (names, shapes and dtypes checked against the program's)."""
    from repro_torch.models.api import build
    api = build(program_config(cfg), device="meta")
    named = dict(api.model.named_parameters())
    if set(named) != set(weights):
        raise ValueError(f"weights do not match the program's parameters: "
                         f"missing {sorted(set(named) - set(weights))[:5]}, "
                         f"extra {sorted(set(weights) - set(named))[:5]}")
    for mod_name, module in api.model.named_modules():
        for leaf, p in list(module.named_parameters(recurse=False)):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            w = weights[name]
            if w.shape != p.shape or w.dtype != p.dtype:
                raise ValueError(f"{name}: {tuple(w.shape)} {w.dtype} "
                                 f"against {tuple(p.shape)} {p.dtype}")
            module._parameters[leaf] = torch.nn.Parameter(
                w.to(device), requires_grad=trainable)
    return api
