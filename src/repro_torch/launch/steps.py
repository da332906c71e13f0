"""Step-function assembly shared by train.py and serve.py.

The parameters live in the model (``api.model``), so the steps close over
it.  ``train_step(params, opt_state, batch)`` keeps the reference's
signature: ``params`` are the model's own tensors (then nothing is copied)
or a restored copy of them (then they are copied into the model first, as
after a checkpoint restore); the step updates the model, the optimizer
state and the returned ``params`` in place.  The dry-run's abstract-shape
helpers wait for the graph-walking backend (ROADMAP A10).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.api import ModelApi
from repro_torch.optim import AdamW, compress_gradients, cosine_schedule


def make_optimizer(cfg: ArchConfig, total_steps: int = 10000) -> AdamW:
    warmup = max(1, min(200, total_steps // 10))
    return AdamW(lr=cosine_schedule(3e-4, warmup, total_steps))


def make_train_step(api: ModelApi, optimizer: AdamW,
                    compress_grads: bool = False):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"})``: the loss, its gradient with respect to
    every parameter, optional int8 compression with error feedback
    (``opt_state["grad_err"]``), then one AdamW update."""
    live = dict(api.model.named_parameters())

    def train_step(params, opt_state, batch):
        with torch.no_grad():
            for name, p in params.items():
                if p is not live[name]:
                    live[name].copy_(p)
        loss = api.loss(batch)
        grads = dict(zip(live, torch.autograd.grad(loss,
                                                   list(live.values()))))
        if compress_grads:
            grads, err = compress_gradients(grads, opt_state.get("grad_err"))
        params, opt_state, metrics = optimizer.update(grads, opt_state, live)
        if compress_grads:
            opt_state["grad_err"] = err
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics
    return train_step


def make_prefill_step(api: ModelApi):
    def prefill_step(batch):
        return api.prefill(batch)
    return prefill_step


def make_serve_step(api: ModelApi):
    def serve_step(cache, token, index):
        return api.decode(cache, token, index)
    return serve_step
