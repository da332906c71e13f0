"""Step-function assembly shared by train.py, serve.py and the
graph-walking backend's lowering.

The parameters live in the model (``api.model``), so the steps close over
it.  ``train_step(params, opt_state, batch)`` keeps the reference's
signature: ``params`` are the model's own tensors (then nothing is copied)
or a restored copy of them (then they are copied into the model first, as
after a checkpoint restore); the step updates the model, the optimizer
state and the returned ``params`` in place.

``input_specs`` and ``abstract_params`` give shapes and dtypes
(``TensorSpec``) and allocate nothing; ``make_loss_fn`` gives the loss as a
function of the parameters, the reference's ``api.loss(params, batch)``.
The logical sharding templates, the decode cache's specs and
``cache_specs_templates`` wait for the mesh (ROADMAP A11).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.api import ModelApi, TensorSpec, batch_specs
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


# ---------------------------------------------------------------------------
# Abstract shapes for the graph-walking backend
# ---------------------------------------------------------------------------

def input_specs(arch: str, shape_name: str) -> dict:
    """``TensorSpec`` stand-ins for every model input of a train or
    prefill cell; no allocation.  A decode cell's inputs include its
    cache, whose specs wait for the mesh (ROADMAP A11)."""
    from repro_torch.configs.base import SHAPES, get_config
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "decode":
        raise NotImplementedError(
            "decode input specs (the cache's) are not ported to "
            "repro_torch yet (ROADMAP A11)")
    return batch_specs(cfg, shape)


def abstract_params(api: ModelApi) -> dict:
    """``{parameter name: TensorSpec}`` of ``api``'s model; built with
    ``build(cfg, device="meta")`` the model allocates nothing."""
    return {name: TensorSpec(tuple(p.shape), p.dtype)
            for name, p in api.model.named_parameters()}


class _Loss(nn.Module):
    def __init__(self, api: ModelApi):
        super().__init__()
        self.api = api
        self.model = api.model

    def forward(self, batch):
        return self.api.loss_fn(self.model, batch)


def make_loss_fn(api: ModelApi):
    """``loss(params, batch)``: ``api.loss`` with the model's parameters
    replaced by ``params`` (name -> tensor, as ``abstract_params`` names
    them), so a graph capture sees every parameter as an input."""
    holder = _Loss(api)

    def loss(params, batch):
        return torch.func.functional_call(
            holder, {f"model.{k}": v for k, v in params.items()}, (batch,))
    return loss
