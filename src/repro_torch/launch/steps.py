"""Step-function assembly shared by train.py, serve.py and the
graph-walking backend's lowering.

The parameters live in the model (``api.model``), so the steps close over
it.  ``train_step(params, opt_state, batch)`` keeps the reference's
signature: ``params`` are the model's own tensors (then nothing is copied)
or a restored copy of them (then they are copied into the model first, as
after a checkpoint restore); the step updates the model, the optimizer
state and the returned ``params`` in place.

Under a mesh (``sharding.set_mesh``) the parameters are DTensors
(``api.shard_params``) and the step runs in ``sharding.context()``; each
gradient is redistributed to its parameter's placements (the FSDP
reduce-scatter) before the update.

``input_specs``, ``decode_input_specs`` and ``abstract_params`` give
shapes and dtypes (``TensorSpec``) and allocate nothing;
``cache_specs_templates`` gives a decode cache's logical templates;
``make_loss_fn`` gives the loss as a function of the parameters, the
reference's ``api.loss(params, batch)``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import BATCH
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
        with shd.context():
            return step(params, opt_state, batch)

    def step(params, opt_state, batch):
        with torch.no_grad():
            for name, p in params.items():
                if p is not live[name]:
                    live[name].copy_(p)
        loss = api.loss(batch)
        grads = dict(zip(live, torch.autograd.grad(loss,
                                                   list(live.values()))))
        for name, g in grads.items():
            p = live[name]
            if shd.is_dtensor(g) and g.placements != p.placements:
                grads[name] = g.redistribute(p.device_mesh, p.placements)
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
# Abstract shapes and shardings
# ---------------------------------------------------------------------------

def input_specs(arch: str, shape_name: str) -> dict:
    """``TensorSpec`` stand-ins for every model input of a cell; no
    allocation.  A decode cell's are its cache, token and index."""
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.models.api import build
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "decode":
        api = build(cfg, device="meta")
        (cache_s, tok_s, idx_s), _ = decode_input_specs(api, shape)
        return {"cache": cache_s, "token": tok_s, "index": idx_s}
    return batch_specs(cfg, shape)


def _tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over nested dicts, tuples and lists whose leaves
    have a ``.shape`` (tensors, ``TensorSpec``)."""
    if hasattr(tree, "shape"):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def cache_specs_templates(cfg: ArchConfig, cache_shapes,
                          shard_seq: bool = False):
    """Logical templates for a decode cache tree (nested dicts and
    tuples; leaves have ``.shape``), the reference's rule by rank
    (``sharding.cache_template``, which the caches' constructors place
    their leaves by too, all but the SSM state: ROADMAP D51).

    shard_seq: long-context decode (batch < data-axis size) shards the
    sequence dimension of attention caches instead of the batch (SP).
    """
    return _tree_map_with_path(
        lambda _, leaf: shd.cache_template(len(leaf.shape), shard_seq),
        cache_shapes)


def make_meta_cache(api: ModelApi, B: int, S: int):
    """``api``'s decode cache for batch B and sequence S, built by its
    family's constructor on the meta device.  The audio family's comes from
    its prefill's cache constructor over the encoder's meta output (the
    reference takes ``eval_shape`` of the whole prefill; the decoder pass
    it skips feeds nothing into the cache)."""
    from repro_torch.models.api import build
    cfg = api.cfg
    meta = build(cfg, device="meta") if api.device.type != "meta" else api
    if cfg.family == "audio":
        from repro_torch.models import whisper as W
        frames = torch.empty((B, cfg.enc_seq, cfg.d_model),
                             dtype=torch.bfloat16, device="meta")
        with torch.no_grad():
            enc_out = W.encode(meta.model, frames)
            cache = W.init_cache(meta.model, enc_out, B, S)
    elif cfg.family == "ssm":
        from repro_torch.models import mamba2 as M
        cache = M.init_ssm_cache(cfg, cfg.n_layers, B, "meta")
    elif cfg.family == "hybrid":
        from repro_torch.models import hybrid as H
        cache = H.init_cache(cfg, B, S, "meta")
    else:
        from repro_torch.models import transformer as T
        cache = T.init_kv_cache(cfg, B, S, "meta")
    return cache


def _cache_shapes(api: ModelApi, B: int, S: int):
    """``TensorSpec`` tree of ``make_meta_cache``."""
    return _tree_map_with_path(
        lambda _, t: TensorSpec(tuple(t.shape), t.dtype),
        make_meta_cache(api, B, S))


def decode_input_specs(api: ModelApi, shape: ShapeCell):
    """(arg shapes, arg templates) for serve_step: (cache, token,
    index).  Tokens and the index are int64 (the reference's int32)."""
    B, S = shape.global_batch, shape.seq_len
    cache_shapes = _cache_shapes(api, B, S)
    # shard sequence instead of batch when batch can't cover the data axis
    shard_seq = B == 1
    cache_tpl = cache_specs_templates(api.cfg, cache_shapes,
                                      shard_seq=shard_seq)
    token = TensorSpec((B,), torch.int64)
    index = TensorSpec((), torch.int64)
    token_tpl = (BATCH,) if not shard_seq else (None,)
    return ((cache_shapes, token, index), (cache_tpl, token_tpl, ()))


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
