"""Family dispatch: one surface over the ported architectures.

  build(cfg, device, generator) -> ModelApi (the initialised model)
  api.loss(batch)               -> scalar (train objective)
  api.prefill(batch)            -> (logits, cache)
  api.decode(cache, token, index) -> (logits, cache)
  batch_specs(cfg, shape)       -> TensorSpec per batch entry
  make_batch(cfg, generator, shape) -> concrete synthetic batch
  param_templates(api)          -> logical sharding template per parameter
  batch_shardings(cfg, shape)   -> logical templates mirroring batch_specs
  shard_params(api)             -> the model's parameters onto the mesh

Every family of the reference is ported: ``dense``, ``moe`` and ``vlm``
(``transformer``), ``ssm``, ``hybrid`` and ``audio`` (``whisper``), each
with its training loss.  ``build(cfg, device="meta")`` gives parameters
with shapes and dtypes but no storage, drawing nothing: the graph-walking
backend captures a step over them (``launch/steps.py``,
``abstract_params``).  ``prefill`` takes the whole batch: the VLM's
``vision`` and Whisper's ``frames`` go in beside the tokens.
Tokens are int64, torch's index type (the reference uses int32).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
import torch.nn as nn

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import BATCH, FSDP, MODEL


class TensorSpec(NamedTuple):
    shape: tuple
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ArchConfig
    model: nn.Module
    prefill_fn: Callable
    decode_fn: Callable
    loss_fn: Callable

    @property
    def device(self) -> torch.device:
        return self.model.embed.device

    def loss(self, batch):
        with shd.context():
            return self.loss_fn(self.model, batch)

    def prefill(self, batch):
        with shd.context():
            return self.prefill_fn(self.model, batch)

    def decode(self, cache, token, index):
        with shd.context():
            return self.decode_fn(self.model, cache, token, index)

    def batch_shardings(self, shape: ShapeCell):
        return batch_shardings(self.cfg, shape)

    def make_batch(self, generator, shape: ShapeCell):
        return make_batch(self.cfg, generator, shape, device=self.device)


def build(cfg: ArchConfig, device=None, generator=None) -> ModelApi:
    """The model of ``cfg`` with random weights on ``device`` (None: the
    CUDA device, raising without one), drawn from ``generator`` (a
    ``torch.Generator`` on that device; None: one seeded with 0).  On the
    meta device nothing is drawn and ``generator`` is unused."""
    device = resolve_device(device)
    if generator is None and device.type != "meta":
        generator = torch.Generator(device=device).manual_seed(0)
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        from repro_torch.models import transformer as T
        return ModelApi(cfg, T.TransformerLM(cfg, device, generator),
                        lambda m, b: T.prefill(m, b["tokens"],
                                               b.get("vision")),
                        T.decode_step, T.loss_fn)
    if fam == "ssm":
        from repro_torch.models import mamba2 as M
        return ModelApi(cfg, M.MambaLM(cfg, device, generator),
                        lambda m, b: M.prefill(m, b["tokens"]),
                        M.decode_step, M.loss_fn)
    if fam == "hybrid":
        from repro_torch.models import hybrid as H
        return ModelApi(cfg, H.HybridLM(cfg, device, generator),
                        lambda m, b: H.prefill(m, b["tokens"]),
                        H.decode_step, H.loss_fn)
    if fam == "audio":
        from repro_torch.models import whisper as W
        return ModelApi(cfg, W.WhisperLM(cfg, device, generator),
                        lambda m, b: W.prefill(m, b["tokens"], b["frames"]),
                        W.decode_step, W.loss_fn)
    raise ValueError(f"unknown family {fam}")


# ---------------------------------------------------------------------------
# Input specs and synthetic batches
# ---------------------------------------------------------------------------

def batch_specs(cfg: ArchConfig, shape: ShapeCell):
    B, S = shape.global_batch, shape.seq_len
    i64, bf16 = torch.int64, torch.bfloat16
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": TensorSpec((B, S), i64)}
        if shape.kind == "train":
            batch["labels"] = TensorSpec((B, S), i64)
        if cfg.family == "vlm":
            batch["vision"] = TensorSpec((B, cfg.vision_tokens, cfg.d_model),
                                         bf16)
        if cfg.family == "audio":
            batch["frames"] = TensorSpec((B, cfg.enc_seq, cfg.d_model), bf16)
        return batch
    if shape.kind == "decode":
        return {"token": TensorSpec((B,), i64), "index": TensorSpec((), i64)}
    raise ValueError(shape.kind)


def make_batch(cfg: ArchConfig, generator, shape: ShapeCell, device=None):
    """Every entry of ``batch_specs`` drawn from ``generator`` (integers
    uniform in [0, vocab), floats standard normal), in spec order."""
    device = resolve_device(device)
    out = {}
    for name, spec in batch_specs(cfg, shape).items():
        if not spec.dtype.is_floating_point:
            if spec.shape == ():
                out[name] = torch.zeros((), dtype=spec.dtype, device=device)
            else:
                out[name] = torch.randint(
                    0, max(cfg.vocab, 2), spec.shape, generator=generator,
                    device=device, dtype=spec.dtype)
        else:
            out[name] = torch.randn(spec.shape, generator=generator,
                                    device=device).to(spec.dtype)
    return out


# ---------------------------------------------------------------------------
# Logical sharding templates (the reference's spec trees)
# ---------------------------------------------------------------------------

_LM = {"embed": (None, MODEL), "unembed": (None, MODEL),
       "vision_proj": (None, None), "enc_pos": (None, None),
       "dec_pos": (None, None)}
_ATTENTION = {"wq": (FSDP, MODEL), "wk": (FSDP, MODEL), "wv": (FSDP, MODEL),
              "wo": (MODEL, FSDP), "bq": (MODEL,), "bk": (MODEL,),
              "bv": (MODEL,)}
_MLP = {"w_gate": (FSDP, MODEL), "w_up": (FSDP, MODEL),
        "w_down": (MODEL, FSDP)}
_MAMBA = {"in_proj": (FSDP, MODEL), "conv_w": (None, MODEL),
          "conv_b": (MODEL,), "norm_g": (MODEL,), "out_proj": (MODEL, FSDP)}
# the expert-parallel dispatch (``moe_local_dispatch``) needs whole
# experts per rank
_MOE_LOCAL = {"router": (None, None), "we_gate": (MODEL, None, None),
              "we_up": (MODEL, None, None), "we_down": (MODEL, None, None)}
_MOE = {"router": (None, None), "we_gate": (MODEL, FSDP, None),
        "we_up": (MODEL, FSDP, None), "we_down": (MODEL, None, FSDP)}


def _module_templates(cfg: ArchConfig, module: nn.Module) -> dict:
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as M
    if isinstance(module, L.Attention):
        return _ATTENTION
    if isinstance(module, L.MLP):
        return _MLP
    if isinstance(module, L.MoE):
        return _MOE_LOCAL if cfg.moe_local_dispatch else _MOE
    if isinstance(module, M.MambaBlock):
        return _MAMBA
    return _LM


def param_templates(api: ModelApi) -> dict:
    """``{parameter name: template}`` for every parameter of ``api``'s
    model: the reference's spec tree, with a stacked group's leading layer
    axis dropped (a per-layer module holds one row of it).  A parameter
    the reference templates with None on every dim (norm gains, the SSM's
    ``A_log``/``D``/``dt_bias``) is replicated."""
    out = {}
    for mod_name, module in api.model.named_modules():
        table = _module_templates(api.cfg, module)
        for leaf, p in module.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            out[name] = table.get(leaf, (None,) * p.dim())
    return out


def shard_params(api: ModelApi) -> dict:
    """Replace every parameter of ``api``'s model by a DTensor placed by
    ``param_templates`` on the configured mesh (each rank keeps its own
    shard of the whole tensor it built from the same seed); returns the
    templates.  Without a mesh nothing changes."""
    templates = param_templates(api)
    if shd.get_mesh() is None:
        return templates
    for mod_name, module in api.model.named_modules():
        for leaf, p in list(module.named_parameters(recurse=False)):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            module._parameters[leaf] = nn.Parameter(
                shd.place(p.detach(), templates[name]),
                requires_grad=p.requires_grad)
    return templates


def batch_shardings(cfg: ArchConfig, shape: ShapeCell) -> dict:
    """Logical templates mirroring ``batch_specs``."""
    if shape.kind in ("train", "prefill"):
        out = {k: (BATCH, None) for k in ("tokens", "labels")
               if not (shape.kind == "prefill" and k == "labels")}
        if cfg.family == "vlm":
            out["vision"] = (BATCH, None, None)
        if cfg.family == "audio":
            out["frames"] = (BATCH, None, None)
        return out
    return {"token": (BATCH,), "index": ()}
