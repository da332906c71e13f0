"""Family dispatch: one surface over the ported architectures.

  build(cfg, device, generator) -> ModelApi (the initialised model)
  api.prefill(batch)            -> (logits, cache)
  api.decode(cache, token, index) -> (logits, cache)
  batch_specs(cfg, shape)       -> TensorSpec per batch entry
  make_batch(cfg, generator, shape) -> concrete synthetic batch

Families ``ssm`` and ``hybrid`` are ported; the others (dense, MoE, VLM,
audio) raise ``NotImplementedError`` (ROADMAP A9), and so does training,
which has no entry here yet.  Tokens are int64, torch's index type (the
reference uses int32).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
import torch.nn as nn

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.device import resolve_device


class TensorSpec(NamedTuple):
    shape: tuple
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ArchConfig
    model: nn.Module
    prefill_fn: Callable
    decode_fn: Callable

    @property
    def device(self) -> torch.device:
        return self.model.embed.device

    def prefill(self, batch):
        return self.prefill_fn(self.model, batch["tokens"])

    def decode(self, cache, token, index):
        return self.decode_fn(self.model, cache, token, index)

    def make_batch(self, generator, shape: ShapeCell):
        return make_batch(self.cfg, generator, shape, device=self.device)


def build(cfg: ArchConfig, device=None, generator=None) -> ModelApi:
    """The model of ``cfg`` with random weights on ``device`` (None: the
    CUDA device, raising without one), drawn from ``generator`` (a
    ``torch.Generator`` on that device; None: one seeded with 0)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    fam = cfg.family
    if fam == "ssm":
        from repro_torch.models import mamba2 as M
        return ModelApi(cfg, M.MambaLM(cfg, device, generator), M.prefill,
                        M.decode_step)
    if fam == "hybrid":
        from repro_torch.models import hybrid as H
        return ModelApi(cfg, H.HybridLM(cfg, device, generator), H.prefill,
                        H.decode_step)
    if fam in ("dense", "moe", "vlm", "audio"):
        raise NotImplementedError(
            f"family {fam!r} is not ported to repro_torch yet (ROADMAP A9)")
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
