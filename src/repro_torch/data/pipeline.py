"""Synthetic LM data pipeline.

Deterministic per (seed, step): a restart resumes mid-run bit-identically,
which the fault-tolerance tests rely on.  Each process generates its own
stream, keyed by its ``torch.distributed`` rank (0 when no process group is
initialised), as the reference keys it by ``jax.process_index()``.  The
tokens are the reference's bit for bit (the same numpy draws), as int64.

Sequences are Zipf-distributed token streams with injected n-gram
structure so the loss actually decreases during the example runs (pure
uniform noise has no learnable signal).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeCell


def process_index() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


@dataclasses.dataclass
class SyntheticLMDataset:
    cfg: ArchConfig
    shape: ShapeCell
    seed: int = 0

    def _rng(self, step: int) -> np.random.RandomState:
        return np.random.RandomState(
            (self.seed * 1_000_003 + step * 7919
             + process_index()) % (2 ** 31))

    def get_batch(self, step: int) -> dict:
        """{"tokens", "labels"}: int64 numpy arrays [batch, seq]."""
        rng = self._rng(step)
        B, S = self.shape.global_batch, self.shape.seq_len
        V = max(self.cfg.vocab, 4)
        # Zipf-ish marginal + deterministic bigram continuation rule:
        # token[t+1] = (7 * token[t] + 13) % V with prob 0.5
        base = rng.zipf(1.3, size=(B, S + 1)) % V
        follow = rng.rand(B, S) < 0.5
        toks = base.copy()
        cont = (7 * toks[:, :-1] + 13) % V
        toks[:, 1:] = np.where(follow, cont, toks[:, 1:])
        batch = {"tokens": toks[:, :-1].astype(np.int64),
                 "labels": toks[:, 1:].astype(np.int64)}
        if self.cfg.family == "vlm":
            batch["vision"] = rng.randn(
                B, self.cfg.vision_tokens, self.cfg.d_model
            ).astype(np.float32)
        if self.cfg.family == "audio":
            batch["frames"] = rng.randn(
                B, self.cfg.enc_seq, self.cfg.d_model).astype(np.float32)
        return batch


def to_device(batch: dict, device) -> dict:
    """Each array of ``batch`` as a tensor on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
