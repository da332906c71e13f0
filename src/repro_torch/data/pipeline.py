"""Synthetic LM data pipeline.

Deterministic per (seed, step): a restart resumes mid-run bit-identically,
which the fault-tolerance tests rely on.  Each host generates its own
stream, keyed by its node index (``process_index``: 0 on one host), as the
reference keys it by ``jax.process_index()``, the index of the host and
not of a device; every rank of a host builds the same global batch and
``shard_batch`` takes its shard of it.  The tokens are the reference's bit
for bit (the same numpy draws), as int64.

Sequences are Zipf-distributed token streams with injected n-gram
structure so the loss actually decreases during the example runs (pure
uniform noise has no learnable signal).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeCell


def process_index() -> int:
    """The index of this process's node: ``rank // local_world_size``
    (``LOCAL_WORLD_SIZE`` as ``torchrun`` sets it, else the whole world on
    one host), 0 without a process group.  A torch rank is one device; the
    reference's ``jax.process_index()`` is one host."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    local = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
    return dist.get_rank() // local


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


def shard_batch(batch: dict, shardings: dict | None, device) -> dict:
    """Each array of the global ``batch`` as a tensor on ``device``, placed
    by its logical template in ``shardings`` on the configured mesh: each
    rank keeps its own shard (every rank of a host holds the same batch).
    Without a mesh or templates, ``to_device``."""
    from repro_torch.distributed import sharding as shd
    out = to_device(batch, device)
    if shardings is None or shd.get_mesh() is None:
        return out
    return {k: shd.place(v, shardings[k]) if k in shardings else v
            for k, v in out.items()}
