"""Deterministic synthetic data pipeline (restart-reproducible)."""

from repro_torch.data.pipeline import (SyntheticLMDataset, shard_batch,
                                       to_device)

__all__ = ["SyntheticLMDataset", "shard_batch", "to_device"]
