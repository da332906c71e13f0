"""Deterministic synthetic data pipeline (restart-reproducible)."""

from repro_torch.data.pipeline import SyntheticLMDataset, to_device

__all__ = ["SyntheticLMDataset", "to_device"]
