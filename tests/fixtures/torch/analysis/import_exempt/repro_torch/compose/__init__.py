"""Mirrors repro_torch.compose: torch-free at import, engine attributes lazy."""

from repro_torch.compose.policies import get_policy

__all__ = ["get_policy", "evaluate"]


def __getattr__(name):
    if name == "evaluate":
        from repro_torch.compose import engine
        return engine.evaluate
    raise AttributeError(name)
