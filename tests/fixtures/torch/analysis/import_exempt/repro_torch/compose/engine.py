"""Covered engine module: only ever imports the torch backends lazily."""

import numpy as np

from repro_torch.compose.policies import get_policy


def evaluate(candidates, *, engine="numpy"):
    pol = get_policy("refresh-free")
    if engine == "torch":
        from repro_torch.compose import executor  # lazy: torch stays off-path
        return executor.run_batch(pol, candidates)
    return np.zeros(len(candidates))
