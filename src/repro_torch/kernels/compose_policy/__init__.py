"""The composition engine's policy kernels (B7).

``kernel.py`` holds the wrappers of the hand-written CUDA kernels
(``csrc/compose_policy.cu``: refresh-free, refresh-aware grouped by address
with its join, refresh-aware per lifetime), their plain PyTorch versions and
the launch counts; ``ops.py`` the host-facing entry points the executor
calls.  There is no ``ref.py``: the reference's NumPy policies
(``compose/policies.py``) are the oracle.
"""

from repro_torch.kernels.compose_policy.kernel import (
    MAX_DEVICES, energy_plain, policy_ra_grouped, policy_ra_grouped_plain,
    policy_ra_ungrouped, policy_ra_ungrouped_plain, policy_rf,
    policy_rf_plain, refresh_plain)
from repro_torch.kernels.compose_policy.ops import (candidate_tensors,
                                                    finish_energy,
                                                    refresh_aware_grouped,
                                                    refresh_aware_ungrouped,
                                                    refresh_free)

__all__ = ["MAX_DEVICES", "candidate_tensors", "energy_plain",
           "finish_energy", "policy_ra_grouped", "policy_ra_grouped_plain",
           "policy_ra_ungrouped", "policy_ra_ungrouped_plain", "policy_rf",
           "policy_rf_plain", "refresh_aware_grouped",
           "refresh_aware_ungrouped", "refresh_free", "refresh_plain"]
