"""The composition engine's policy kernels (B7).

``kernel.py`` holds the wrappers of the hand-written CUDA kernels
(``csrc/compose_policy.cu``: refresh-free; refresh-aware as a retention
pass over the batch's distinct retentions with its join, a candidate pass
grouped or per lifetime, and the decision per address), their plain
PyTorch versions and the launch counts; ``ops.py`` the retention index and
the host-facing entry points the executor calls.  There is no ``ref.py``:
the reference's NumPy policies (``compose/policies.py``) are the oracle.
"""

from repro_torch.kernels.compose_policy.kernel import (
    KERNELS, MAX_DEVICES, MAX_RETENTIONS, PLAIN, energy_plain, floor_plain,
    policy_ra_decide, policy_ra_decide_plain, policy_ra_grouped,
    policy_ra_grouped_plain, policy_ra_ungrouped, policy_ra_ungrouped_plain,
    policy_retention, policy_retention_plain, policy_rf, policy_rf_plain,
    refresh_plain)
from repro_torch.kernels.compose_policy.ops import (candidate_tensors,
                                                    finish_energy,
                                                    finish_floor,
                                                    floor_refresh_bits,
                                                    refresh_aware_grouped,
                                                    refresh_aware_ungrouped,
                                                    refresh_free,
                                                    retention_groups,
                                                    retention_index)

__all__ = ["KERNELS", "MAX_DEVICES", "MAX_RETENTIONS", "PLAIN",
           "candidate_tensors", "energy_plain", "finish_energy",
           "finish_floor", "floor_plain", "floor_refresh_bits",
           "policy_ra_decide", "policy_ra_decide_plain", "policy_ra_grouped",
           "policy_ra_grouped_plain", "policy_ra_ungrouped",
           "policy_ra_ungrouped_plain", "policy_retention",
           "policy_retention_plain", "policy_rf", "policy_rf_plain",
           "refresh_aware_grouped", "refresh_aware_ungrouped",
           "refresh_free", "refresh_plain", "retention_groups",
           "retention_index"]
