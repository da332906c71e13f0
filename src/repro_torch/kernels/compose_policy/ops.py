"""Host-facing entry points of the policy kernels: candidate tensors in,
finished NumPy results out.

``candidate_tensors`` turns a ``PolicyBatch``'s padded ``[C, D]`` device
matrices into the kernels' inputs on one device (padded slots are trailing
and marked by ``n_dev``, never by sentinels the kernels would read).  The
three policy entry points call the wrappers in ``kernel.py`` and finish on
the host: refresh-aware energy partials are summed row by row in a fixed
order (NumPy's reduction over each row's blocks) and scaled from fJ to J,
as the reference's executor finishes its kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.compose_policy.kernel import (policy_ra_grouped,
                                                       policy_ra_ungrouped,
                                                       policy_rf)


def candidate_tensors(ret_s, read_fj, write_fj, pad, device):
    """``(ret, read_fj, write_fj, n_dev)`` on ``device``: float64 [C, D]
    matrices as given and int32 real-device counts (pad slots trail)."""
    pad = np.asarray(pad, bool)
    n_dev = (~pad).sum(axis=1).astype(np.int32)
    if not np.array_equal(pad, np.arange(pad.shape[1])[None, :]
                          >= n_dev[:, None]):
        raise ValueError("padded device slots must trail the real ones")

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return (put(ret_s, np.float64), put(read_fj, np.float64),
            put(write_fj, np.float64), put(n_dev, np.int32))


def finish_energy(energy_part: torch.Tensor) -> np.ndarray:
    """Per-candidate energy (J) from per-block partials (fJ)."""
    return energy_part.cpu().numpy().sum(axis=1) * 1e-15


def refresh_free(cands, lt_sorted, prefix_bits, prefix_read_bits,
                 maxlt_sorted):
    """``(energy [C] J, counts [C, D] int64)`` as NumPy arrays."""
    energy, counts = policy_rf(*cands, lt_sorted, prefix_bits,
                               prefix_read_bits, maxlt_sorted)
    return energy.cpu().numpy(), counts.cpu().numpy()


def refresh_aware_grouped(cands, lt, read_bits, bits, seg, addr_bits,
                          addr_read_bits):
    """``(energy [C] J, counts [C, D] int64)`` as NumPy arrays."""
    part, counts = policy_ra_grouped(*cands, lt, read_bits, bits, seg,
                                     addr_bits, addr_read_bits)
    return finish_energy(part), counts.cpu().numpy()


def refresh_aware_ungrouped(cands, lt, read_bits, bits):
    """``(energy [C] J, picks [C, L] int8)`` as NumPy arrays."""
    part, picks = policy_ra_ungrouped(*cands, lt, read_bits, bits)
    return finish_energy(part), picks.cpu().numpy()
