"""The torch composition engine: policy support, host finishes, and the
per-chunk entry point.

``evaluate(..., engine="torch")`` runs the whole candidate grid through
:func:`repro_torch.compose.executor.run_batch`; this module holds what that
executor shares with :func:`run_chunk`, the per-chunk form for callers that
hold one :class:`~repro_torch.compose.policies.PolicyBatch` (the reference's
``compose/jax_engine.py``).  Both call the same hand-written policy kernels
(``kernels/compose_policy``, B7): ``run_chunk`` builds a one-off trace view
and residence for its batch, the executor memoizes them per subpartition.

Numerical contract: everything runs in float64.  Capacity fractions (and
hence bank quantization) are bit-identical to the NumPy oracle: the kernels
return integer pick counts, divided here on the host, or per-lifetime
picks, reduced here with the oracle's exact masked sums.  Energy agrees
within 1e-9 relative (the sums run in another order;
``tests/test_torch_compose_engine.py``).

Unlike the reference's jax engine there is no dispatch lock and no buffer
donation: every call allocates its own outputs, and kernel launches from
several threads queue on the device's stream.
"""

from __future__ import annotations

import numpy as np

from repro_torch.compose.policies import (BankQuantizedPolicy, PolicyBatch,
                                          RefreshAwarePolicy,
                                          RefreshFreePolicy)


def _base_policy(pol):
    return pol.base if isinstance(pol, BankQuantizedPolicy) else pol


def supports(pol) -> bool:
    """Whether the torch engine has a fused kernel for this policy (the
    bank-quantized capacity post-pass runs on the host either way)."""
    return isinstance(_base_policy(pol),
                      (RefreshFreePolicy, RefreshAwarePolicy))


def _segment_ids(starts: np.ndarray, n: int) -> np.ndarray:
    """Segment id per sorted-lifetime position from segment starts."""
    seg = np.zeros(n, np.int32)
    seg[starts[1:]] = 1           # starts[0] == 0 stays segment 0
    return np.cumsum(seg, dtype=np.int32)


def _host_weighted_fracs(ff: np.ndarray, bits: np.ndarray,
                         d_max: int) -> np.ndarray:
    """Bits-weighted capacity fractions from per-lifetime picks, on the
    host — the same masked ``w[ff == i].sum()`` (same element order,
    same pairwise summation) as the NumPy oracle, so capacity stays
    bit-identical across engines.  A device-side weighted reduce can land
    an ulp past 1.0 and flip a ``ceil`` bank count at quantization
    boundaries."""
    w = bits / bits.sum()
    frac = np.zeros((ff.shape[0], d_max))
    for c in range(ff.shape[0]):
        for i in range(d_max):
            frac[c, i] = w[ff[c] == i].sum()
    return frac


def run_chunk(pol, batch: PolicyBatch, device=None):
    """Evaluate one candidate chunk on ``device`` (``None``: the CUDA
    device, raising without one); returns ``(energy_j [C],
    capacity_fractions [C, D])`` as NumPy arrays (D = padded width; the
    engine slices each candidate's real device count)."""
    from repro_torch.compose import executor
    from repro_torch.compose.engine import _view_from_arrays
    from repro_torch.device import resolve_device
    base = _base_policy(pol)
    if not supports(pol):
        raise ValueError(
            f"engine='torch' has no fused kernel for policy "
            f"{base.name!r}; use engine='numpy'")
    device = resolve_device(device)
    view = _view_from_arrays(np.asarray(batch.lt_s, np.float64),
                             np.asarray(batch.reads, np.float64),
                             np.asarray(batch.bits, np.float64),
                             batch.groups)
    return executor.evaluate_resident(
        base, batch, view, executor.TraceResidence(view, device))
