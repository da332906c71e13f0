"""Host-facing entry points of the policy kernels: candidate tensors in,
finished NumPy results out.

``candidate_tensors`` turns a ``PolicyBatch``'s padded ``[C, D]`` device
matrices into the kernels' inputs on one device (padded slots are trailing
and marked by ``n_dev``, never by sentinels the kernels would read), and
``retention_index`` finds the batch's distinct finite retentions by their
float64 bit pattern: the refresh-aware kernels do their refresh work once
per distinct retention, not per (candidate, device slot).  The policy entry
points call the wrappers in ``kernel.py`` and finish on the host:
energy and floor partials are summed row by row in a fixed order (NumPy's
reduction over each row's blocks) and energy scaled from fJ to J, as the
reference's executor finishes its kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.compose_policy.kernel import (MAX_RETENTIONS,
                                                       policy_ra_decide,
                                                       policy_ra_grouped,
                                                       policy_ra_ungrouped,
                                                       policy_retention,
                                                       policy_rf)


def _put(a, dtype, device):
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)


def candidate_tensors(ret_s, read_fj, write_fj, pad, device):
    """``(ret, read_fj, write_fj, n_dev)`` on ``device``: float64 [C, D]
    matrices as given and int32 real-device counts (pad slots trail)."""
    pad = np.asarray(pad, bool)
    n_dev = (~pad).sum(axis=1).astype(np.int32)
    if not np.array_equal(pad, np.arange(pad.shape[1])[None, :]
                          >= n_dev[:, None]):
        raise ValueError("padded device slots must trail the real ones")
    return (_put(ret_s, np.float64, device), _put(read_fj, np.float64, device),
            _put(write_fj, np.float64, device), _put(n_dev, np.int32, device))


def retention_index(ret_s, pad):
    """``(ret_u [R] float64, ridx [C, D] int32)``: the distinct finite
    retentions of the real slots, by bit pattern (ascending), and each
    slot's row; -1 for an infinite retention (SRAM refreshes nothing) and
    for every padded slot."""
    ret = np.ascontiguousarray(ret_s, np.float64)
    real = ~np.asarray(pad, bool) & np.isfinite(ret)
    keys, rows = np.unique(ret[real].view(np.int64), return_inverse=True)
    ridx = np.full(ret.shape, -1, np.int32)
    ridx[real] = rows.reshape(-1)
    return keys.view(np.float64), ridx


def retention_groups(ridx, n_rows: int, max_rows: int = MAX_RETENTIONS):
    """Contiguous candidate slices ``(lo, hi, rows)`` whose slots use at
    most ``max_rows`` of the ``n_rows`` retention rows (``rows``: the global
    rows, ascending), taken greedily in order; one slice, ``rows`` None,
    when all ``n_rows`` fit."""
    ridx = np.asarray(ridx)
    if n_rows <= max_rows:
        return [(0, ridx.shape[0], None)]
    out, lo, used = [], 0, set()
    for c in range(ridx.shape[0]):
        mine = set(ridx[c][ridx[c] >= 0].tolist())
        if len(used | mine) > max_rows:
            out.append((lo, c, np.array(sorted(used), np.int64)))
            lo, used = c, set()
        used |= mine
    out.append((lo, ridx.shape[0], np.array(sorted(used), np.int64)))
    return out


def _local_index(ret_u, ridx, lo, hi, rows):
    """A slice's retention rows and its slots' rows renumbered to them."""
    sub = ridx[lo:hi]
    if rows is None:
        return ret_u, sub
    local = np.where(sub >= 0, np.searchsorted(rows, sub), -1)
    return ret_u[rows], local.astype(np.int32)


def finish_energy(energy_part: torch.Tensor) -> np.ndarray:
    """Per-candidate energy (J) from per-block partials (fJ)."""
    return energy_part.cpu().numpy().sum(axis=1) * 1e-15


def finish_floor(floor_part: torch.Tensor) -> np.ndarray:
    """Per-retention floor refresh bits from the retention pass's per-range
    partials."""
    return floor_part.cpu().numpy().sum(axis=1)


def refresh_free(cands, lt_sorted, prefix_bits, prefix_read_bits,
                 maxlt_sorted):
    """``(energy [C] J, counts [C, D] int64)`` as NumPy arrays."""
    energy, counts = policy_rf(*cands, lt_sorted, prefix_bits,
                               prefix_read_bits, maxlt_sorted)
    return energy.cpu().numpy(), counts.cpu().numpy()


def floor_refresh_bits(ret_u, lt, bits) -> np.ndarray:
    """``[R]`` sums of ``floor(lt / ret_u[r]) * bits`` over the lifetimes
    (the retention pass without address groups)."""
    ret_t = _put(ret_u, np.float64, lt.device)
    return finish_floor(policy_retention(ret_t, lt, bits)[1])


def _candidate_pass(fn, cands, ret_u, ridx, lt, read_bits, bits):
    """One candidate-pass call per retention group; energy (J) and, for the
    ungrouped form, the picks, concatenated in candidate order."""
    _, rf, wf, n_dev = cands
    dev = lt.device
    energy, picks = [], []
    for lo, hi, rows in retention_groups(ridx, len(ret_u)):
        u, r = _local_index(ret_u, ridx, lo, hi, rows)
        out = fn(_put(u, np.float64, dev), _put(r, np.int32, dev), rf[lo:hi],
                 wf[lo:hi], n_dev[lo:hi], lt, read_bits, bits)
        part = out[0] if isinstance(out, tuple) else out
        energy.append(finish_energy(part))
        if isinstance(out, tuple):
            picks.append(out[1].cpu().numpy())
    return np.concatenate(energy), (np.concatenate(picks) if picks else None)


def refresh_aware_grouped(cands, ret_u, ridx, lt, read_bits, bits, seg,
                          addr_bits, addr_read_bits):
    """``(energy [C] J, counts [C, D] int64)`` as NumPy arrays: the
    retention pass over the address-sorted lifetimes, the candidate pass
    and the decision per address."""
    _, rf, wf, n_dev = cands
    dev = lt.device
    rs, _ = policy_retention(_put(ret_u, np.float64, dev), lt, bits, seg,
                             addr_bits.shape[0])
    energy, _ = _candidate_pass(policy_ra_grouped, cands, ret_u, ridx, lt,
                                read_bits, bits)
    counts = policy_ra_decide(_put(ridx, np.int32, dev), rf, wf, n_dev, rs,
                              addr_bits, addr_read_bits)
    return energy, counts.cpu().numpy()


def refresh_aware_ungrouped(cands, ret_u, ridx, lt, read_bits, bits):
    """``(energy [C] J, picks [C, L] int8)`` as NumPy arrays."""
    return _candidate_pass(policy_ra_ungrouped, cands, ret_u, ridx, lt,
                           read_bits, bits)
