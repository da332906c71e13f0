"""Assignment policies: the datum→device selection rules of the engine.

An :class:`AssignmentPolicy` answers one question for the composition
engine (:mod:`repro_torch.compose.engine`): *which device hosts each datum*.
The engine owns everything around that answer — device ordering,
broadcasting, energy summation order, capacity/area accounting — so a
policy is a pure, natively batched kernel over a :class:`PolicyBatch`.

Built-in policies (see ``docs/API.md`` for the full contract):

  ``refresh-free``   the seed ``compose()`` semantics: every datum goes
                     to the cheapest-access-energy device whose retention
                     covers it, so the array never refreshes.  Locked
                     bit-for-bit against the pre-refactor output.
  ``refresh-aware``  per-datum minimum *total* energy, with refresh
                     billed per Algorithm 1 (one refresh = one read +
                     one write of the bits, ``ceil(T / t_ret) - 1``
                     times — floor at exact interval multiples, where
                     the boundary needs no refresh):
                     a dense short-retention device may host longer-lived
                     data when its access-energy savings outweigh the
                     refresh cost ("Towards Memory Specialization"
                     argues retention-limited devices should be operated
                     *with* refresh when the energy math favors it).
                     Never worse than refresh-free: the refresh-free
                     choice is always in the candidate set with zero
                     refresh energy.
  ``bank-quantized`` a *capacity* post-pass composable on top of either
                     energy policy (OpenGCRAM-style design spaces assume
                     discrete bank granularities, not fractional
                     capacities): capacity fractions snap **up** to
                     multiples of ``1 / n_banks`` (``n_banks`` a power
                     of two), and the reported slack — quantized minus
                     unquantized total capacity, always >= 0 — is the
                     fragmentation cost, which feeds the area accounting.

Policy specs are strings (CLI ``--policy`` accepts the same grammar):

  ``refresh-free`` | ``refresh-aware``
  ``bank-quantized``                      (refresh-free base, 16 banks)
  ``bank-quantized:refresh-aware``        (refresh-aware base)
  ``bank-quantized:refresh-aware@32``     (explicit bank count)

This module is deliberately numpy+stdlib only (device models are
duck-typed), so campaign planning can resolve/validate policy specs
without dragging in the torch-backed analysis stack.
"""

from __future__ import annotations

import dataclasses

import numpy as np

DEFAULT_N_BANKS = 16


# ---------------------------------------------------------------------------
# batch context handed to policy kernels
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AddressGroups:
    """Per-address grouping of the (valid-filtered) lifetime axis.

    ``order`` is a stable argsort of the per-lifetime addresses,
    ``starts`` the segment boundaries into that order (one per unique
    address), ``max_lt_s`` each address's maximum lifetime in seconds —
    the refresh-free capacity rule.  Computed once per subpartition and
    shared across every candidate device set.
    """
    order: np.ndarray       # [L] indices sorting lifetimes by address
    starts: np.ndarray      # [A] segment starts into the sorted axis
    max_lt_s: np.ndarray    # [A] per-address max lifetime, seconds


@dataclasses.dataclass(frozen=True)
class PolicyBatch:
    """One chunk of candidate device sets, shaped for broadcast kernels.

    Shape convention (the batching contract): ``C`` candidates ×
    ``D`` device slots × ``L`` lifetimes (× ``A`` unique addresses).
    Device axes are padded to the widest candidate: padded slots carry
    ``ret_s = -inf`` (they never fit a lifetime) and ``read_fj =
    write_fj = +inf`` (they never win an energy argmin); ``pad`` marks
    them explicitly for kernels whose arithmetic would produce NaN on
    the infinities (e.g. ``0 * inf``).
    """
    devs: tuple             # per-candidate device lists, cheapest first
    ret_s: np.ndarray       # [C, D] retention at the observed write freq
    read_fj: np.ndarray     # [C, D] per-bit read energy
    write_fj: np.ndarray    # [C, D] per-bit write energy
    pad: np.ndarray         # [C, D] bool, True on padded slots
    fallback: np.ndarray    # [C, 1] index of each candidate's last device
    lt_s: np.ndarray        # [L] valid lifetimes, seconds
    reads: np.ndarray       # [L] reads per lifetime
    bits: np.ndarray        # [L] bits per lifetime
    groups: AddressGroups | None    # None when no raw lifetimes given


@dataclasses.dataclass(frozen=True)
class PolicyAssignment:
    """A policy kernel's answer for one batch."""
    lifetime_dev: np.ndarray            # [C, L] device index per lifetime
    refresh_per_lifetime: np.ndarray | None   # [C, L] refresh count billed
                                        # on the chosen device (None =>
                                        # refresh-free: zero by invariant)
    addr_dev: np.ndarray | None         # [C, A] device index per address
                                        # (None when batch.groups is None)


# ---------------------------------------------------------------------------
# the policy protocol + implementations
# ---------------------------------------------------------------------------

class AssignmentPolicy:
    """Datum→device selection rule (see module docstring)."""

    name: str = "?"
    #: approximate bytes per [C, D, L] broadcast element the kernel keeps
    #: live at peak, *including concurrent temporaries* — the engine
    #: sizes candidate chunks so ``chunk * D * L * broadcast_itemsize``
    #: stays under its byte cap.
    broadcast_itemsize: int = 1

    def assign(self, batch: PolicyBatch) -> PolicyAssignment:
        raise NotImplementedError

    def capacity(self, fractions: np.ndarray, devices) -> tuple:
        """Post-process raw capacity fractions; returns ``(fractions,
        quantization-report-or-None)``.  Identity by default."""
        return fractions, None


class RefreshFreePolicy(AssignmentPolicy):
    """First (cheapest-access-energy) device whose retention covers the
    datum — the seed ``compose()`` semantics, bit-for-bit."""

    name = "refresh-free"
    broadcast_itemsize = 2      # bool fit matrix + argmax/where temporary

    def assign(self, b: PolicyBatch) -> PolicyAssignment:
        fits = b.lt_s[None, None, :] <= b.ret_s[:, :, None]     # [C, D, L]
        ff = np.where(fits.any(axis=1), np.argmax(fits, axis=1),
                      b.fallback)
        ad = None
        if b.groups is not None:
            afits = b.groups.max_lt_s[None, None, :] <= b.ret_s[:, :, None]
            ad = np.where(afits.any(axis=1), np.argmax(afits, axis=1),
                          b.fallback)
        return PolicyAssignment(lifetime_dev=ff, refresh_per_lifetime=None,
                                addr_dev=ad)


class RefreshAwarePolicy(AssignmentPolicy):
    """Minimum-total-energy device per datum, refresh billed per
    Algorithm 1: ``E = B * (E_w + n_r * E_r + (ceil(T / t_ret) - 1) *
    (E_r + E_w))`` (see :meth:`_energies_fj` for the boundary
    convention).  Lifetimes pick their argmin device (energy
    accounting); addresses pick the argmin of their summed lifetime
    energies (capacity accounting).  Ties go to the cheaper-access
    device (the batch's device axis is sorted cheapest-first)."""

    name = "refresh-aware"
    # ~4 float64 [C, D, L] arrays live at peak: the refresh matrix, the
    # energy expression's running temporary, `e`, and the np.where /
    # per-address fancy-index copy.
    broadcast_itemsize = 32

    def _energies_fj(self, b: PolicyBatch) -> tuple:
        """Per-(candidate, device, lifetime) total energy in fJ, +inf on
        padded device slots, plus the refresh-count matrix.

        Refresh count = ``ceil(T / t_ret) - 1``: the number of retention
        intervals the lifetime spans beyond its first.  This equals
        Algorithm 1's ``floor(T / t_ret)`` except at exact multiples,
        where the boundary needs no refresh — the convention that keeps
        a ``T == t_ret`` datum at zero refreshes, exactly like the
        refresh-free ``lt <= ret`` fit test treats it (otherwise
        refresh-aware could bill a refresh on a device refresh-free
        considers covering, breaking the never-worse invariant).
        """
        ret = b.ret_s[:, :, None]
        # lt / inf -> -1 -> clamped 0 (never refreshes); lt / -inf (pad)
        # -> -0 -> -1 -> clamped 0 (energy forced to +inf below anyway).
        refresh = np.maximum(
            np.ceil(b.lt_s[None, None, :] / ret) - 1.0, 0.0)
        rw = b.read_fj[:, :, None] + b.write_fj[:, :, None]
        # padded slots: 0-read or 0-refresh lifetimes turn the +inf
        # energies into NaN (0 * inf); forced out of every argmin below.
        with np.errstate(invalid="ignore"):
            e = b.bits[None, None, :] * (
                b.write_fj[:, :, None]
                + b.reads[None, None, :] * b.read_fj[:, :, None]
                + refresh * rw)
        e = np.where(b.pad[:, :, None], np.inf, e)
        return e, refresh

    def assign(self, b: PolicyBatch) -> PolicyAssignment:
        e, refresh = self._energies_fj(b)
        ff = np.argmin(e, axis=1)                               # [C, L]
        r_sel = np.take_along_axis(refresh, ff[:, None, :], axis=1)[:, 0, :]
        ad = None
        if b.groups is not None and len(b.groups.starts):
            per_addr = np.add.reduceat(
                e[:, :, b.groups.order], b.groups.starts, axis=2)
            ad = np.argmin(per_addr, axis=1)                    # [C, A]
        return PolicyAssignment(lifetime_dev=ff,
                                refresh_per_lifetime=r_sel, addr_dev=ad)


class BankQuantizedPolicy(AssignmentPolicy):
    """Snap capacity fractions up to power-of-two bank granularity on
    top of a base energy policy (assignment and energy are the base's;
    only capacity — and hence area — changes)."""

    def __init__(self, base: AssignmentPolicy | None = None, *,
                 n_banks: int = DEFAULT_N_BANKS):
        base = base if base is not None else RefreshFreePolicy()
        if isinstance(base, BankQuantizedPolicy):
            raise ValueError("bank-quantized cannot wrap bank-quantized")
        n = int(n_banks)
        if n < 1 or (n & (n - 1)):
            raise ValueError(
                f"n_banks must be a power of two >= 1, got {n_banks!r}")
        self.base = base
        self.n_banks = n
        self.name = f"bank-quantized:{base.name}@{n}"
        self.broadcast_itemsize = base.broadcast_itemsize

    def assign(self, batch: PolicyBatch) -> PolicyAssignment:
        return self.base.assign(batch)

    def capacity(self, fractions: np.ndarray, devices) -> tuple:
        frac = np.asarray(fractions, dtype=np.float64)
        banks = np.ceil(frac * self.n_banks)    # pure ceil: quantized >=
        frac_q = banks / self.n_banks           # unquantized, exactly
        report = {
            "n_banks": self.n_banks,
            "banks": [int(v) for v in banks],
            "unquantized_fractions": frac.tolist(),
            "slack": float(frac_q.sum() - frac.sum()),
        }
        return frac_q, report


# ---------------------------------------------------------------------------
# the policy registry / spec grammar
# ---------------------------------------------------------------------------

_CANONICAL = ("refresh-free", "refresh-aware", "bank-quantized")


def available_policies() -> tuple:
    """The policy spec roots ``get_policy`` accepts (``bank-quantized``
    additionally composes as ``bank-quantized[:<base>][@<n_banks>]``)."""
    return _CANONICAL


def get_policy(spec="refresh-free") -> AssignmentPolicy:
    """Resolve a policy spec string (or pass through an instance).

    Grammar: ``refresh-free`` | ``refresh-aware`` |
    ``bank-quantized[:<base-policy>][@<n_banks>]``.
    """
    if isinstance(spec, AssignmentPolicy):
        return spec
    if spec is None:
        return RefreshFreePolicy()
    s = str(spec).strip()
    banks = None
    if "@" in s:
        s, _, tail = s.partition("@")
        try:
            banks = int(tail)
        except ValueError:
            raise ValueError(
                f"policy {spec!r}: '@' must be followed by an integer "
                "bank count") from None
    root, _, rest = s.partition(":")
    if root == "bank-quantized":
        inner = get_policy(rest) if rest else RefreshFreePolicy()
        return BankQuantizedPolicy(
            inner, n_banks=banks if banks is not None else DEFAULT_N_BANKS)
    if rest or banks is not None:
        raise ValueError(
            f"policy {spec!r}: only bank-quantized takes ':<base>' / "
            "'@<n_banks>' modifiers")
    if root == "refresh-free":
        return RefreshFreePolicy()
    if root == "refresh-aware":
        return RefreshAwarePolicy()
    raise ValueError(
        f"unknown policy {spec!r}; available: {', '.join(_CANONICAL)} "
        "(bank-quantized composes as "
        "'bank-quantized[:refresh-aware][@<n_banks>]')")
