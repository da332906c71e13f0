"""Pareto reduction of sweep points in the (area, energy) plane.

A design point is *dominated* if another point is no worse on both the
area and energy ratio vs SRAM and strictly better on at least one.  The
frontier is the dominated-free remainder, sorted by ascending area ratio
(so energy ratio descends along it) — the curve the paper's "up to 3x
energy / 4x area" optimum is read off of.

Determinism contract: the reduction sorts by ``(area_vs_sram,
energy_vs_sram, candidate)`` before the single-pass min-energy sweep, so
the frontier is a pure function of the point set — input order never
matters.  Exact (area, energy) ties collapse to the lexicographically
first candidate.

The all-SRAM anchor (``DeviceGrid(include_sram_only=True)``'s
``sram-only`` candidate, ``area_vs_sram == 1.0`` by construction) is
carried explicitly as :attr:`ParetoFrontier.anchor` even when cheaper
points dominate it, so every frontier stays normalized against the
baseline it is measured from.
"""

from __future__ import annotations

import dataclasses

from repro_torch.sweep.grid import SRAM_ONLY_ID


@dataclasses.dataclass(frozen=True)
class ParetoFrontier:
    """Dominated-free (area, energy) curve plus the all-SRAM anchor."""
    points: tuple        # non-dominated SweepPoints, ascending area ratio
    anchor: object       # the all-SRAM SweepPoint, or None
    n_total: int         # points fed into the reduction

    @property
    def n_dominated(self) -> int:
        return self.n_total - len(self.points)

    def best_energy(self):
        """The frontier point with the lowest energy ratio."""
        return min(self.points, key=lambda p: p.energy_vs_sram) \
            if self.points else None

    def best_area(self):
        """The frontier point with the lowest area ratio."""
        return self.points[0] if self.points else None

    def asdict(self) -> dict:
        return {
            "n_total": self.n_total,
            "n_dominated": self.n_dominated,
            "anchor": self.anchor.asdict() if self.anchor else None,
            "points": [p.asdict() for p in self.points],
        }

    def summary(self) -> str:
        lines = [f"{len(self.points)} frontier point(s) "
                 f"({self.n_dominated} dominated of {self.n_total})"]
        for p in self.points:
            tag = " <- all-SRAM anchor" if (
                self.anchor and p.candidate == self.anchor.candidate) else ""
            lines.append(
                f"  area {100 * p.area_vs_sram:6.1f}%  "
                f"energy {100 * p.energy_vs_sram:6.1f}%  "
                f"{p.candidate}{tag}")
        if self.anchor and all(p.candidate != self.anchor.candidate
                               for p in self.points):
            lines.append(
                f"  area {100 * self.anchor.area_vs_sram:6.1f}%  "
                f"energy {100 * self.anchor.energy_vs_sram:6.1f}%  "
                f"{self.anchor.candidate} (anchor, dominated)")
        return "\n".join(lines)


def dominates(p, q) -> bool:
    """True if ``p`` Pareto-dominates ``q`` in (area, energy) vs SRAM."""
    return (p.area_vs_sram <= q.area_vs_sram
            and p.energy_vs_sram <= q.energy_vs_sram
            and (p.area_vs_sram < q.area_vs_sram
                 or p.energy_vs_sram < q.energy_vs_sram))


def pareto_frontier(points, anchor_id: str = SRAM_ONLY_ID,
                    ) -> ParetoFrontier:
    """Reduce sweep points to their dominated-free (area, energy) curve."""
    anchor = next((p for p in points if p.candidate == anchor_id), None)
    ordered = sorted(points, key=lambda p: (p.area_vs_sram,
                                            p.energy_vs_sram,
                                            p.candidate))
    front = []
    best_energy = float("inf")
    for p in ordered:
        if p.energy_vs_sram < best_energy:
            front.append(p)
            best_energy = p.energy_vs_sram
    return ParetoFrontier(points=tuple(front), anchor=anchor,
                          n_total=len(ordered))
