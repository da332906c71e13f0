"""Sweep execution: evaluate the composition engine across a ``DeviceGrid``.

The batched datum→device assignment lives in :mod:`repro_torch.compose` now —
``SweepRunner`` feeds the whole candidate grid into one
:func:`repro_torch.compose.engine.evaluate` call per subpartition, so the
sweep carries **no assignment broadcast of its own** and is bit-for-bit
identical to per-candidate ``compose()`` by construction (the engine is
the same code path; ``tests/test_torch_sweep.py`` locks it against the
reference's sweep).

Every entry point takes ``policy=`` (``"refresh-free"`` default,
``"refresh-aware"``, ``"bank-quantized[:<base>][@<n_banks>]"`` — see
``repro_torch.compose.get_policy``), which flows into the evaluated
compositions, the ``SweepPoint`` schema, and the CSV/JSON exports.

The outer loop over subpartitions (and cache geometries, via
:meth:`SweepRunner.run_geometries`) is thread-parallel under
``workers > 1``.  With ``engine="numpy"`` the heavy reductions release
the GIL and overlap; with ``engine="torch"`` each thread's kernel launches
queue on the device's stream (there is no dispatch lock: every call
allocates its own outputs).  Either way a 4-thread sweep is bit-for-bit
identical to the serial one (``tests/test_torch_executor.py``).
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Mapping, Sequence

from repro_torch.compose.engine import evaluate as _engine_evaluate
from repro_torch.compose.types import Composition
from repro_torch.core.frontend import SubpartitionStats
from repro_torch.sweep.grid import Candidate, DeviceGrid
from repro_torch.sweep.pareto import ParetoFrontier, pareto_frontier


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One evaluated design point: candidate x subpartition [x geometry]."""
    candidate: str
    subpartition: str
    composition: Composition
    params: dict = dataclasses.field(default_factory=dict)
    geometry: str | None = None
    policy: str = "refresh-free"
    family: str | None = None     # device family behind the candidate

    @property
    def area_vs_sram(self) -> float:
        return self.composition.area_vs_sram

    @property
    def energy_vs_sram(self) -> float:
        return self.composition.energy_vs_sram

    def asdict(self) -> dict:
        comp = self.composition
        return {
            "candidate": self.candidate,
            "subpartition": self.subpartition,
            "geometry": self.geometry,
            "policy": self.policy,
            "family": self.family,
            "area_vs_sram": comp.area_vs_sram,
            "energy_vs_sram": comp.energy_vs_sram,
            "area_um2": comp.area_um2,
            "energy_j": comp.energy_j,
            "devices": list(comp.devices),
            "capacity_fractions": comp.capacity_fractions.tolist(),
            "params": dict(self.params),
        }


@dataclasses.dataclass
class SweepResult:
    """All evaluated points plus Pareto reduction / export helpers."""
    points: list

    def __len__(self) -> int:
        return len(self.points)

    def groups(self) -> dict:
        """Points keyed by (geometry, subpartition), insertion-ordered."""
        out: dict = {}
        for p in self.points:
            out.setdefault((p.geometry, p.subpartition), []).append(p)
        return out

    def frontier(self, subpartition: str | None = None,
                 geometry: str | None = None) -> ParetoFrontier:
        """Pareto frontier over the selected points (all, by default)."""
        pts = [p for p in self.points
               if (subpartition is None or p.subpartition == subpartition)
               and (geometry is None or p.geometry == geometry)]
        return pareto_frontier(pts)

    def frontiers(self) -> dict:
        """One frontier per (geometry, subpartition) group."""
        return {k: pareto_frontier(v) for k, v in self.groups().items()}

    def to_json(self) -> dict:
        entry = {}
        for (geom, sub), frontier in self.frontiers().items():
            key = sub if geom is None else f"{geom}/{sub}"
            entry[key] = frontier.asdict()
        return {"n_points": len(self.points),
                "points": [p.asdict() for p in self.points],
                "frontiers": entry}

    def csv_rows(self) -> list:
        """``geometry,subpartition,candidate,family,policy,area_vs_sram,
        energy_vs_sram,on_frontier,capacity_fractions`` rows (header
        included; fields holding commas — candidate ids, capacity maps —
        are quoted)."""
        import csv
        import io
        on_front = set()
        for (geom, sub), fr in self.frontiers().items():
            for p in fr.points:
                on_front.add((geom, sub, p.candidate))
        buf = io.StringIO()
        w = csv.writer(buf, lineterminator="\n")
        w.writerow(["geometry", "subpartition", "candidate", "family",
                    "policy", "area_vs_sram", "energy_vs_sram",
                    "on_frontier", "capacity_fractions"])
        for p in self.points:
            caps = "|".join(
                f"{d}:{c:.6g}" for d, c in
                zip(p.composition.devices,
                    p.composition.capacity_fractions))
            front = (p.geometry, p.subpartition, p.candidate) in on_front
            w.writerow([p.geometry or "", p.subpartition, p.candidate,
                        p.family or "", p.policy,
                        f"{p.area_vs_sram:.9g}",
                        f"{p.energy_vs_sram:.9g}", int(front), caps])
        return buf.getvalue().splitlines()


# ---------------------------------------------------------------------------
# batched candidate evaluation (thin wrapper over the shared engine)
# ---------------------------------------------------------------------------

def evaluate_candidates(
    candidates: Sequence[Candidate],
    stats: SubpartitionStats,
    raw=None,
    clock_hz: float = 1.0e9,
    policy="refresh-free",
    engine="torch",
    device=None,
) -> list:
    """``[compose(stats, raw, c.devices, clock_hz, policy) for c in
    candidates]`` with the candidate loop batched by the shared engine
    (:func:`repro_torch.compose.engine.evaluate`) — identical results, one
    broadcast.  ``engine="torch"`` (default) runs the policy kernels on
    ``device`` (~1e-9 relative energy vs the ``"numpy"`` oracle)."""
    return _engine_evaluate([c.devices for c in candidates], stats,
                            raw=raw, clock_hz=clock_hz, policy=policy,
                            engine=engine, device=device)


# ---------------------------------------------------------------------------
# SweepRunner
# ---------------------------------------------------------------------------

class SweepRunner:
    """Evaluate a ``DeviceGrid`` over subpartitions (x cache geometries).

    ``policy=`` selects the assignment policy for every evaluated
    candidate; ``engine=`` the evaluation backend (``"torch"``, the
    default, runs the policy kernels on ``device``: ``None`` is the CUDA
    device and raises without one; it is also the device of the profiling
    sessions :meth:`run_geometries` builds; ``"numpy"`` is the oracle).
    ``workers > 1`` thread-parallelizes the outer (subpartition /
    geometry) loop; results are returned in deterministic submission
    order regardless of completion order.
    """

    def __init__(self, grid: DeviceGrid | None = None, *,
                 workers: int = 1, policy="refresh-free",
                 engine="torch", device=None):
        from repro_torch.compose import get_policy
        self.grid = grid if grid is not None else DeviceGrid()
        self.workers = max(1, int(workers))
        self.policy = get_policy(policy)
        self.engine = engine
        # resolved where it is used: a NumPy sweep over analyzed stats
        # touches no device
        self.device = device

    # -- one subpartition ------------------------------------------------
    def run_stats(self, stats: SubpartitionStats, raw=None, *,
                  clock_hz: float = 1.0e9,
                  subpartition: str | None = None,
                  geometry: str | None = None) -> list:
        cands = self.grid.candidates()
        comps = evaluate_candidates(cands, stats, raw=raw,
                                    clock_hz=clock_hz, policy=self.policy,
                                    engine=self.engine, device=self.device)
        name = subpartition if subpartition is not None else stats.name
        return [SweepPoint(candidate=c.cid, subpartition=name,
                           composition=comp, params=c.params,
                           geometry=geometry, policy=comp.policy,
                           family=c.params.get("family"))
                for c, comp in zip(cands, comps)]

    # -- all subpartitions of an analyzed session ------------------------
    def run_session(self, session, *, geometry: str | None = None,
                    ) -> SweepResult:
        """Sweep every analyzed subpartition of a ``ProfileSession``."""
        session._require_analyzed()
        tasks = [(name, st, raw) for name, (st, raw)
                 in session._stats.items()]
        clock = session._clock_hz or 1.0e9

        def one(item):
            name, st, raw = item
            return self.run_stats(st, raw, clock_hz=clock,
                                  subpartition=name, geometry=geometry)

        return SweepResult(points=self._map(one, tasks))

    # -- grid x geometries ----------------------------------------------
    def run_geometries(self, backend: str, workload,
                       geometries: Mapping[str, Mapping], *,
                       devices=None, **base_cfg) -> SweepResult:
        """Re-profile ``workload`` once per geometry (label -> backend
        config overrides) and sweep the grid over each result."""
        from repro_torch.core.api import ProfileSession

        def one(item):
            label, cfg = item
            session = ProfileSession(backend, devices=devices,
                                     device=self.device)
            session.profile(workload, **{**base_cfg, **dict(cfg)})
            session.analyze()
            return self.run_session(session, geometry=label).points

        return SweepResult(points=self._map(one, list(geometries.items())))

    # -- parallel map preserving submission order ------------------------
    def _map(self, fn, items) -> list:
        if self.workers == 1 or len(items) <= 1:
            chunks = [fn(it) for it in items]
        else:
            with ThreadPoolExecutor(max_workers=self.workers) as pool:
                chunks = list(pool.map(fn, items))
        return [p for chunk in chunks for p in chunk]
