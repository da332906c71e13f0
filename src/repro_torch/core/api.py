"""The GainSight front door: backend registry + ``ProfileSession``.

The paper's pitch is *retargetable profiling backends with an
architecture-agnostic analytical frontend* (§3).  This module is that
contract as code:

  Backend           protocol every backend implements: ``name``, ``mode``,
                    and ``run(workload, **cfg) -> ProfileResult`` (one
                    materialized trace, or an iterator of trace chunks)
  register_backend  decorator adding a backend to the global registry
  get_backend       registry lookup by name or alias; built-in backends
                    lazy-import
  ProfileSession    chains profile() -> analyze() -> compose() -> report()
                    over any registered backend, monolithic or streaming

Typical use::

    from repro_torch.core import ProfileSession
    from repro_torch.backends.systolic import GemmLayer

    session = ProfileSession("systolic")
    session.profile([GemmLayer("g", 128, 256, 256)], rows=128, cols=128)
    session.analyze().compose()
    report = session.report("report.json")

Every step takes the same kwargs the underlying seed functions took: the
backend config goes to ``profile()``, ``mode``/``write_allocate``/
``devices`` go to ``analyze()``, and ``devices`` to ``compose()`` - device
sets may be given as ``DeviceModel`` objects or resolved by name.

Host/device split: backends build the trace with numpy on the host (the
cache backend replays its streams on the session's ``device``);
``analyze()`` moves each subpartition's arrays to the session's torch
``device`` once and extracts lifetimes there (``device=None`` is the CUDA
device and raises without one; tests pass ``device="cpu"``); Algorithm 1
runs in numpy on the valid lifetimes copied back, and the composition
engine runs the policy kernels on the session's device (``engine="torch"``,
the default) or its numpy oracle (``engine="numpy"``).
"""

from __future__ import annotations

import dataclasses
import importlib
import inspect
from typing import Iterable, Iterator, Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.core.accumulate import (TraceAccumulator,
                                         folded_short_lived_fraction)
from repro_torch.core.composer import Composition, compose as compose_stats
from repro_torch.core.devices import DEFAULT_DEVICES, DeviceModel, device_by_name
from repro_torch.core.frontend import (dump_report, stats_from_lifetimes,
                                       subpartition_entry)
from repro_torch.core.lifetime import (lifetimes_of_trace,
                                       short_lived_fraction as _short_lived)
from repro_torch.core.trace import Trace
from repro_torch.device import resolve_device


# ---------------------------------------------------------------------------
# Backend protocol + result
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ProfileResult:
    """What a backend run produced: one trace or a stream of chunks, plus
    per-kernel counters for PKA / per-kernel attribution."""
    trace: Trace | None = None
    chunks: Iterator[Trace] | None = None
    kernels: list = dataclasses.field(default_factory=list)
    mode: str = "scratchpad"
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def streaming(self) -> bool:
        return self.trace is None and self.chunks is not None


@runtime_checkable
class Backend(Protocol):
    """A profiling backend (paper §5): runs a workload on a modeled target
    and emits the canonical trace format."""
    name: str
    mode: str  # default frontend mode: "scratchpad" | "cache"

    def run(self, workload, **cfg) -> ProfileResult: ...


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}          # canonical name -> Backend class or instance
_ALIASES: dict[str, str] = {}
_BUILTIN_MODULES = {
    "systolic": "repro_torch.backends.systolic",
    "cachesim": "repro_torch.backends.cachesim",
    "gpu": "repro_torch.backends.cachesim",
    "opstream": "repro_torch.backends.opstream",
    "tpu_graph": "repro_torch.backends.tpu_graph",
    "tpu": "repro_torch.backends.tpu_graph",
}


def register_backend(name: str | None = None, *, aliases: Sequence[str] = ()):
    """Class decorator adding a Backend implementation to the registry::

        @register_backend("systolic")
        class SystolicBackend: ...
    """
    def deco(obj):
        cname = name or getattr(obj, "name", None)
        if not cname:
            raise ValueError("backend needs a name (decorator arg or "
                             "`name` attribute)")
        _REGISTRY[cname] = obj
        for alias in aliases:
            _ALIASES[alias] = cname
        return obj
    return deco


def get_backend(name: str) -> Backend:
    """Resolve a backend by registry name or alias; instantiate classes."""
    cname = _ALIASES.get(name, name)
    if cname not in _REGISTRY and name in _BUILTIN_MODULES:
        importlib.import_module(_BUILTIN_MODULES[name])
        cname = _ALIASES.get(name, name)
    if cname not in _REGISTRY:
        raise ValueError(
            f"unknown backend {name!r}; available: {available_backends()}")
    entry = _REGISTRY[cname]
    return entry() if isinstance(entry, type) else entry


def available_backends() -> tuple:
    """Canonical names of every registered backend (built-ins included)."""
    for mod in set(_BUILTIN_MODULES.values()):
        importlib.import_module(mod)
    return tuple(sorted(_REGISTRY))


def resolve_devices(
    devices: Sequence[DeviceModel | str] | None,
) -> tuple:
    """Device sets by object or by name; None -> DEFAULT_DEVICES."""
    if devices is None:
        return tuple(DEFAULT_DEVICES)
    return tuple(device_by_name(d) if isinstance(d, str) else d
                 for d in devices)


# ---------------------------------------------------------------------------
# ProfileSession
# ---------------------------------------------------------------------------

class ProfileSession:
    """One profile -> analyze -> compose -> report pipeline run.

    Stages are chainable (each returns ``self``) and individually
    overridable; ``report()`` auto-runs any stage not yet executed with
    its defaults, so ``ProfileSession("systolic").run(workload)`` is the
    whole paper workflow in one line.
    """

    def __init__(self, backend: Backend | str | None = None, *,
                 devices: Sequence[DeviceModel | str] | None = None,
                 device=None,
                 **backend_cfg):
        self.backend = (get_backend(backend) if isinstance(backend, str)
                        else backend)
        self.devices = resolve_devices(devices)
        # torch device of the lifetime extraction (None -> the CUDA device)
        self.device = resolve_device(device)
        self._backend_cfg = dict(backend_cfg)
        self._result: ProfileResult | None = None
        self._report: dict | None = None
        self._stats: dict = {}        # sub name -> (SubpartitionStats, raw)
        self._acc: TraceAccumulator | None = None
        self._clock_hz: float | None = None
        self._compositions: dict[str, Composition] = {}

    # ------------------------------------------------------------------
    # alternate entries: already-materialized traces / chunk streams
    # ------------------------------------------------------------------
    @classmethod
    def from_trace(cls, trace: Trace, *, mode: str = "scratchpad",
                   kernels: Sequence = (),
                   devices: Sequence[DeviceModel | str] | None = None,
                   device=None) -> "ProfileSession":
        s = cls(devices=devices, device=device)
        s._result = ProfileResult(trace=trace, kernels=list(kernels),
                                  mode=mode)
        return s

    @classmethod
    def from_chunks(cls, chunks: Iterable[Trace], *,
                    mode: str = "scratchpad", kernels: Sequence = (),
                    devices: Sequence[DeviceModel | str] | None = None,
                    device=None) -> "ProfileSession":
        s = cls(devices=devices, device=device)
        s._result = ProfileResult(chunks=iter(chunks),
                                  kernels=list(kernels), mode=mode)
        return s

    # ------------------------------------------------------------------
    # pipeline stages
    # ------------------------------------------------------------------
    def profile(self, workload, **cfg) -> "ProfileSession":
        """Run the backend on a workload; kwargs override session config.
        A backend whose ``run`` takes a ``device`` gets the session's."""
        if self.backend is None:
            raise RuntimeError("no backend bound; construct with "
                               "ProfileSession(backend_name) or use "
                               "from_trace/from_chunks")
        merged = {**self._backend_cfg, **cfg}
        if "device" in inspect.signature(self.backend.run).parameters:
            merged.setdefault("device", self.device)
        self._result = self.backend.run(workload, **merged)
        self._report = None
        self._acc = None
        self._stats.clear()
        self._compositions.clear()
        return self

    def analyze(self, *, mode: str | None = None,
                write_allocate: bool = True,
                devices: Sequence[DeviceModel | str] | None = None,
                ) -> "ProfileSession":
        """Run the Algorithm-1 frontend over the profiled trace/chunks."""
        res = self._require_result()
        mode = mode or res.mode
        devs = resolve_devices(devices) if devices is not None \
            else self.devices
        report = {"mode": mode, "write_allocate": write_allocate,
                  "subpartitions": {}}
        self._stats.clear()
        if res.streaming:
            acc = self._acc
            if acc is None:
                acc = TraceAccumulator(mode=mode,
                                       write_allocate=write_allocate)
                for chunk in res.chunks:
                    acc.update(chunk)
                acc.finalize()
                self._acc = acc
            elif (acc.mode != mode
                  or acc.write_allocate != write_allocate):
                # the chunk stream was consumed by the first analyze();
                # only device-set changes can be recomputed from the fold
                raise RuntimeError(
                    "streaming profile results are folded once: "
                    f"analyzed with mode={acc.mode!r}/"
                    f"write_allocate={acc.write_allocate}, cannot "
                    f"re-analyze with mode={mode!r}/"
                    f"write_allocate={write_allocate}; re-run profile() "
                    "or feed a fresh iterator to from_chunks()")
            self._clock_hz = acc.clock_hz
            for sub in acc.subpartitions:
                st, raw = acc.stats(sub)
                self._stats[st.name] = (st, raw)
                report["subpartitions"][st.name] = \
                    subpartition_entry(st, devs)
        else:
            trace = res.trace
            self._clock_hz = trace.clock_hz
            subs = np.unique(np.asarray(trace.subpartition))
            for sub in subs.tolist():
                t_sub = trace.select(int(sub))
                raw = lifetimes_of_trace(t_sub, mode=mode,
                                         write_allocate=write_allocate,
                                         device=self.device)
                st = stats_from_lifetimes(t_sub, int(sub), raw)
                self._stats[st.name] = (st, raw)
                report["subpartitions"][st.name] = \
                    subpartition_entry(st, devs)
        if res.kernels:
            report["kernels"] = [
                k if isinstance(k, dict) else dataclasses.asdict(k)
                if dataclasses.is_dataclass(k) else k.__dict__
                for k in res.kernels]
        report.update(res.meta)
        self._report = report
        return self

    def compose(self, *,
                devices: Sequence[DeviceModel | str] | None = None,
                policy="refresh-free",
                engine="torch") -> "ProfileSession":
        """Derive the heterogeneous composition for every subpartition and
        attach it to the report (paper Table 7 / §7.1.5).  ``policy=``
        selects the assignment policy (``"refresh-free"`` default,
        ``"refresh-aware"``, ``"bank-quantized[:<base>][@<n_banks>]"`` —
        see :mod:`repro_torch.compose`); ``engine=`` the evaluation backend
        (``"torch"``, the default, runs the policy kernels on the session's
        device; ``"numpy"`` is the oracle)."""
        if self._report is None:
            self.analyze()
        devs = resolve_devices(devices) if devices is not None \
            else self.devices
        for name, (st, raw) in self._stats.items():
            comp = compose_stats(st, raw=raw, devices=devs,
                                 clock_hz=self._clock_hz, policy=policy,
                                 engine=engine, device=self.device)
            self._compositions[name] = comp
            entry = {
                "devices": list(comp.devices),
                "capacity_fractions": comp.capacity_fractions.tolist(),
                "energy_vs_sram": comp.energy_vs_sram,
                "area_vs_sram": comp.area_vs_sram,
                "policy": comp.policy,
            }
            if comp.quantization is not None:
                entry["quantization"] = comp.quantization
            self._report["subpartitions"][name]["composition"] = entry
        return self

    def sweep(self, grid=None, *, workers: int = 1,
              policy="refresh-free", engine="torch", attach: bool = True):
        """Evaluate a composition design-space sweep over every analyzed
        subpartition and return the :class:`repro_torch.sweep.SweepResult`
        (grid defaults to ``repro_torch.sweep.DeviceGrid()``; auto-runs
        ``analyze()`` if needed).  ``policy=`` is the assignment policy
        applied to every candidate; ``engine=`` the evaluation backend
        (``"torch"``, the default, runs the policy kernels on the session's
        device; ``"numpy"`` is the oracle).

        With ``attach=True`` the per-subpartition Pareto frontiers are
        also recorded under ``report()["sweep"]``.
        """
        from repro_torch.sweep import SweepRunner
        self._require_analyzed()
        runner = SweepRunner(grid, workers=workers, policy=policy,
                             engine=engine, device=self.device)
        result = runner.run_session(self)
        if attach:
            self._report["sweep"] = {
                (sub if geom is None else f"{geom}/{sub}"):
                frontier.asdict()
                for (geom, sub), frontier in result.frontiers().items()}
        return result

    def report(self, path: str | None = None) -> dict:
        """The JSON-serializable report; auto-runs analyze() if needed."""
        if self._report is None:
            self.analyze()
        if path:
            dump_report(self._report, path)
        return self._report

    def run(self, workload, *, mode: str | None = None,
            write_allocate: bool | None = None,
            devices: Sequence[DeviceModel | str] | None = None,
            policy="refresh-free", engine="torch",
            report_path: str | None = None, **cfg) -> dict:
        """profile -> analyze -> compose -> report in one call.

        Analysis options are routed by stage instead of all landing on
        the backend: ``mode``/``devices`` go to ``analyze()``/
        ``compose()``, ``policy``/``engine`` to ``compose()``, everything
        else to ``profile()``.  An explicit ``write_allocate`` goes to *both*
        the frontend and — on cache-mode backends, where it is also a
        simulator policy — the backend, so the two stay in agreement
        (paper Table 8 pairs them); scratchpad backends have no
        write-allocate knob and only the frontend semantics apply.
        """
        if write_allocate is not None and self.backend is not None \
                and self.backend.mode == "cache":
            cfg["write_allocate"] = write_allocate
        self.profile(workload, **cfg)
        self.analyze(mode=mode,
                     write_allocate=(True if write_allocate is None
                                     else write_allocate),
                     devices=devices)
        self.compose(devices=devices, policy=policy, engine=engine)
        return self.report(report_path)

    @classmethod
    def campaign(cls, workloads, backends, **kw):
        """Run a multi-workload x multi-backend campaign and return the
        :class:`repro_torch.launch.campaign.CampaignResult` (cached, pooled;
        see ``python -m repro_torch campaign``).  ``kw`` goes to
        :class:`repro_torch.launch.campaign.CampaignRunner` (``jobs=``,
        ``cache_dir=``, ``seq=``, ``retention_bins=``, ``device=``, ...)."""
        from repro_torch.launch.campaign import CampaignRunner
        return CampaignRunner(workloads, backends, **kw).run()

    # ------------------------------------------------------------------
    # accessors
    # ------------------------------------------------------------------
    @property
    def trace(self) -> Trace | None:
        return self._result.trace if self._result else None

    @property
    def kernels(self) -> list:
        return self._result.kernels if self._result else []

    def subpartition_stats(self, name: str):
        """(SubpartitionStats, raw lifetimes) for a subpartition name."""
        self._require_analyzed()
        return self._stats[name]

    def composition(self, name: str) -> Composition:
        if name not in self._compositions:
            raise RuntimeError(
                f"no composition for {name!r}; call compose() first")
        return self._compositions[name]

    def short_lived_fraction(self, name: str, retention_s: float,
                             weight_by_accesses: bool = True) -> float:
        """Fraction of accesses (or lifetimes) fitting a retention target
        for one subpartition, on either the monolithic or streaming path."""
        self._require_analyzed()
        st, raw = self._stats[name]
        if hasattr(raw, "n_events"):
            # streaming path: folded lifetimes carry per-segment events
            return folded_short_lived_fraction(
                raw, self._clock_hz, retention_s,
                weight_by_accesses=weight_by_accesses)
        return _short_lived(raw, self._clock_hz, retention_s,
                            weight_by_accesses=weight_by_accesses)

    # ------------------------------------------------------------------
    def _require_result(self) -> ProfileResult:
        if self._result is None:
            raise RuntimeError("call profile() (or from_trace/from_chunks) "
                               "before analyze()")
        return self._result

    def _require_analyzed(self):
        if self._report is None:
            self.analyze()
