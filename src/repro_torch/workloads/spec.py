"""Workload specs + registry: one workload, many backend lowerings.

GainSight's headline results are *suite-level* aggregates over MLPerf
Inference and PolyBench, but a backend only understands its own native
input: ``GemmLayer`` lists (systolic), ``StreamBuilder`` op programs
(cachesim/opstream), traceable functions (tpu_graph).  A
:class:`WorkloadSpec` is the architecture-agnostic description that
lowers itself to each backend's input via :meth:`WorkloadSpec.build`, so
the same registered workload can be profiled on every backend it has a
lowering for.

Mirrors the ``repro_torch.core.api`` backend registry::

    @register_workload("polybench-2mm", suite="polybench",
                       params={"ni": 128}, backends=("systolic", "gpu"))
    def _lower(params, backend):
        ...
        return workload, backend_cfg   # native input + default run kwargs

    spec = get_workload("polybench-2mm")
    workload, cfg = spec.build("systolic")
    spec.with_params(ni=64).content_hash()   # cache-key input

Import contract: this module (and ``repro_torch.workloads`` as a whole) is
stdlib-only at import time — registering a spec records a lowering
*callable*; backend modules are imported only when ``build()`` runs.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Callable, Mapping, Sequence

# Canonical-name map mirroring repro_torch.core.api's builtin aliases; kept
# local (not imported) so this module stays torch-free at import time.
_BACKEND_ALIASES = {"gpu": "cachesim", "tpu": "tpu_graph"}


def canonical_backend(name: str) -> str:
    """Backend alias -> canonical registry name ("gpu" -> "cachesim")."""
    return _BACKEND_ALIASES.get(name, name)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """One registered workload: identity + params + per-backend lowering.

    ``params`` is the canonical, JSON-serializable parameterization
    (stored as sorted key/value pairs so specs hash and compare
    deterministically); ``lowering(params_dict, backend)`` returns the
    backend-native ``(workload, backend_cfg)`` pair.  ``version`` is the
    lowering version: bump it whenever ``lowering`` changes the emitted
    trace for unchanged params, so campaign cache keys roll over.
    """

    name: str
    lowering: Callable = dataclasses.field(compare=False, repr=False)
    suite: str = "misc"
    description: str = ""
    params: tuple = ()
    backends: tuple = ()
    version: int = 1

    # ------------------------------------------------------------------
    @property
    def param_dict(self) -> dict:
        return dict(self.params)

    def with_params(self, **overrides) -> "WorkloadSpec":
        """A copy with some params overridden (unknown keys rejected)."""
        base = self.param_dict
        unknown = sorted(set(overrides) - set(base))
        if unknown:
            raise ValueError(
                f"workload {self.name!r} has no param(s) {unknown}; "
                f"available: {sorted(base)}")
        base.update(overrides)
        return dataclasses.replace(
            self, params=tuple(sorted(base.items())))

    def supports(self, backend: str) -> bool:
        return canonical_backend(backend) in self.backends

    def build(self, backend: str):
        """Lower to ``backend``'s native input: ``(workload, cfg)``.

        ``backend`` may be a canonical name or an alias ("gpu", "tpu").
        Raises ``ValueError`` for backends this workload has no lowering
        for.
        """
        cname = canonical_backend(backend)
        if cname not in self.backends:
            raise ValueError(
                f"workload {self.name!r} has no lowering for backend "
                f"{backend!r}; supported backends: "
                f"{list(self.backends)}")
        out = self.lowering(self.param_dict, cname)
        if isinstance(out, tuple) and len(out) == 2 \
                and isinstance(out[1], dict):
            return out
        return out, {}

    def content_hash(self) -> str:
        """Deterministic identity hash over (name, suite, version,
        params) — the workload half of a trace-cache key."""
        payload = {"workload": self.name, "suite": self.suite,
                   "version": self.version, "params": self.param_dict}
        return hashlib.sha256(
            json.dumps(payload, sort_keys=True,
                       default=repr).encode()).hexdigest()

    def describe(self) -> str:
        backs = ",".join(self.backends)
        return f"{self.name:22s} suite={self.suite:10s} [{backs}]"


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}               # name -> WorkloadSpec
_ALIASES: dict = {}                # alias -> name


def register_workload(name: str, *, suite: str = "misc",
                      description: str = "",
                      params: Mapping | None = None,
                      backends: Sequence[str] = (),
                      aliases: Sequence[str] = (),
                      version: int = 1):
    """Decorator registering a lowering function as a :class:`WorkloadSpec`::

        @register_workload("resnet-block", suite="cnn",
                           params={"hw": 28}, backends=("systolic",))
        def _lower(params, backend) -> tuple[workload, dict]: ...
    """
    def deco(fn):
        spec = WorkloadSpec(
            name=name, lowering=fn, suite=suite, description=description,
            params=tuple(sorted((params or {}).items())),
            backends=tuple(canonical_backend(b) for b in backends),
            version=version)
        _REGISTRY[name] = spec
        for alias in aliases:
            _ALIASES[alias] = name
        return fn
    return deco


def get_workload(name: str) -> WorkloadSpec:
    """Spec by registry name or alias; ValueError with the full list."""
    cname = _ALIASES.get(name, name)
    if cname not in _REGISTRY:
        raise ValueError(
            f"unknown workload {name!r}; available: "
            f"{available_workloads()}")
    return _REGISTRY[cname]


def available_workloads(suite: str | None = None) -> tuple:
    """Registered workload names (optionally one suite's), sorted."""
    return tuple(sorted(
        n for n, s in _REGISTRY.items()
        if suite is None or s.suite == suite))


def available_suites() -> tuple:
    return tuple(sorted({s.suite for s in _REGISTRY.values()}))


def resolve_workloads(selector: str | Sequence[str]) -> tuple:
    """Workload names from a CLI-ish selector: a list of names, a
    comma-separated string, ``"all"``, or ``"suite:<name>"`` entries."""
    if isinstance(selector, str):
        selector = [s for s in selector.split(",") if s.strip()]
    out: list = []
    for item in selector:
        item = item.strip()
        if item == "all":
            names = available_workloads()
        elif item.startswith("suite:"):
            suite = item.split(":", 1)[1]
            names = available_workloads(suite)
            if not names:
                raise ValueError(
                    f"unknown suite {suite!r}; available: "
                    f"{available_suites()}")
        else:
            names = (get_workload(item).name,)
        out.extend(n for n in names if n not in out)
    return tuple(out)
