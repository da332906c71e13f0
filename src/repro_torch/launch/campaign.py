"""Multi-workload campaign orchestrator: ``python -m repro_torch campaign``.

The paper's headline numbers are *suite-level* aggregates ("64.3% of
first-level GPU cache accesses ... exhibit sub-microsecond lifetimes"
across MLPerf Inference + PolyBench), not single-run observations.
:class:`CampaignRunner` produces them: it runs N registered workloads x
M registry backends through the full ``ProfileSession`` pipeline with a
worker pool, caches each run's analysis artifact on disk keyed by a
content hash of (workload spec, backend, config), and folds the
per-run results into one cross-suite aggregate report —
access-weighted short-lived fractions per backend per retention bin,
plus per-suite optimal-composition Pareto frontiers computed by reusing
the ``repro_torch.sweep`` engine across the whole campaign.  Every job
runs on the campaign's torch device (``device=``; ``None`` is the CUDA
device, and the run raises where there is none): the ``gpu`` jobs replay
their caches with the ``cache_replay`` kernels, and every job's compose
and sweep run the policy kernels (``engine="torch"``, the default).

Because every job is cached by content hash, re-runs are incremental
and interrupted campaigns resume: only jobs whose artifact is missing
(or whose key changed) hit a backend again.

Two schedulers share the same plan, cache keys, and artifacts:

* ``scheduler="thread"`` (default) — the in-process pool; right for
  small campaigns, tests, and anything cheap enough that process spawn
  would dominate.
* ``scheduler="process"`` — the distributed path (``repro_torch.cluster``):
  jobs go into a durable lease-based ledger inside the artifact store,
  worker *processes* (`python -m repro_torch worker`, on the device named
  in the store's manifest) drain it with
  heartbeats, and a :class:`CampaignSupervisor` reclaims dead leases,
  requeues with backoff, quarantines poison jobs, and respawns dead
  workers.  One wedged or killed worker costs only its in-flight jobs;
  a killed *campaign* resumes from the ledger.

  PYTHONPATH=src python -m repro_torch campaign \
      --workloads tinyllama_1_1b,polybench-2mm --backends systolic,gpu \
      --jobs 2
  PYTHONPATH=src python -m repro_torch campaign --workloads polybench-2mm \
      --backends systolic,gpu --device cpu          # on the host
  PYTHONPATH=src python -m repro_torch campaign --workloads suite:mlperf \
      --backends systolic,gpu --scheduler process --jobs 8 \
      --cache-dir /tmp/gainsight-cache --out campaign.json
  PYTHONPATH=src python -m repro_torch campaign --status /tmp/gainsight-cache
  PYTHONPATH=src python -m repro_torch campaign --dry-run  # plan only, CI

Cache keys are the JAX package's payload plus ``"package": "repro_torch"``,
so the two packages never share an artifact in one cache directory.  The
engine and the device are not key components: they give the same
artifacts within the engines' contract.

Import contract: planning (``--dry-run``, ``--status``, cache-key
computation) uses only ``repro_torch.workloads`` +
``repro_torch.compose.policies`` (for policy-spec validation) +
``repro_torch.devices`` (for family-axis validation) +
``repro_torch.cluster`` / ``repro_torch.runtime`` (stdlib) + stdlib: it
resolves no device, loads no kernel library and initialises no CUDA
context.  Backends and kernels load only when jobs execute.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import os
import tempfile
import time
import traceback
from typing import Mapping, Sequence

from repro_torch.launch import parse_floats as _floats
from repro_torch.workloads import (canonical_backend, get_workload,
                                   resolve_workloads)

SCHEDULERS = ("thread", "process")

# repro_torch.compose.engine.ENGINES, kept literal so planning stays light
ENGINES = ("numpy", "torch")

PACKAGE = "repro_torch"   # cache-key component: artifacts of this package

SCHEMA_VERSION = 3    # v3: device family (name/version/axes) in the key

# Default retention bins: Si-GCRAM (1 us) and Hybrid-GCRAM (10 us) —
# repro_torch.core.devices values, kept literal so planning stays light.
DEFAULT_RETENTION_BINS = (1.0e-6, 1.0e-5)

# Default sweep axes: the sram-only anchor plus the DEFAULT_DEVICES
# point plus a retention-scaled variant per side — small enough to ride
# along every campaign job, wide enough for a non-degenerate frontier.
DEFAULT_SWEEP_AXES = {"mixes": (0.0, 1.0),
                      "retention_scales": (0.5, 1.0, 2.0),
                      "per_mix": False}


def _bin_label(retention_s: float) -> str:
    return format(retention_s, "g")


@dataclasses.dataclass(frozen=True)
class CampaignJob:
    """One planned (workload, backend) cell with its cache identity."""
    workload: str
    backend: str            # canonical registry name
    key: str                # trace-cache content hash
    params: tuple           # effective spec params (sorted pairs)
    cfg: tuple              # campaign-level backend cfg overrides

    @property
    def label(self) -> str:
        return f"{self.workload}@{self.backend}"


@dataclasses.dataclass(frozen=True)
class _AggPoint:
    """Access-weighted mean of one sweep candidate across a campaign —
    duck-types the SweepPoint interface ``pareto_frontier`` needs."""
    candidate: str
    subpartition: str
    area_vs_sram: float
    energy_vs_sram: float
    n_workloads: int
    policy: str = "refresh-free"
    family: str | None = None

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class CampaignResult:
    """Executed campaign: per-job artifacts + the aggregate report."""
    jobs: list              # CampaignJob, plan order
    artifacts: list         # per-job artifact dicts (None where failed)
    cached: list            # per-job bool: served from the trace cache
    aggregate: dict         # the cross-suite aggregate report
    errors: list = dataclasses.field(default_factory=list)
                            # per-job error string or None, plan order
    metrics: dict | None = None   # CampaignSupervisor.metrics() (process)
    scheduler: str = "thread"
    store_dir: str | None = None  # the shared artifact store (process)

    @property
    def executed(self) -> int:
        return sum(1 for c in self.cached if not c)

    @property
    def cache_hits(self) -> int:
        return sum(1 for c in self.cached if c)

    @property
    def failed(self) -> int:
        return sum(1 for e in self.errors if e)

    def to_json(self) -> dict:
        return self.aggregate

    def csv_rows(self) -> list:
        """``backend,subpartition,retention_s,short_lived_fraction,
        accesses`` rows (header included)."""
        rows = ["backend,subpartition,retention_s,short_lived_fraction,"
                "accesses"]
        for backend, subs in self.aggregate["aggregate"].items():
            for sub, entry in subs.items():
                for label, frac in entry["short_lived"].items():
                    rows.append(f"{backend},{sub},{label},{frac:.9g},"
                                f"{entry['accesses']}")
        return rows


class CampaignRunner:
    """Run workloads x backends with caching and aggregate reporting.

    Parameters
    ----------
    workloads : selector accepted by ``resolve_workloads`` (names,
        ``"all"``, ``"suite:<name>"``).
    backends : backend names/aliases; (workload, backend) cells the
        spec has no lowering for are skipped (recorded in the report).
    jobs : worker threads for the job pool.
    cache_dir : on-disk trace cache; ``None`` disables caching.
    seq : convenience override applied to every spec with a ``seq``
        param.
    params : per-workload param overrides, ``{workload: {k: v}}``.
    backend_cfg : per-backend run kwargs, ``{backend: {k: v}}``
        (merged over the spec's lowering defaults; part of the cache
        key).
    retention_bins : retention targets (seconds) for the aggregate
        short-lived fractions.
    sweep_axes : DeviceGrid axes for the per-job composition sweep
        (``mixes`` / ``retention_scales`` / ``area_scales`` /
        ``energy_scales`` / ``per_mix``), or ``None`` to skip sweeps.
        Ignored when ``family`` is set.
    family : registered device-family name/alias (``repro_torch.devices``);
        swaps the gain-cell ``DeviceGrid`` for a ``FamilyGrid`` in the
        per-job sweep.  The family's name, version, and resolved axes
        are cache-key components.
    family_axes : ``{param: (axis values...)}`` for the family sweep;
        ``None`` uses the family's registered ``default_axes``.
    devices : device set for analyze/compose (names or DeviceModels);
        names only are recorded in the cache key.
    policy : assignment-policy spec for compose() and the per-job
        sweep (``repro_torch.compose.get_policy`` grammar); the canonical
        policy name is a cache-key component, so changing policy never
        reuses another policy's artifacts.
    engine : composition evaluation backend, ``"torch"`` (default: the
        policy kernels on ``device``, capacity exact and energy within
        1e-9 relative of the oracle) or ``"numpy"`` (the host oracle).
        Deliberately *not* a cache-key component: both engines produce
        the same artifacts within that contract, so cached results are
        reusable across engines.
    device : torch device every job runs on; ``None`` is the CUDA device
        (resolved when jobs execute, never while planning; raises where
        there is none).  Process workers read it from the store's
        manifest.  Not a cache-key component.
    scheduler : ``"thread"`` (in-process pool) or ``"process"``
        (lease-based worker processes over a shared artifact store —
        see ``repro_torch.cluster``).
    lease_ttl_s : process scheduler only — seconds without a heartbeat
        before a worker's lease is reclaimed and its job requeued.
    max_retries : process scheduler only — requeues (failures *or*
        lease expiries) before a job is quarantined as poison.
    """

    #: how long a thread-pool job waits on a contended per-key write
    #: lock (another invocation computing the same key) before giving
    #: up and computing it anyway; put() stays clobber-safe either way.
    write_lock_wait_s = 600.0

    def __init__(self, workloads, backends: Sequence[str], *,
                 jobs: int = 1, cache_dir: str | None = None,
                 seq: int | None = None,
                 params: Mapping[str, Mapping] | None = None,
                 backend_cfg: Mapping[str, Mapping] | None = None,
                 retention_bins: Sequence[float] = DEFAULT_RETENTION_BINS,
                 sweep_axes: Mapping | None = DEFAULT_SWEEP_AXES,
                 family: str | None = None,
                 family_axes: Mapping | None = None,
                 devices: Sequence[str] | None = None,
                 policy: str = "refresh-free",
                 engine: str = "torch",
                 device=None,
                 scheduler: str = "thread",
                 lease_ttl_s: float = 30.0,
                 max_retries: int = 3):
        from repro_torch.compose.policies import get_policy
        self.workloads = resolve_workloads(workloads)
        self.policy = get_policy(policy).name    # canonical, validated
        if engine not in ENGINES:
            raise ValueError(
                f"engine must be one of {ENGINES}, got {engine!r}")
        self.engine = engine
        self.device = device
        self.backends = tuple(dict.fromkeys(
            canonical_backend(b.strip()) for b in (
                backends.split(",") if isinstance(backends, str)
                else backends)))
        self.jobs = max(1, int(jobs))
        self.cache_dir = cache_dir
        self.seq = seq
        self.params = {k: dict(v) for k, v in (params or {}).items()}
        self.backend_cfg = {canonical_backend(k): dict(v)
                            for k, v in (backend_cfg or {}).items()}
        self.retention_bins = tuple(float(b) for b in retention_bins)
        if not self.retention_bins:
            raise ValueError("retention_bins must be non-empty")
        self.sweep_axes = dict(sweep_axes) if sweep_axes else None
        self.family = None
        self.family_axes = None
        self._family_version = None
        if family is not None:
            from repro_torch.devices import get_device_family
            fam = get_device_family(family)     # validates; stdlib-only
            self.family = fam.name
            self._family_version = fam.version
            raw = (family_axes if family_axes is not None
                   else fam.default_axes)
            axes = {}
            for k, vals in raw.items():
                p = fam.param_dict.get(k)
                if p is None:
                    raise ValueError(
                        f"device family {fam.name!r} has no parameter "
                        f"{k!r}; available: {sorted(fam.param_dict)}")
                axes[k] = tuple(p.coerce(v) for v in vals)
            self.family_axes = axes
        elif family_axes:
            raise ValueError("family_axes requires family")
        self.devices = tuple(devices) if devices is not None else None
        if scheduler not in SCHEDULERS:
            raise ValueError(f"scheduler must be one of {SCHEDULERS}, "
                             f"got {scheduler!r}")
        self.scheduler = scheduler
        self.lease_ttl_s = float(lease_ttl_s)
        self.max_retries = int(max_retries)
        self.skipped: list = []      # (workload, backend) without lowering

    def torch_device(self):
        """The torch device the jobs run on: ``device=None`` is the CUDA
        device; a CUDA device raises where there is none."""
        from repro_torch.device import default_device, resolve_device
        dev = resolve_device(self.device)
        if dev.type == "cuda":
            default_device()             # raises without a CUDA device
        return dev

    # ------------------------------------------------------------------
    # planning / cache keys
    # ------------------------------------------------------------------
    def _spec_for(self, workload: str):
        spec = get_workload(workload)
        overrides = dict(self.params.get(workload, {}))
        if self.seq is not None and "seq" in spec.param_dict:
            overrides.setdefault("seq", self.seq)
        return spec.with_params(**overrides) if overrides else spec

    def _key(self, spec, backend: str) -> str:
        payload = {
            "package": PACKAGE,
            "schema": SCHEMA_VERSION,
            "workload": spec.content_hash(),
            "backend": backend,
            "cfg": self.backend_cfg.get(backend, {}),
            "devices": list(self.devices) if self.devices else None,
            "retention_bins": list(self.retention_bins),
            "sweep": self.sweep_axes,
            "family": ({"name": self.family,
                        "version": self._family_version,
                        "axes": self.family_axes}
                       if self.family else None),
            "policy": self.policy,
        }
        return hashlib.sha256(
            json.dumps(payload, sort_keys=True,
                       default=repr).encode()).hexdigest()

    def plan(self) -> list:
        """The job list (no backend work): one ``CampaignJob`` per
        supported (workload, backend) cell, in deterministic order."""
        out = []
        self.skipped = []
        for name in self.workloads:
            spec = self._spec_for(name)
            for backend in self.backends:
                if not spec.supports(backend):
                    self.skipped.append((name, backend))
                    continue
                out.append(CampaignJob(
                    workload=name, backend=backend,
                    key=self._key(spec, backend), params=spec.params,
                    cfg=tuple(sorted(
                        self.backend_cfg.get(backend, {}).items()))))
        return out

    def _cache_path(self, job: CampaignJob) -> str | None:
        if not self.cache_dir:
            return None
        return os.path.join(self.cache_dir, f"{job.key}.json")

    def is_cached(self, job: CampaignJob) -> bool:
        path = self._cache_path(job)
        return bool(path) and os.path.exists(path)

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def _execute(self, job: CampaignJob) -> dict:
        """Run one (workload, backend) cell through the full pipeline
        and shape the cacheable artifact."""
        from repro_torch.core import ProfileSession
        spec = self._spec_for(job.workload)
        workload, cfg = spec.build(job.backend)
        cfg = {**cfg, **dict(job.cfg)}
        session = ProfileSession(job.backend, devices=self.devices,
                                 device=self.torch_device())
        session.profile(workload, **cfg).analyze()
        session.compose(policy=self.policy, engine=self.engine)
        report = session.report()

        short_lived: dict = {}
        accesses: dict = {}
        for sub, entry in report["subpartitions"].items():
            accesses[sub] = int(entry["n_reads"]) + int(entry["n_writes"])
            short_lived[sub] = {
                _bin_label(b): float(session.short_lived_fraction(sub, b))
                for b in self.retention_bins}

        sweep_points: list = []
        if self.family or self.sweep_axes:
            if self.family:
                from repro_torch.sweep import FamilyGrid
                grid = FamilyGrid(self.family, axes=self.family_axes)
            else:
                from repro_torch.sweep import DeviceGrid
                grid = DeviceGrid(**self.sweep_axes)
            result = session.sweep(grid, attach=False,
                                   policy=self.policy,
                                   engine=self.engine)
            sweep_points = [
                {"candidate": p.candidate,
                 "subpartition": p.subpartition,
                 "policy": p.policy,
                 "family": p.family,
                 "area_vs_sram": float(p.area_vs_sram),
                 "energy_vs_sram": float(p.energy_vs_sram)}
                for p in result.points]

        artifact = {"schema": SCHEMA_VERSION, "key": job.key,
                    "workload": job.workload, "backend": job.backend,
                    "params": dict(job.params), "cfg": dict(job.cfg),
                    "policy": self.policy,
                    "report": report, "accesses": accesses,
                    "short_lived": short_lived,
                    "sweep_points": sweep_points}
        return artifact

    def job_for_key(self, key: str) -> CampaignJob:
        """The planned job with this cache key (workers rebuild jobs
        from ledger records this way)."""
        for job in self.plan():
            if job.key == key:
                return job
        raise KeyError(f"no planned job has cache key {key[:12]}..; "
                       "the store manifest and ledger disagree")

    def _run_job(self, job: CampaignJob) -> tuple:
        """(artifact | None, cached, error | None) for one job.

        A job that raises is *recorded*, not propagated: one bad
        workload must never abort the other N-1 cells of a campaign.
        Writes go through the shared :class:`ArtifactStore`, so two
        invocations racing on one cache directory neither clobber nor
        double-bill: the loser of the write lock waits for the winner's
        artifact, and ``put`` is write-if-absent regardless.
        """
        if not self.cache_dir:
            try:
                return self._execute(job), False, None
            except Exception:            # noqa: BLE001 - recorded per-job
                return None, False, traceback.format_exc(limit=20)
        from repro_torch.cluster import ArtifactStore
        store = ArtifactStore(self.cache_dir)
        artifact = store.load(job.key)
        if artifact is not None:
            return artifact, True, None
        owner = f"campaign-{os.getpid()}"
        got_lock = store.acquire_write_lock(job.key, owner)
        if not got_lock:                 # another invocation is computing
            artifact = store.wait_for(job.key,
                                      timeout_s=self.write_lock_wait_s)
            if artifact is not None:
                return artifact, True, None
        try:
            artifact = self._execute(job)
            if not store.put(job.key, artifact):
                artifact = store.load(job.key)   # racer won: canonical copy
            return artifact, False, None
        except Exception:                # noqa: BLE001 - recorded per-job
            return None, False, traceback.format_exc(limit=20)
        finally:
            if got_lock:
                store.release_write_lock(job.key)

    def run(self) -> CampaignResult:
        self.torch_device()              # raises where the device is missing
        jobs = self.plan()
        if self.scheduler == "process":
            return self._run_process(jobs)
        if self.jobs == 1 or len(jobs) <= 1:
            results = [self._run_job(j) for j in jobs]
        else:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=self.jobs) as pool:
                results = list(pool.map(self._run_job, jobs))
        artifacts = [a for a, _, _ in results]
        cached = [c for _, c, _ in results]
        errors = [e for _, _, e in results]
        aggregate = self._aggregate(jobs, artifacts, cached,
                                    errors=errors)
        return CampaignResult(jobs=jobs, artifacts=artifacts,
                              cached=cached, aggregate=aggregate,
                              errors=errors, scheduler="thread",
                              store_dir=self.cache_dir)

    # ------------------------------------------------------------------
    # the process scheduler (repro_torch.cluster)
    # ------------------------------------------------------------------
    def manifest(self) -> dict:
        """The JSON round-trippable runner config workers rebuild from
        (``campaign.json`` in the store), with the resolved torch device
        the workers run on."""
        if self.devices is not None and \
                not all(isinstance(d, str) for d in self.devices):
            raise ValueError(
                "scheduler='process' needs device *names* (workers "
                "re-resolve them); got DeviceModel objects")
        return {"schema": SCHEMA_VERSION,
                "workloads": list(self.workloads),
                "backends": list(self.backends),
                "seq": self.seq,
                "params": self.params,
                "backend_cfg": self.backend_cfg,
                "retention_bins": list(self.retention_bins),
                "sweep_axes": self.sweep_axes,
                "family": self.family,
                "family_axes": self.family_axes,
                "devices": list(self.devices) if self.devices else None,
                "policy": self.policy,
                "engine": self.engine,
                "device": str(self.torch_device()),
                "lease_ttl_s": self.lease_ttl_s,
                "max_retries": self.max_retries}

    def prepare_store(self, jobs=None):
        """Create/refresh the shared store for this campaign: write the
        manifest and submit the plan to the ledger (idempotent — known
        keys are untouched, so re-preparing an interrupted campaign
        resumes it).  Returns ``(store, ledger, n_new_jobs)``.  After
        this, any ``python -m repro_torch worker --store <dir>`` can
        help."""
        from repro_torch.cluster import ArtifactStore, JobLedger
        from repro_torch.runtime.fault_tolerance import RetryPolicy
        if not self.cache_dir:
            self.cache_dir = tempfile.mkdtemp(prefix="gainsight-campaign-")
        store = ArtifactStore(self.cache_dir)
        store.write_manifest(self.manifest())
        ledger = JobLedger(
            store, lease_ttl_s=self.lease_ttl_s,
            retry=RetryPolicy(max_retries=self.max_retries))
        n_new = ledger.submit(jobs if jobs is not None else self.plan())
        return store, ledger, n_new

    def _spawn_worker(self, index: int, store_dir: str):
        """One worker subprocess (`python -m repro_torch worker`) against
        the shared store, with this package's source root as its only
        ``PYTHONPATH`` entry."""
        import subprocess
        import sys

        import repro_torch
        src_root = os.path.dirname(os.path.dirname(
            os.path.abspath(repro_torch.__file__)))
        env = dict(os.environ)
        env["PYTHONPATH"] = src_root
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch", "worker",
             "--store", store_dir,
             "--worker-id", f"w{index}-{os.getpid()}",
             "--lease-ttl", str(self.lease_ttl_s),
             "--max-retries", str(self.max_retries)],
            env=env)

    def _run_process(self, jobs) -> CampaignResult:
        """Ledger-scheduled execution with worker processes + the
        :class:`CampaignSupervisor` reclaimer."""
        from repro_torch.runtime.fault_tolerance import CampaignSupervisor
        store, ledger, _ = self.prepare_store(jobs)
        already_done = {k for k, r in ledger.snapshot().items()
                        if r.state == "done"}
        n_pending = sum(1 for j in jobs if j.key not in already_done)

        supervisor = CampaignSupervisor(
            ledger, spawn_worker=lambda i: self._spawn_worker(
                i, store.root),
            max_respawns=max(2, self.jobs),
            poll_s=min(1.0, max(0.05, self.lease_ttl_s / 4.0)))
        if n_pending:
            for i in range(max(1, min(self.jobs, n_pending))):
                supervisor.add_worker(self._spawn_worker(i, store.root))
            try:
                supervisor.run()
            finally:
                # the supervisor's list holds the respawned workers too
                self._drain_workers(supervisor.workers)
        sup_metrics = supervisor.metrics()
        sup_metrics["worker_exit_codes"] = [w.poll()
                                            for w in supervisor.workers]

        records = ledger.snapshot()
        artifacts, cached, errors = [], [], []
        for job in jobs:
            rec = records.get(job.key)
            artifact = store.load(job.key)
            if rec is not None and rec.state == "done" \
                    and artifact is not None:
                artifacts.append(artifact)
                cached.append(job.key in already_done or rec.cache_hit)
                errors.append(None)
            else:
                artifacts.append(None)
                cached.append(False)
                errors.append((rec.error if rec is not None else None)
                              or "no artifact produced")
        job_metrics = {k: v for k, v in sup_metrics["jobs"].items()}
        aggregate = self._aggregate(jobs, artifacts, cached,
                                    errors=errors,
                                    job_metrics=job_metrics,
                                    supervision=sup_metrics)
        return CampaignResult(jobs=jobs, artifacts=artifacts,
                              cached=cached, aggregate=aggregate,
                              errors=errors, metrics=sup_metrics,
                              scheduler="process",
                              store_dir=store.root)

    @staticmethod
    def _drain_workers(workers, timeout_s: float = 15.0) -> None:
        """Workers exit on their own once the ledger drains; reap them,
        then terminate any that linger (e.g. after a supervisor error)."""
        deadline = time.monotonic() + timeout_s
        for w in workers:
            if w.poll() is None:
                try:
                    w.wait(timeout=max(0.1, deadline - time.monotonic()))
                except Exception:        # noqa: BLE001 - force below
                    pass
        for w in workers:
            if w.poll() is None:
                w.terminate()
                try:
                    w.wait(timeout=5.0)
                except Exception:        # noqa: BLE001 - last resort
                    w.kill()

    # ------------------------------------------------------------------
    # the cross-suite aggregate frontend
    # ------------------------------------------------------------------
    def _aggregate(self, jobs, artifacts, cached, *, errors=None,
                   job_metrics=None, supervision=None) -> dict:
        errors = errors or [None] * len(jobs)
        bins = [_bin_label(b) for b in self.retention_bins]
        # backend -> sub -> accumulators (failed jobs contribute nothing)
        acc: dict = {}
        for art in artifacts:
            if art is None:
                continue
            slot = acc.setdefault(art["backend"], {})
            for sub, n in art["accesses"].items():
                e = slot.setdefault(sub, {
                    "accesses": 0,
                    "weighted": {b: 0.0 for b in bins},
                    "per_workload": {}})
                e["accesses"] += n
                fracs = art["short_lived"][sub]
                for b in bins:
                    e["weighted"][b] += fracs.get(b, 0.0) * n
                e["per_workload"][art["workload"]] = {
                    "accesses": n,
                    "short_lived": {b: fracs.get(b) for b in bins}}

        agg: dict = {}
        for backend, subs in acc.items():
            agg[backend] = {}
            for sub, e in subs.items():
                total = e["accesses"]
                agg[backend][sub] = {
                    "accesses": total,
                    "short_lived": {
                        b: (e["weighted"][b] / total if total else 0.0)
                        for b in bins},
                    "per_workload": e["per_workload"]}

        job_rows = []
        for j, a, c, e in zip(jobs, artifacts, cached, errors):
            row = {"workload": j.workload, "backend": j.backend,
                   "key": j.key, "cached": c,
                   "accesses": sum(a["accesses"].values()) if a else 0}
            if e:
                row["error"] = e
            if job_metrics and j.key in job_metrics:
                row["metrics"] = job_metrics[j.key]
            job_rows.append(row)

        campaign = {
            "workloads": list(self.workloads),
            "backends": list(self.backends),
            "policy": self.policy,
            "family": self.family,
            "scheduler": self.scheduler,
            "retention_bins_s": list(self.retention_bins),
            "n_jobs": len(jobs),
            "executed": sum(1 for c in cached if not c),
            "cache_hits": sum(1 for c in cached if c),
            "failed": sum(1 for e in errors if e),
            "cache_dir": self.cache_dir,
            "skipped": [list(s) for s in self.skipped],
        }
        if supervision is not None:
            campaign["lease_ttl_s"] = self.lease_ttl_s
            campaign["max_retries"] = self.max_retries
            campaign["supervision"] = {
                k: supervision[k] for k in
                ("reclaimed_leases", "worker_deaths", "worker_respawns",
                 "straggler_flags")}

        return {
            "schema": SCHEMA_VERSION,
            "campaign": campaign,
            "jobs": job_rows,
            "aggregate": agg,
            "suite_frontiers": self._suite_frontiers(artifacts),
        }

    def _suite_frontiers(self, artifacts) -> dict:
        """Per-(backend, subpartition) Pareto frontiers of the
        access-weighted mean sweep points across the whole campaign —
        the sweep engine's reduction reused at suite level."""
        if not (self.sweep_axes or self.family):
            return {}
        # (backend, sub, candidate) -> [w_area, w_energy, weight, n]
        cells: dict = {}
        families: dict = {}
        for art in artifacts:
            if art is None:
                continue
            for p in art.get("sweep_points", ()):
                w = art["accesses"].get(p["subpartition"], 0)
                area, energy = p["area_vs_sram"], p["energy_vs_sram"]
                if w <= 0 or not math.isfinite(area) \
                        or not math.isfinite(energy):
                    continue
                k = (art["backend"], p["subpartition"], p["candidate"])
                c = cells.setdefault(k, [0.0, 0.0, 0.0, 0])
                c[0] += area * w
                c[1] += energy * w
                c[2] += w
                c[3] += 1
                families.setdefault(k, p.get("family"))
        groups: dict = {}
        for (backend, sub, cand), (wa, we, w, n) in cells.items():
            groups.setdefault((backend, sub), []).append(_AggPoint(
                candidate=cand, subpartition=sub,
                area_vs_sram=wa / w, energy_vs_sram=we / w,
                n_workloads=n, policy=self.policy,
                family=families.get((backend, sub, cand))))
        if not groups:
            return {}
        from repro_torch.sweep.pareto import pareto_frontier
        return {f"{backend}/{sub}": pareto_frontier(pts).asdict()
                for (backend, sub), pts in sorted(groups.items())}


# ---------------------------------------------------------------------------
# key-free facts: one campaign held against another (other package, device
# or engine)
# ---------------------------------------------------------------------------

def campaign_facts(artifacts, aggregate: dict) -> dict:
    """What a campaign computed, without its cache keys: per job
    (``workload@backend``) the accesses and short-lived fractions per
    subpartition, the composition's capacity fractions and the sweep
    points' ``(candidate, subpartition, area_vs_sram, energy_vs_sram)``;
    and the cross-suite aggregate's accesses and short-lived fractions.
    ``artifacts`` may hold ``None`` for failed jobs (they are left out)."""
    jobs = {}
    for art in artifacts:
        if art is None:
            continue
        subs = art["report"]["subpartitions"]
        jobs[f"{art['workload']}@{art['backend']}"] = {
            "accesses": art["accesses"],
            "short_lived": art["short_lived"],
            "capacity_fractions": {
                sub: subs[sub]["composition"]["capacity_fractions"]
                for sub in art["accesses"]},
            "sweep_points": [
                [p["candidate"], p["subpartition"], p["area_vs_sram"],
                 p["energy_vs_sram"]] for p in art["sweep_points"]]}
    agg = {backend: {sub: {"accesses": e["accesses"],
                           "short_lived": e["short_lived"]}
                     for sub, e in subs.items()}
           for backend, subs in aggregate["aggregate"].items()}
    return {"jobs": jobs, "aggregate": agg}


def compare_campaign_facts(got: dict, want: dict, *,
                           rtol: float = 1e-9) -> float:
    """Hold ``got`` to ``want`` (both :func:`campaign_facts`): the same
    jobs, accesses, short-lived fractions (ratios of integer counts) and
    capacity fractions exactly, sweep candidates in the same order, and
    each point's area and energy within ``rtol`` relative.  Returns the
    worst relative error of those floats; raises ``ValueError`` naming the
    first fact that differs."""
    def differ(what, g, w):
        raise ValueError(f"campaign facts differ at {what}: {g!r} != {w!r}")

    if sorted(got["jobs"]) != sorted(want["jobs"]):
        differ("jobs", sorted(got["jobs"]), sorted(want["jobs"]))
    worst = 0.0
    for label, w in want["jobs"].items():
        g = got["jobs"][label]
        for fact in ("accesses", "short_lived", "capacity_fractions"):
            if g[fact] != w[fact]:
                differ(f"{label} {fact}", g[fact], w[fact])
        if [p[:2] for p in g["sweep_points"]] != \
                [p[:2] for p in w["sweep_points"]]:
            differ(f"{label} sweep candidates", g["sweep_points"],
                   w["sweep_points"])
        for pg, pw in zip(g["sweep_points"], w["sweep_points"]):
            for i, name in ((2, "area_vs_sram"), (3, "energy_vs_sram")):
                if pg[i] == pw[i] or (math.isnan(pg[i])
                                      and math.isnan(pw[i])):
                    continue
                err = abs(pg[i] - pw[i]) / max(abs(pw[i]), 1e-300)
                if not err <= rtol:
                    differ(f"{label} {pg[0]}/{pg[1]} {name}", pg[i], pw[i])
                worst = max(worst, err)
    if got["aggregate"] != want["aggregate"]:
        differ("aggregate", got["aggregate"], want["aggregate"])
    return worst


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def print_status(store_dir: str) -> dict:
    """``--status DIR``: the ledger state of an in-flight, interrupted,
    or finished campaign — stdlib-only, safe to run alongside workers."""
    from repro_torch.cluster import ArtifactStore, JobLedger
    if not os.path.isdir(store_dir):
        raise SystemExit(f"no campaign store at {store_dir}")
    store = ArtifactStore(store_dir)
    ledger = JobLedger(store)
    records = ledger.snapshot()
    counts = {"pending": 0, "leased": 0, "done": 0, "quarantined": 0}
    now = time.time()

    print(f"campaign store {store_dir}: {len(records)} job(s)")
    print(f"{'key':14s} {'job':30s} {'state':12s} {'worker':18s} "
          f"{'leases':>6s} {'retries':>7s} {'wait s':>7s} {'run s':>7s} "
          f"{'hit'}")
    for key, rec in records.items():
        counts[rec.state] = counts.get(rec.state, 0) + 1
        wait = rec.queue_wait_s
        extra = ""
        if rec.state == "leased":
            try:
                age = now - os.stat(os.path.join(
                    store.lease_dir, f"{key}.json")).st_mtime
                extra = f"  heartbeat {age:.1f}s ago"
            except OSError:
                extra = "  (no lease record)"
        print(f"{key[:12] + '..':14s} "
              f"{rec.workload + '@' + rec.backend:30s} "
              f"{rec.state:12s} {str(rec.worker or '-'):18s} "
              f"{rec.leases:6d} {rec.attempts:7d} "
              f"{('%.2f' % wait) if wait is not None else '-':>7s} "
              f"{('%.2f' % rec.runtime_s) if rec.runtime_s is not None else '-':>7s} "
              f"{'yes' if rec.cache_hit else 'no'}{extra}")
        if rec.error:
            first = rec.error.strip().splitlines()[-1]
            print(f"{'':14s} last error: {first[:100]}")
    total = len(records)
    print(f"status: {counts['done']}/{total} done, "
          f"{counts['leased']} leased, {counts['pending']} pending, "
          f"{counts['quarantined']} quarantined")
    return {"counts": counts,
            "jobs": {k: r.metrics() for k, r in records.items()}}


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="repro_torch campaign",
        description="multi-workload x multi-backend profiling campaign "
                    "with an on-disk trace cache and a cross-suite "
                    "aggregate report")
    ap.add_argument("--workloads", default="tinyllama_1_1b,polybench-2mm",
                    help="comma-separated workload names, 'all', or "
                         "'suite:<name>' (see `python -m repro_torch "
                         "workloads`)")
    ap.add_argument("--backends", default="systolic,gpu",
                    help="comma-separated backend names/aliases")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker threads (scheduler=thread) or worker "
                         "processes (scheduler=process)")
    ap.add_argument("--scheduler", default="thread", choices=SCHEDULERS,
                    help="thread: in-process pool (small campaigns, "
                         "tests); process: lease-based worker processes "
                         "over a shared artifact store — survives "
                         "worker crashes and resumes from the ledger")
    ap.add_argument("--lease-ttl", type=float, default=30.0,
                    help="process scheduler: seconds without a "
                         "heartbeat before a worker's lease is "
                         "reclaimed and its job requeued")
    ap.add_argument("--max-retries", type=int, default=3,
                    help="process scheduler: requeues (failures or "
                         "expiries) before a job is quarantined")
    ap.add_argument("--status", default=None, metavar="DIR",
                    help="print the job-ledger state of the campaign "
                         "store at DIR (works on in-flight and "
                         "interrupted campaigns) and exit")
    ap.add_argument("--cache-dir", default=".gainsight-cache",
                    help="on-disk trace cache (content-hash keyed); "
                         "'' disables caching")
    ap.add_argument("--seq", type=int, default=None,
                    help="override the seq param of every workload "
                         "that has one")
    ap.add_argument("--pe", type=int, default=128,
                    help="systolic array rows=cols")
    ap.add_argument("--dataflow", default="ws", choices=["is", "ws", "os"])
    ap.add_argument("--retention-bins", default="1e-6,1e-5",
                    help="retention targets (s) for the aggregate "
                         "short-lived fractions")
    ap.add_argument("--mixes", default="0,1",
                    help="sweep axis: Si<->Hybrid interpolation points")
    ap.add_argument("--retention-scales", default="0.5,1,2",
                    help="sweep axis: retention scale factors")
    ap.add_argument("--no-sweep", action="store_true",
                    help="skip the per-job composition sweep (no suite "
                         "frontiers)")
    ap.add_argument("--family", default=None,
                    help="sweep a registered device family instead of "
                         "the gain-cell grid (see `python -m repro_torch "
                         "devices`); family name/version/axes enter the "
                         "trace-cache key")
    ap.add_argument("--family-param", action="append", default=None,
                    metavar="K=V1,V2",
                    help="family parameter axis (repeatable); defaults "
                         "to the family's registered axes")
    ap.add_argument("--policy", default="refresh-free",
                    help="assignment policy for compose() and the "
                         "per-job sweep: refresh-free | refresh-aware | "
                         "bank-quantized[:<base>][@<n_banks>] (part of "
                         "the trace-cache key)")
    ap.add_argument("--engine", default="torch", choices=ENGINES,
                    help="composition evaluation backend (torch, the "
                         "default, runs the policy kernels on --device; "
                         "numpy is the host oracle; not a cache-key "
                         "component)")
    ap.add_argument("--device", default=None,
                    help="torch device every job runs on (default: the "
                         "CUDA device; fails without one; 'cpu' for the "
                         "host); workers of the process scheduler run "
                         "there too")
    ap.add_argument("--out", default=None,
                    help="aggregate JSON path (default: "
                         "<cache-dir>/campaign_report.json)")
    ap.add_argument("--csv", default=None, help="aggregate CSV path")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the job plan (cache keys + hit/miss) "
                         "and exit without running any backend")
    args = ap.parse_args(argv)

    if args.status:
        print_status(args.status)
        return None

    sweep_axes = None if (args.no_sweep or args.family) else {
        "mixes": _floats(args.mixes),
        "retention_scales": _floats(args.retention_scales),
        "per_mix": False,
    }
    family_axes = None
    if args.family:
        if args.no_sweep:
            raise SystemExit("--family conflicts with --no-sweep")
        if args.family_param:
            from repro_torch.devices import (get_device_family,
                                             parse_family_params)
            family_axes = parse_family_params(
                args.family_param, get_device_family(args.family))
    elif args.family_param:
        raise SystemExit("--family-param requires --family")
    runner = CampaignRunner(
        args.workloads, args.backends, jobs=args.jobs,
        cache_dir=args.cache_dir or None, seq=args.seq,
        backend_cfg={"systolic": {"rows": args.pe, "cols": args.pe,
                                  "dataflow": args.dataflow}},
        retention_bins=_floats(args.retention_bins),
        sweep_axes=sweep_axes, family=args.family,
        family_axes=family_axes, policy=args.policy,
        engine=args.engine, device=args.device,
        scheduler=args.scheduler, lease_ttl_s=args.lease_ttl,
        max_retries=args.max_retries)

    jobs = runner.plan()
    if args.dry_run:
        fam_tag = f" family={runner.family}" if runner.family else ""
        print(f"campaign plan: policy={runner.policy}{fam_tag} "
              f"scheduler={runner.scheduler}")
        print(f"{'workload':22s} {'backend':10s} {'cache key':14s} "
              f"{'state'}")
        for job in jobs:
            state = "cached" if runner.is_cached(job) else "pending"
            print(f"{job.workload:22s} {job.backend:10s} "
                  f"{job.key[:12]}.. {state}")
        for wl, backend in runner.skipped:
            print(f"{wl:22s} {backend:10s} {'-':14s} no lowering "
                  "(skipped)")
        print(f"campaign dry-run ok: {len(jobs)} job(s), "
              f"{sum(runner.is_cached(j) for j in jobs)} cached, "
              f"{len(runner.skipped)} unsupported")
        return {"jobs": [job.label for job in jobs],
                "skipped": [list(s) for s in runner.skipped]}

    result = runner.run()
    agg = result.aggregate

    failed = f", {result.failed} FAILED" if result.failed else ""
    print(f"campaign: {len(jobs)} job(s), {result.executed} executed, "
          f"{result.cache_hits} from cache{failed} "
          f"({runner.scheduler} scheduler, {args.jobs} worker(s), "
          f"cache={runner.cache_dir})")
    for job, err in zip(result.jobs, result.errors):
        if err:
            last = err.strip().splitlines()[-1]
            print(f"  FAILED {job.label}: {last[:120]}")
    bins = [_bin_label(b) for b in runner.retention_bins]
    head = " ".join(f"{'<=' + b + 's':>12s}" for b in bins)
    print(f"\n{'backend/subpartition':28s} {'accesses':>10s} {head}")
    for backend, subs in agg["aggregate"].items():
        for sub, entry in subs.items():
            cells = " ".join(
                f"{100 * entry['short_lived'][b]:11.1f}%" for b in bins)
            print(f"{backend + '/' + sub:28s} "
                  f"{entry['accesses']:>10d} {cells}")
    for key, frontier in agg["suite_frontiers"].items():
        best = frontier["points"][0] if frontier["points"] else None
        if best:
            print(f"suite frontier {key}: {len(frontier['points'])} "
                  f"point(s); best area "
                  f"{100 * best['area_vs_sram']:.1f}% / energy "
                  f"{100 * best['energy_vs_sram']:.1f}% vs SRAM "
                  f"({best['candidate']})")

    out = args.out
    if out is None and runner.cache_dir:
        out = os.path.join(runner.cache_dir, "campaign_report.json")
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(agg, f, indent=2, default=repr)
        print(f"\naggregate json -> {out}")
    if args.csv:
        with open(args.csv, "w") as f:
            f.write("\n".join(result.csv_rows()) + "\n")
        print(f"aggregate csv -> {args.csv}")
    return agg


if __name__ == "__main__":
    main()
