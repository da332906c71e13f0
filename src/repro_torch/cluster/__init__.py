"""Distributed campaign scheduler: queue, leases, shared artifacts.

A campaign is N workloads x M backends with no data flowing between jobs.
This package runs it from one shared directory:

  ArtifactStore  - the on-disk trace cache as a multi-writer artifact
                   store (write-if-absent puts published by ``os.link``,
                   O_EXCL write locks, stale-lock breaking)
  JobLedger      - durable JSONL job queue with atomic lock-protected
                   transitions, time-bounded worker leases whose
                   heartbeat is the lease record's mtime, exponential
                   backoff requeue and poison-job quarantine
                   (RetryPolicy from repro_torch.runtime.fault_tolerance)
  run_worker     - the worker-process loop (``python -m repro_torch
                   worker``)

The supervisor half (lease reclaim, worker respawn, per-job metrics) lives
in :class:`repro_torch.runtime.fault_tolerance.CampaignSupervisor`;
``repro_torch.launch.campaign`` wires it all behind
``CampaignRunner(scheduler="process")``.

Import contract: stdlib-only at import time (workers import the backend
stack only when a job executes), so campaign planning, ``--dry-run`` and
``--status`` load no kernel library and initialise no CUDA context.
"""

from repro_torch.cluster.ledger import (DEFAULT_LEASE_TTL_S, JobLedger,
                                        JobRecord, default_worker_id)
from repro_torch.cluster.store import ArtifactStore
from repro_torch.cluster.worker import run_worker, runner_from_manifest

__all__ = ["ArtifactStore", "JobLedger", "JobRecord",
           "DEFAULT_LEASE_TTL_S", "default_worker_id", "run_worker",
           "runner_from_manifest"]
