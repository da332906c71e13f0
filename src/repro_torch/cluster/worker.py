"""Campaign worker: lease jobs from a store, run them, write artifacts.

One worker == one process.  ``CampaignRunner`` spawns a pool of these
(``scheduler="process"``), but a worker is also a standalone CLI —

    PYTHONPATH=src python -m repro_torch worker --store .gainsight-cache

— so extra machines (or a second terminal) can join an in-flight
campaign by pointing at the same directory: the ledger's lease protocol
makes that safe, and the worker reads everything else it needs from the
store's ``campaign.json`` manifest — the campaign's torch device included:
a worker runs where the campaign runs, and raises before it leases a job
when that device is missing (it never drops to the CPU).

Loop: acquire a lease -> (artifact already in store? complete as a
cache hit) -> rebuild the job from the manifest, execute it through the
``ProfileSession`` path (`CampaignRunner._execute`), put the artifact
write-if-absent, complete the lease.  A background thread heartbeats
the lease record every TTL/4 while the job runs; if the heartbeat
discovers the lease was reclaimed (the ledger decided we were dead),
the result is abandoned — the re-execution's artifact is canonical, and
``ArtifactStore.put`` is write-if-absent so nothing clobbers anyway.

Exceptions fail the lease: the ledger requeues with backoff, then
quarantines after the retry budget (poison-job detection).  The worker
itself keeps going — one bad job never takes the pool down.

Fault injection (tests only): ``GAINSIGHT_WORKER_FAULT="sleep-after-acquire:S"``
sleeps S seconds between leasing a job and executing it, giving kill
tests a deterministic mid-job window.
"""

from __future__ import annotations

import argparse
import os
import threading
import time
import traceback

from repro_torch.cluster.ledger import (DEFAULT_LEASE_TTL_S, JobLedger,
                                        default_worker_id)
from repro_torch.cluster.store import ArtifactStore
from repro_torch.runtime.fault_tolerance import RetryPolicy

_FAULT_ENV = "GAINSIGHT_WORKER_FAULT"


def runner_from_manifest(manifest: dict, store_dir: str):
    """Reconstruct the campaign's ``CampaignRunner`` (thread scheduler,
    jobs=1 — the worker *is* the parallelism) from a store manifest.
    Raises where the manifest's device is missing (``device.py``)."""
    from repro_torch.launch.campaign import CampaignRunner
    runner = CampaignRunner(
        manifest["workloads"], manifest["backends"], jobs=1,
        cache_dir=store_dir, seq=manifest.get("seq"),
        params=manifest.get("params") or None,
        backend_cfg=manifest.get("backend_cfg") or None,
        retention_bins=manifest["retention_bins"],
        sweep_axes=manifest.get("sweep_axes"),
        family=manifest.get("family"),
        family_axes=manifest.get("family_axes"),
        devices=manifest.get("devices"),
        policy=manifest.get("policy", "refresh-free"),
        engine=manifest.get("engine", "torch"),
        device=manifest["device"])
    runner.torch_device()
    return runner


class _Heartbeat:
    """Touches the lease record every ttl/4 while a job executes."""

    def __init__(self, ledger: JobLedger, key: str, worker: str):
        self.ledger = ledger
        self.key = key
        self.worker = worker
        self.lost = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        period = max(0.05, self.ledger.lease_ttl_s / 4.0)
        while not self._stop.wait(period):
            if not self.ledger.heartbeat(self.key, self.worker):
                self.lost = True
                return

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5.0)


def _maybe_inject_fault():
    spec = os.environ.get(_FAULT_ENV, "")
    if spec.startswith("sleep-after-acquire:"):
        time.sleep(float(spec.split(":", 1)[1]))


def run_worker(store_dir: str, *, worker_id: str | None = None,
               lease_ttl_s: float = DEFAULT_LEASE_TTL_S,
               retry: RetryPolicy | None = None,
               poll_s: float = 0.2, max_jobs: int | None = None,
               idle_timeout_s: float | None = None) -> dict:
    """Drain the store's job queue; returns this worker's tally.

    Exits when every ledger job is terminal (or ``max_jobs`` ran, or
    nothing was acquirable for ``idle_timeout_s``).  While non-terminal
    jobs are leased elsewhere the worker polls: if their workers die,
    acquire's built-in reclaim hands the jobs to us.
    """
    worker = worker_id or default_worker_id()
    store = ArtifactStore(store_dir)
    ledger = JobLedger(store, lease_ttl_s=lease_ttl_s, retry=retry)
    # the device is checked before anything is leased
    runner = (runner_from_manifest(store.read_manifest(), store_dir)
              if ledger.outstanding() else None)
    tally = {"worker": worker, "done": 0, "cache_hits": 0, "failed": 0}
    idle_since = time.monotonic()

    while max_jobs is None or tally["done"] + tally["failed"] < max_jobs:
        rec = ledger.acquire(worker)
        if rec is None:
            if ledger.outstanding() == 0:
                break
            if idle_timeout_s is not None and \
                    time.monotonic() - idle_since > idle_timeout_s:
                break
            time.sleep(poll_s)
            continue
        idle_since = time.monotonic()
        _maybe_inject_fault()

        t0 = time.monotonic()
        try:
            artifact = store.load(rec.key)
            if artifact is not None:      # someone already computed it
                ledger.complete(rec.key, worker, cache_hit=True,
                                runtime_s=time.monotonic() - t0)
                tally["done"] += 1
                tally["cache_hits"] += 1
                continue
            if runner is None:            # submitted after we started
                runner = runner_from_manifest(store.read_manifest(),
                                              store_dir)
            job = runner.job_for_key(rec.key)
            with _Heartbeat(ledger, rec.key, worker) as hb:
                artifact = runner._execute(job)
            store.put(rec.key, artifact)  # write-if-absent, never clobbers
            if hb.lost:
                continue                  # reclaimed from us; theirs counts
            if ledger.complete(rec.key, worker,
                               runtime_s=time.monotonic() - t0):
                tally["done"] += 1
        except Exception:                 # noqa: BLE001 - job faults requeue
            err = traceback.format_exc(limit=20)
            ledger.fail(rec.key, worker, err)
            tally["failed"] += 1
    return tally


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="repro_torch worker",
        description="campaign worker process: lease jobs from a shared "
                    "artifact store and run them on the campaign's device "
                    "(see `python -m repro_torch campaign --scheduler "
                    "process`)")
    ap.add_argument("--store", required=True,
                    help="campaign artifact-store directory (must "
                         "contain campaign.json + ledger.jsonl)")
    ap.add_argument("--worker-id", default=None,
                    help="lease-holder name (default: <host>-<pid>)")
    ap.add_argument("--lease-ttl", type=float,
                    default=DEFAULT_LEASE_TTL_S,
                    help="seconds without a heartbeat before this "
                         "worker's leases are reclaimable")
    ap.add_argument("--max-retries", type=int, default=3,
                    help="requeues before a failing job is quarantined")
    ap.add_argument("--poll", type=float, default=0.2,
                    help="idle polling interval (s)")
    ap.add_argument("--max-jobs", type=int, default=None,
                    help="exit after running this many jobs")
    ap.add_argument("--idle-timeout", type=float, default=None,
                    help="exit after this long with nothing acquirable")
    args = ap.parse_args(argv)

    tally = run_worker(
        args.store, worker_id=args.worker_id,
        lease_ttl_s=args.lease_ttl,
        retry=RetryPolicy(max_retries=args.max_retries),
        poll_s=args.poll, max_jobs=args.max_jobs,
        idle_timeout_s=args.idle_timeout)
    print(f"worker {tally['worker']}: {tally['done']} done "
          f"({tally['cache_hits']} cache hit(s)), "
          f"{tally['failed']} failed")
    return tally


if __name__ == "__main__":
    main()
