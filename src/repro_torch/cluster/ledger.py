"""Durable, lease-based job queue for distributed campaigns.

The ledger is an **append-only JSONL event log** (``ledger.jsonl`` in
the artifact store) replayed into per-job state — the same task-table
idea as Ray's GCS job table, scaled down to one campaign directory.
Multiple workers, across processes *and* invocations, share it safely:

  * every mutation appends one event under an ``O_EXCL`` lockfile
    (``ledger.lock``), so transitions are atomic and totally ordered;
  * a worker takes a job by writing a ``lease`` event plus a live lease
    record ``leases/<key>.json`` whose **mtime is the heartbeat** — the
    worker touches it while executing, and a lease whose mtime is older
    than its TTL is dead by definition;
  * anyone (worker acquire, campaign supervisor, ``--status``) may
    reclaim dead leases: the job is requeued with exponential backoff,
    or quarantined once its :class:`RetryPolicy` budget is spent.

Job lifecycle::

    submit -> pending -> leased -> done                  (artifact in store)
                  ^         |
                  |         +--> failed/expired: requeue (backoff, budget--)
                  +---------+
                            +--> quarantined             (poison job)

States ``done`` and ``quarantined`` are terminal; a campaign is finished
when :meth:`JobLedger.outstanding` reaches zero.  Replaying the log is
idempotent, which is the whole resume story: a restarted campaign
re-submits (no-op for known keys), reclaims what its dead predecessor
leased, and only executes what never finished.

Stdlib-only (json/os/time): planning and ``--status`` load no kernel
library.  Every read of the time goes through this module's ``time``, and
the lease and lock files get their mtimes from it, so a test that patches
the module's clock moves every lease and lock with it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import tempfile
import time

from repro_torch.cluster.store import ArtifactStore
from repro_torch.runtime.fault_tolerance import RetryPolicy

DEFAULT_LEASE_TTL_S = 30.0

_TERMINAL = ("done", "quarantined")


def default_worker_id() -> str:
    return f"{socket.gethostname()}-{os.getpid()}"


@dataclasses.dataclass
class JobRecord:
    """Materialized state of one job after replaying the ledger."""

    key: str
    workload: str
    backend: str
    state: str = "pending"          # pending|leased|done|quarantined
    worker: str | None = None       # current/most recent lease holder
    attempts: int = 0               # failures + expiries so far
    leases: int = 0                 # lease events (>=1 means it ran)
    not_before: float = 0.0         # backoff gate for re-acquire (epoch)
    error: str | None = None        # last failure (kept after requeue)
    cache_hit: bool = False         # completed from an existing artifact
    runtime_s: float | None = None  # execution wall time (last lease)
    submitted_t: float | None = None
    first_lease_t: float | None = None
    done_t: float | None = None

    @property
    def terminal(self) -> bool:
        return self.state in _TERMINAL

    @property
    def queue_wait_s(self) -> float | None:
        if self.submitted_t is None or self.first_lease_t is None:
            return None
        return max(0.0, self.first_lease_t - self.submitted_t)

    def metrics(self) -> dict:
        """The per-job observability record for the campaign report."""
        return {"state": self.state, "worker": self.worker,
                "leases": self.leases, "retries": self.attempts,
                "cache_hit": self.cache_hit,
                "queue_wait_s": self.queue_wait_s,
                "runtime_s": self.runtime_s,
                "error": self.error}


class JobLedger:
    """Lock-protected job queue over an :class:`ArtifactStore`."""

    # ledger.lock is only held across one replay + one append; a holder
    # older than this crashed mid-append and is safe to evict.
    LOCK_STALE_S = 30.0

    def __init__(self, store: ArtifactStore | str, *,
                 lease_ttl_s: float = DEFAULT_LEASE_TTL_S,
                 retry: RetryPolicy | None = None):
        self.store = store if isinstance(store, ArtifactStore) \
            else ArtifactStore(store)
        self.lease_ttl_s = float(lease_ttl_s)
        self.retry = retry or RetryPolicy()
        os.makedirs(self.store.lease_dir, exist_ok=True)

    # ------------------------------------------------------------------
    # the event log
    # ------------------------------------------------------------------
    def _events(self) -> list[dict]:
        try:
            with open(self.store.ledger_path) as f:
                lines = f.read().splitlines()
        except FileNotFoundError:
            return []
        out = []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue    # torn trailing write from a killed appender
        return out

    def _append(self, events: list[dict]) -> None:
        with open(self.store.ledger_path, "a") as f:
            for ev in events:
                f.write(json.dumps(ev, sort_keys=True) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def replay(self) -> dict[str, JobRecord]:
        """Fold the event log into per-job records (read-only: callers
        that go on to mutate must do so under :meth:`_locked`)."""
        jobs: dict[str, JobRecord] = {}
        for ev in self._events():
            kind, key = ev.get("event"), ev.get("key")
            if key is None:
                continue
            if kind == "submit":
                if key not in jobs:
                    jobs[key] = JobRecord(
                        key=key, workload=ev.get("workload", "?"),
                        backend=ev.get("backend", "?"),
                        submitted_t=ev.get("t"))
                continue
            rec = jobs.get(key)
            if rec is None or rec.terminal:
                continue                 # terminal states never regress
            if kind == "lease":
                rec.state = "leased"
                rec.worker = ev.get("worker")
                rec.leases += 1
                if rec.first_lease_t is None:
                    rec.first_lease_t = ev.get("t")
            elif kind == "done":
                rec.state = "done"
                rec.done_t = ev.get("t")
                rec.cache_hit = bool(ev.get("cache_hit", False))
                rec.runtime_s = ev.get("runtime_s")
                rec.error = None
            elif kind in ("requeue", "quarantine"):
                rec.attempts = ev.get("attempts", rec.attempts + 1)
                rec.error = ev.get("error", rec.error)
                if kind == "quarantine":
                    rec.state = "quarantined"
                    rec.done_t = ev.get("t")
                else:
                    rec.state = "pending"
                    rec.worker = None
                    rec.not_before = ev.get("not_before", 0.0)
        return jobs

    # ------------------------------------------------------------------
    # the ledger mutation lock
    # ------------------------------------------------------------------
    def _lock(self, *, timeout_s: float = 10.0) -> None:
        path = os.path.join(self.store.root, "ledger.lock")
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                now = time.time()
                os.write(fd, json.dumps(
                    {"pid": os.getpid(), "t": now}).encode())
                os.close(fd)
                os.utime(path, (now, now))
                return
            except FileExistsError:
                try:
                    age = time.time() - os.stat(path).st_mtime
                    if age > self.LOCK_STALE_S:
                        os.unlink(path)     # crashed appender
                        continue
                except FileNotFoundError:
                    continue
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"could not acquire ledger lock {path}")
                time.sleep(0.005)

    def _unlock(self) -> None:
        try:
            os.unlink(os.path.join(self.store.root, "ledger.lock"))
        except FileNotFoundError:
            pass

    # ------------------------------------------------------------------
    # lease records (heartbeat files)
    # ------------------------------------------------------------------
    def _lease_path(self, key: str) -> str:
        return os.path.join(self.store.lease_dir, f"{key}.json")

    def _write_lease(self, key: str, worker: str) -> None:
        # tmp + os.replace: a reclaiming scheduler parsing this lease
        # concurrently must never see a torn JSON record; the mtime that
        # heartbeat()/lease_expired() key on is set from this module's clock.
        path = self._lease_path(key)
        fd, tmp = tempfile.mkstemp(dir=self.store.lease_dir,
                                   suffix=".tmp")
        try:
            now = time.time()
            with os.fdopen(fd, "w") as f:
                json.dump({"worker": worker, "pid": os.getpid(),
                           "acquired": now,
                           "ttl_s": self.lease_ttl_s}, f)
            os.utime(tmp, (now, now))
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def _drop_lease(self, key: str) -> None:
        try:
            os.unlink(self._lease_path(key))
        except FileNotFoundError:
            pass

    def heartbeat(self, key: str, worker: str) -> bool:
        """Touch the lease record (mtime == liveness).  False when the
        lease is gone — the job was reclaimed from us; the worker should
        abandon it."""
        path = self._lease_path(key)
        try:
            with open(path) as f:
                lease = json.load(f)
            if lease.get("worker") != worker:
                return False
            now = time.time()
            os.utime(path, (now, now))
            return True
        except (FileNotFoundError, json.JSONDecodeError):
            return False

    def lease_expired(self, key: str) -> bool:
        """A lease with no heartbeat for a full TTL is dead."""
        try:
            return time.time() - os.stat(self._lease_path(key)).st_mtime \
                > self.lease_ttl_s
        except FileNotFoundError:
            return True                  # no record at all: stale state

    # ------------------------------------------------------------------
    # transitions
    # ------------------------------------------------------------------
    def submit(self, jobs) -> int:
        """Append submit events for unknown keys; idempotent by key, so
        a restarted campaign resumes instead of duplicating work.  Each
        job needs ``.key``/``.workload``/``.backend`` attributes or
        dict entries.  Returns the number of newly submitted jobs."""
        self._lock()
        try:
            known = self.replay()
            now = time.time()
            events = []
            for job in jobs:
                get = job.get if isinstance(job, dict) \
                    else lambda k, j=job: getattr(j, k)
                key = get("key")
                if key in known:
                    continue
                known[key] = True       # dedup within one submit batch
                events.append({"event": "submit", "key": key,
                               "workload": get("workload"),
                               "backend": get("backend"), "t": now})
            if events:
                self._append(events)
            return len(events)
        finally:
            self._unlock()

    def acquire(self, worker: str) -> JobRecord | None:
        """Lease the oldest eligible pending job (FIFO by submit order,
        gated by backoff).  Reclaims expired leases first, so a pool of
        bare workers self-heals without any supervisor.  None when
        nothing is currently acquirable."""
        self._lock()
        try:
            jobs = self.replay()
            events = self._reclaim_events(jobs)
            now = time.time()
            chosen = None
            for rec in jobs.values():   # dict preserves submit order
                if rec.state == "pending" and rec.not_before <= now:
                    chosen = rec
                    break
            if chosen is not None:
                events.append({"event": "lease", "key": chosen.key,
                               "worker": worker, "t": now})
            if events:
                self._append(events)
            if chosen is None:
                return None
            self._write_lease(chosen.key, worker)
            chosen.state = "leased"
            chosen.worker = worker
            chosen.leases += 1
            return chosen
        finally:
            self._unlock()

    def complete(self, key: str, worker: str, *, cache_hit: bool = False,
                 runtime_s: float | None = None) -> bool:
        """leased -> done.  Ignored (False) unless ``worker`` still holds
        the lease — a worker whose lease was reclaimed must not complete
        over the re-execution."""
        return self._finish(key, worker, {
            "event": "done", "cache_hit": cache_hit,
            "runtime_s": runtime_s})

    def fail(self, key: str, worker: str, error: str) -> bool:
        """leased -> pending (backoff) or quarantined (budget spent)."""
        return self._finish(key, worker, {"event": "failed",
                                          "error": str(error)[:2000]})

    def _finish(self, key: str, worker: str, ev: dict) -> bool:
        self._lock()
        try:
            rec = self.replay().get(key)
            if rec is None or rec.state != "leased" \
                    or rec.worker != worker:
                return False
            now = time.time()
            if ev["event"] == "done":
                self._append([{**ev, "key": key, "worker": worker,
                               "t": now}])
            else:
                self._append([self._requeue_event(
                    rec, now, ev["error"])])
            self._drop_lease(key)
            return True
        finally:
            self._unlock()

    def reclaim_expired(self) -> list[str]:
        """Requeue (or quarantine) every leased job whose heartbeat went
        silent for a full TTL.  Safe to call from anywhere, any time."""
        self._lock()
        try:
            jobs = self.replay()
            events = self._reclaim_events(jobs)
            if events:
                self._append(events)
            return [ev["key"] for ev in events]
        finally:
            self._unlock()

    def _reclaim_events(self, jobs: dict) -> list[dict]:
        events = []
        now = time.time()
        for rec in jobs.values():
            if rec.state == "leased" and self.lease_expired(rec.key):
                ev = self._requeue_event(
                    rec, now,
                    f"lease expired (worker {rec.worker} presumed "
                    f"dead, no heartbeat for {self.lease_ttl_s:g}s)")
                events.append(ev)
                self._drop_lease(rec.key)
                # keep this replay consistent with the appended event
                rec.attempts = ev["attempts"]
                rec.error = ev["error"]
                if ev["event"] == "quarantine":
                    rec.state = "quarantined"
                else:
                    rec.state = "pending"
                    rec.worker = None
                    rec.not_before = ev["not_before"]
        return events

    def _requeue_event(self, rec: JobRecord, now: float,
                       error: str) -> dict:
        attempts = rec.attempts + 1
        if self.retry.exhausted(attempts):
            return {"event": "quarantine", "key": rec.key,
                    "attempts": attempts, "error": error, "t": now}
        return {"event": "requeue", "key": rec.key, "attempts": attempts,
                "error": error, "t": now,
                "not_before": now + self.retry.delay_s(attempts)}

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def snapshot(self) -> dict[str, JobRecord]:
        return self.replay()

    def outstanding(self) -> int:
        """Jobs not yet terminal (pending + leased)."""
        return sum(1 for r in self.replay().values() if not r.terminal)

    def counts(self) -> dict[str, int]:
        out = {"pending": 0, "leased": 0, "done": 0, "quarantined": 0}
        for rec in self.replay().values():
            out[rec.state] = out.get(rec.state, 0) + 1
        return out
