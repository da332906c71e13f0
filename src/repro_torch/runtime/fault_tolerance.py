"""Fault tolerance: supervised train loops and stragglers.

  TrainSupervisor  - runs a step function under checkpoint/restart with
                     bounded restarts; any exception (injected or real)
                     triggers restore-from-latest and replay.
  StragglerMonitor - EWMA step-time tracker; flags steps beyond a
                     deviation threshold.
  StepTimer        - simple wall-time per-step measurement helper.
  RetryPolicy      - bounded-budget exponential backoff + poison-job
                     quarantine decisions for the campaign job queue.
  CampaignSupervisor - reclaimer loop over a repro_torch.cluster JobLedger:
                     expires dead leases, requeues with backoff, respawns
                     dead workers, and reports per-job metrics.

Stdlib-only by design: the campaign scheduler imports this module from its
planning path (``--dry-run``, ``--status``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """When and how a failed/expired campaign job goes back in the queue.

    Both failure modes consume the same budget: a job that *raises* and a
    job whose worker died mid-lease (lease expiry) are indistinguishable
    to the scheduler — a poison job that reliably kills its worker shows
    up as repeated expiries, and must hit quarantine just the same.
    """

    max_retries: int = 3          # requeues before quarantine
    backoff_base_s: float = 0.5   # first-requeue delay
    backoff_cap_s: float = 30.0   # exponential growth saturates here

    def delay_s(self, attempts: int) -> float:
        """Backoff before the ``attempts``-th requeue (attempts >= 1)."""
        return min(self.backoff_cap_s,
                   self.backoff_base_s * (2.0 ** max(0, attempts - 1)))

    def exhausted(self, attempts: int) -> bool:
        """True once the job has burned its whole retry budget and must
        be quarantined instead of requeued (poison-job detection)."""
        return attempts >= self.max_retries


@dataclasses.dataclass
class StepTimer:
    t_last: float = dataclasses.field(default_factory=time.monotonic)

    def lap(self) -> float:
        now = time.monotonic()
        dt = now - self.t_last
        self.t_last = now
        return dt


class StragglerMonitor:
    """EWMA-based step-time outlier detection: a step slower than
    ``threshold`` x EWMA for ``patience`` consecutive steps is flagged."""

    def __init__(self, alpha: float = 0.1, threshold: float = 2.0,
                 patience: int = 3):
        self.alpha = alpha
        self.threshold = threshold
        self.patience = patience
        self.ewma: float | None = None
        self.strikes = 0
        self.flagged: list[int] = []

    def observe(self, step: int, dt: float) -> bool:
        """Returns True when the step is flagged as a straggler event."""
        if self.ewma is None:
            self.ewma = dt
            return False
        is_slow = dt > self.threshold * self.ewma
        if is_slow:
            self.strikes += 1
        else:
            self.strikes = 0
        # only adapt the EWMA on non-outlier steps
        if not is_slow:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        if self.strikes >= self.patience:
            self.flagged.append(step)
            self.strikes = 0
            return True
        return False


class CampaignSupervisor:
    """Reclaimer/elasticity loop for a distributed campaign.

    Wraps a :class:`repro_torch.cluster.JobLedger`: each :meth:`tick` expires
    dead leases (requeue-with-backoff / quarantine are the ledger's
    lock-protected transitions, driven by its :class:`RetryPolicy`),
    restarts dead worker processes while work remains, and folds
    completed-job runtimes through a :class:`StragglerMonitor` so
    pathologically slow jobs are flagged in the final metrics.

    ``workers`` entries only need ``poll() -> exitcode | None`` (e.g.
    ``subprocess.Popen``); ``spawn_worker(index) -> handle`` provides
    replacements.  The supervisor is optional — workers also reclaim
    expired leases on acquire, so a campaign directory heals itself even
    when driven by bare ``python -m repro_torch worker`` invocations.
    """

    def __init__(self, ledger, *, spawn_worker: Callable | None = None,
                 max_respawns: int = 4, poll_s: float = 0.2):
        self.ledger = ledger
        self.spawn_worker = spawn_worker
        self.max_respawns = max_respawns
        self.poll_s = poll_s
        self.workers: list = []
        self.respawns = 0
        self.reclaimed: list[str] = []
        self.worker_deaths = 0
        self.straggler = StragglerMonitor()
        self._observed_done: set = set()
        self._counted_deaths: set = set()    # id(handle) already tallied

    def add_worker(self, handle) -> None:
        self.workers.append(handle)

    def live_workers(self) -> int:
        return sum(1 for w in self.workers if w.poll() is None)

    def tick(self) -> list[str]:
        """One supervision round; returns keys whose leases were
        reclaimed this round."""
        reclaimed = self.ledger.reclaim_expired()
        self.reclaimed.extend(reclaimed)
        self._replace_dead_workers()
        self._observe_completions()
        return reclaimed

    def run(self, *, timeout_s: float | None = None) -> dict:
        """Tick until every ledger job is terminal (done/quarantined);
        returns :meth:`metrics`.  Raises on timeout or when no workers
        remain and the respawn budget is spent while work is pending."""
        timer = StepTimer()
        waited = 0.0
        while self.ledger.outstanding() > 0:
            self.tick()
            if self.workers and self.live_workers() == 0 \
                    and (self.spawn_worker is None
                         or self.respawns >= self.max_respawns):
                raise RuntimeError(
                    f"all campaign workers died with "
                    f"{self.ledger.outstanding()} job(s) outstanding "
                    f"(respawn budget {self.max_respawns} spent); see "
                    f"`python -m repro_torch campaign --status` for the ledger")
            time.sleep(self.poll_s)
            waited += timer.lap()
            if timeout_s is not None and waited > timeout_s:
                raise TimeoutError(
                    f"campaign incomplete after {timeout_s:.0f}s: "
                    f"{self.ledger.outstanding()} job(s) outstanding")
        self.tick()                     # final metrics/straggler fold
        return self.metrics()

    def _replace_dead_workers(self) -> None:
        if self.spawn_worker is None or self.ledger.outstanding() == 0:
            return
        for i, w in enumerate(self.workers):
            if w.poll() is None or id(w) in self._counted_deaths:
                continue
            self._counted_deaths.add(id(w))
            self.worker_deaths += 1
            if self.respawns >= self.max_respawns:
                continue
            self.respawns += 1
            self.workers[i] = self.spawn_worker(len(self.workers)
                                                + self.respawns)

    def _observe_completions(self) -> None:
        for key, rec in sorted(self.ledger.snapshot().items()):
            if rec.state == "done" and key not in self._observed_done \
                    and rec.runtime_s is not None and not rec.cache_hit:
                self._observed_done.add(key)
                self.straggler.observe(len(self._observed_done),
                                       rec.runtime_s)

    def metrics(self) -> dict:
        """Per-job timing/retry/cache-hit metrics plus supervision
        counters — merged into the campaign report's ``jobs`` records."""
        return {
            "jobs": {k: r.metrics()
                     for k, r in sorted(self.ledger.snapshot().items())},
            "reclaimed_leases": list(self.reclaimed),
            "worker_deaths": self.worker_deaths,
            "worker_respawns": self.respawns,
            "straggler_flags": list(self.straggler.flagged),
        }


class TrainSupervisor:
    """Checkpoint/restart supervision around a step function.

    step_fn(state, step) -> state  may raise; the supervisor restores the
    latest checkpoint and resumes.  Deterministic data (seed, step) makes
    the replay exact.
    """

    def __init__(self, ckpt_manager, save_every: int = 50,
                 max_restarts: int = 5):
        self.ckpt = ckpt_manager
        self.save_every = save_every
        self.max_restarts = max_restarts
        self.restarts = 0
        self.straggler = StragglerMonitor()

    def run(self, state, step_fn: Callable, n_steps: int,
            start_step: int = 0, on_metrics: Callable | None = None):
        step = start_step
        timer = StepTimer()
        while step < n_steps:
            try:
                state = step_fn(state, step)
                dt = timer.lap()
                self.straggler.observe(step, dt)
                if on_metrics:
                    on_metrics(step, dt)
                step += 1
                if step % self.save_every == 0:
                    self.ckpt.save(step, state)
            except Exception as e:  # noqa: BLE001 - any fault restarts
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise RuntimeError(
                        f"exceeded {self.max_restarts} restarts") from e
                latest = self.ckpt.latest_step()
                if latest is None:
                    # no checkpoint yet: restart from scratch
                    step = start_step
                    continue
                state, step = self.ckpt.restore(state)
                timer = StepTimer()
        self.ckpt.save(step, state)
        return state, step
