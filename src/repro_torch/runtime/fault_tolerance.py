"""Fault tolerance: supervised train loops and stragglers.

  TrainSupervisor  - runs a step function under checkpoint/restart with
                     bounded restarts; any exception (injected or real)
                     triggers restore-from-latest and replay.
  StragglerMonitor - EWMA step-time tracker; flags steps beyond a
                     deviation threshold.
  StepTimer        - simple wall-time per-step measurement helper.

The campaign side (``RetryPolicy``, ``CampaignSupervisor``) waits for the
campaign scheduler's port (ROADMAP A7).  Stdlib-only, as in the reference.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable


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
