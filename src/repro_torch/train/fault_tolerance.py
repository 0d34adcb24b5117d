"""Fault tolerance: preemption handling, auto-restart, straggler policy.

Plain Python, as in the reference.

CPU-container simulation of the pod-scale failure model:

* **Preemption/crash** — the trainer installs a step-boundary "fuse" that a
  test (or SIGTERM) can trip; the run exits after the in-flight step, and
  ``resume()`` restores params/opt/data-cursor/rng from the latest atomic
  checkpoint and replays to an *identical* loss trajectory (tested).
* **Straggler mitigation** — per-step wall-clock watchdog: a step exceeding
  ``straggler_factor`` x the trailing-median triggers a recorded event; at
  pod scale the action is re-slicing the collective group (here: logged +
  counted so tests can assert the policy fires).  Hardware re-slicing is a
  runtime concern; the *policy layer* is what's portable.
* **Elastic resize** — checkpoints hold whole arrays, so a run restores
  under another mesh: ``CheckpointManager.restore(shardings=)`` (and
  ``Trainer.resume(shardings=)``) lands each leaf as a DTensor at the new
  layout.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from collections import deque
from typing import Deque, List


@dataclasses.dataclass
class FTEvents:
    preemptions: int = 0
    restarts: int = 0
    stragglers: List[dict] = dataclasses.field(default_factory=list)


class FaultToleranceMonitor:
    def __init__(self, straggler_factor: float = 3.0, window: int = 32,
                 install_signal_handler: bool = False):
        self.straggler_factor = straggler_factor
        self._times: Deque[float] = deque(maxlen=window)
        self.events = FTEvents()
        self._preempt_requested = False
        if install_signal_handler:
            signal.signal(signal.SIGTERM, self._on_sigterm)

    # ------------------------- preemption ----------------------------- #
    def _on_sigterm(self, *_):
        self.request_preemption()

    def request_preemption(self):
        """Called by the infra (or a test) — finish the current step, then
        checkpoint and exit cleanly."""
        self._preempt_requested = True
        self.events.preemptions += 1

    @property
    def should_stop(self) -> bool:
        return self._preempt_requested

    def note_restart(self):
        self.events.restarts += 1
        self._preempt_requested = False

    # ------------------------- stragglers ----------------------------- #
    def observe_step(self, step: int, seconds: float):
        if len(self._times) >= 8:
            med = sorted(self._times)[len(self._times) // 2]
            if seconds > self.straggler_factor * med:
                self.events.stragglers.append(
                    {"step": step, "seconds": seconds, "median": med}
                )
        self._times.append(seconds)

    def straggler_count(self) -> int:
        return len(self.events.stragglers)
