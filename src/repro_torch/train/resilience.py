"""Fault-tolerance runtime pieces: straggler monitor + failure supervisor
(copy of ``repro.train.resilience``).

Step timings stream into the StragglerMonitor (per-host EWMA; with one
process the tests simulate host timings), and a step that raises triggers
``recover`` (restore from the last checkpoint) and a retry.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np

from repro_torch.obs.clock import monotonic


@dataclasses.dataclass
class StragglerReport:
    step: int
    host_times: Dict[int, float]
    stragglers: List[int]
    p50: float
    worst_ratio: float


class StragglerMonitor:
    """EWMA per-host step-time tracker.

    A host is flagged when its EWMA exceeds ``threshold`` x the fleet median
    for ``patience`` consecutive steps; acting on the signal is deployment
    policy."""

    def __init__(self, n_hosts: int, *, alpha: float = 0.2,
                 threshold: float = 1.5, patience: int = 3):
        self.n_hosts = n_hosts
        self.alpha = alpha
        self.threshold = threshold
        self.patience = patience
        self.ewma = np.zeros(n_hosts)
        self.strikes = np.zeros(n_hosts, dtype=int)
        self.initialized = False

    def update(self, step: int,
               host_times: Dict[int, float]) -> StragglerReport:
        t = np.array([host_times[h] for h in range(self.n_hosts)])
        if not self.initialized:
            self.ewma = t.astype(float)
            self.initialized = True
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * t
        med = float(np.median(self.ewma))
        over = self.ewma > self.threshold * med
        self.strikes = np.where(over, self.strikes + 1, 0)
        flagged = np.flatnonzero(self.strikes >= self.patience).tolist()
        worst = float(self.ewma.max() / max(med, 1e-9))
        return StragglerReport(step, dict(enumerate(t)), flagged, med, worst)


class FailureSupervisor:
    """Runs a step function with restore-on-failure semantics: on an
    exception it records the event, calls ``recover`` and retries, at most
    ``max_failures`` times in all."""

    def __init__(self, recover: Callable[[], object], *,
                 max_failures: int = 3):
        self.recover = recover
        self.max_failures = max_failures
        self.failures = 0
        self.events: List[dict] = []

    def attempt(self, fn: Callable[[], object]):
        while True:
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 — the supervisor's boundary
                self.failures += 1
                self.events.append({"time": monotonic(), "error": repr(e)})
                if self.failures > self.max_failures:
                    raise
                self.recover()


__all__ = ["StragglerMonitor", "StragglerReport", "FailureSupervisor"]
