"""The duration clock (copy of ``repro.obs.clock``).

Every elapsed-time measurement goes through :func:`monotonic`, so that
durations are immune to wall-clock jumps. :func:`wall` is only for
timestamps with calendar meaning (checkpoint metadata); never subtract
two of them. Tests inject :class:`ManualClock` (``SpanTracer(clock=...)``)
so that timing assertions are exact.
"""
from __future__ import annotations

import time

#: The duration clock: monotonic, sub-microsecond resolution.
monotonic = time.perf_counter


def wall() -> float:
    """Wall-clock timestamp (seconds since epoch), for metadata only."""
    return time.time()


class ManualClock:
    """Deterministic clock for tests: advances only when told to."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += float(dt)


__all__ = ["monotonic", "wall", "ManualClock"]
