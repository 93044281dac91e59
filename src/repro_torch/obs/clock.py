"""The duration clock (copy of ``repro.obs.clock``).

Every elapsed-time measurement goes through :func:`monotonic`, so that
durations are immune to wall-clock jumps. :func:`wall` is only for
timestamps with calendar meaning (checkpoint metadata); never subtract
two of them.
"""
from __future__ import annotations

import time

#: The duration clock: monotonic, sub-microsecond resolution.
monotonic = time.perf_counter


def wall() -> float:
    """Wall-clock timestamp (seconds since epoch), for metadata only."""
    return time.time()


__all__ = ["monotonic", "wall"]
