"""Typed, mergeable metrics: counters, gauges, histograms, a registry.

Design contract — **snapshots merge associatively and commutatively**,
the same discipline the reference's ``StreamingAUC`` /
``StreamingLogLoss`` follow (``repro.core.metrics``; a copy of this module
in the port).  That is what makes the registry usable across
stream shards and (eventually) hosts: any grouping / ordering of
partial snapshots merges to the same total.

Merge rules:

- **counter** — values add (ints stay ints, so integer counters merge
  bit-exactly).
- **histogram** — fixed, identical bucket bounds; per-bin counts,
  ``total`` and ``count`` add; ``min`` / ``max`` combine by min / max
  (``None`` when empty is the merge identity).
- **gauge** — last-writer-wins can't be made order-independent, so a
  gauge carries a monotonically increasing ``seq`` and merge picks the
  larger ``(seq, value)`` pair — max is associative and commutative.
  Within one process this is exactly last-writer-wins.

Snapshots are plain dicts of plain data (no shared references into the
registry): mutating a snapshot never perturbs the registry, and two
snapshots never alias each other.
"""
from __future__ import annotations

from bisect import bisect_right
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Snapshot = Dict[str, Dict]

#: Default histogram bounds: 1-2-5 decades, good for counts and depths.
DEFAULT_BOUNDS: Tuple[float, ...] = (
    1, 2, 5, 10, 20, 50, 100, 200, 500, 1000, 2000, 5000)


class Counter:
    """Monotonic-by-convention additive metric. Merge: sum."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n

    def set(self, v) -> None:
        self.value = v

    def reset(self) -> None:
        self.value = 0

    def snapshot(self) -> Dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Point-in-time value. Merge: max over ``(seq, value)``."""

    __slots__ = ("name", "value", "seq")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self.seq = 0

    def set(self, v) -> None:
        self.value = v
        self.seq += 1

    def reset(self) -> None:
        self.value = 0.0
        self.seq = 0

    def snapshot(self) -> Dict:
        return {"type": "gauge", "value": self.value, "seq": self.seq}


class Histogram:
    """Fixed-bound histogram with exact total / count / min / max.

    ``counts`` has ``len(bounds) + 1`` bins; observation ``v`` lands in
    the first bin whose upper bound is ``>= v`` (last bin is overflow).
    ``mean`` is exact (from ``total``), not bin-approximated.
    """

    __slots__ = ("name", "bounds", "counts", "total", "count",
                 "vmin", "vmax")

    def __init__(self, name: str, bounds: Sequence[float] = DEFAULT_BOUNDS):
        self.name = name
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError(f"histogram {name}: bounds must be "
                             f"strictly increasing, got {bounds}")
        self.reset()

    def observe(self, v) -> None:
        self.counts[bisect_right(self.bounds, v)] += 1
        self.total += v
        self.count += 1
        if self.vmin is None or v < self.vmin:
            self.vmin = v
        if self.vmax is None or v > self.vmax:
            self.vmax = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def reset(self) -> None:
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.total = 0
        self.count = 0
        self.vmin = None
        self.vmax = None

    def snapshot(self) -> Dict:
        return {"type": "histogram", "bounds": list(self.bounds),
                "counts": list(self.counts), "total": self.total,
                "count": self.count, "min": self.vmin, "max": self.vmax}


class MetricsRegistry:
    """Create-or-get store of named metrics with prefix-scoped reset.

    Names are dot-separated, ``<subsystem>.<noun>[.<qualifier>]``
    (see ``docs/observability.md``).  ``reset(prefix=...)`` resets only
    metrics under that prefix, which is how the scheduler's
    ``reset_telemetry()`` zeroes its ``serve.*`` counters without
    touching the one-shot ``jit.*`` compile gauges.
    """

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, *args)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is {type(m).__name__}, "
                            f"requested {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  bounds: Sequence[float] = DEFAULT_BOUNDS) -> Histogram:
        h = self._get(name, Histogram, bounds)
        if h.bounds != tuple(float(b) for b in bounds):
            raise ValueError(f"histogram {name!r} already registered "
                             f"with bounds {h.bounds}")
        return h

    def names(self, prefix: str = "") -> List[str]:
        return sorted(n for n in self._metrics if n.startswith(prefix))

    def snapshot(self, prefix: str = "") -> Snapshot:
        """Deep, non-aliasing copy of all metrics under ``prefix``."""
        return {n: m.snapshot() for n, m in sorted(self._metrics.items())
                if n.startswith(prefix)}

    def reset(self, prefix: str = "") -> None:
        for n, m in self._metrics.items():
            if n.startswith(prefix):
                m.reset()


def _merge_two(a: Dict, b: Dict, name: str) -> Dict:
    if a["type"] != b["type"]:
        raise ValueError(f"merge {name!r}: type mismatch "
                         f"{a['type']} vs {b['type']}")
    if a["type"] == "counter":
        return {"type": "counter", "value": a["value"] + b["value"]}
    if a["type"] == "gauge":
        win = a if (a["seq"], a["value"]) >= (b["seq"], b["value"]) else b
        return {"type": "gauge", "value": win["value"],
                "seq": max(a["seq"], b["seq"])}
    if a["type"] == "histogram":
        if a["bounds"] != b["bounds"]:
            raise ValueError(f"merge {name!r}: histogram bounds differ")
        lo = [v for v in (a["min"], b["min"]) if v is not None]
        hi = [v for v in (a["max"], b["max"]) if v is not None]
        return {"type": "histogram", "bounds": list(a["bounds"]),
                "counts": [x + y for x, y in zip(a["counts"], b["counts"])],
                "total": a["total"] + b["total"],
                "count": a["count"] + b["count"],
                "min": min(lo) if lo else None,
                "max": max(hi) if hi else None}
    raise ValueError(f"merge {name!r}: unknown type {a['type']!r}")


def merge_snapshots(*snaps: Snapshot) -> Snapshot:
    """Merge snapshots associatively; missing names merge as identity."""
    out: Snapshot = {}
    for snap in snaps:
        for name, m in snap.items():
            cur = out.get(name)
            if cur is not None:
                out[name] = _merge_two(cur, m, name)
            elif m["type"] == "histogram":
                out[name] = dict(m, counts=list(m["counts"]),
                                 bounds=list(m["bounds"]))
            else:
                out[name] = dict(m)
    return {n: out[n] for n in sorted(out)}
