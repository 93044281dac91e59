"""Host-side span tracer with a Chrome-trace-event / Perfetto exporter.

Model: **spans** ("X" complete events — a name, a start, a duration,
optional args), **instants** ("i" events — points in time like
``admission`` / ``hot_swap`` / ``finish``), and **counters** ("C"
events — per-step series like ``queue_depth``).  Nesting is positional,
the Chrome way: a span whose ``[ts, ts+dur]`` range sits inside another
span's range on the same thread renders as its child; no parent ids are
stored, so emitting a span is just a clock read and a ``deque.append``.

A copy of the reference's ``repro.obs.trace`` (the same events, the same
export); the one rename is ``device_annotate`` for the reference's
profiler flag, which here opens ``torch.profiler`` annotations.

Overhead contract:

- events live in a bounded ring (``deque(maxlen=capacity)``); when full,
  the oldest events fall off and ``dropped`` counts them — tracing can
  never grow memory without bound or block the hot path;
- no locks: ``deque.append`` is atomic under the GIL, so the stream
  pipeline's worker thread and the scheduler thread share one tracer;
- no device syncs: the tracer touches only host clocks and Python
  objects.  The serving hot path keeps exactly one device sync (the
  one-step-behind read of the scores in the scheduler's harvest) whether
  or not tracing is on.
- the clock is injected (``clock=``), so tests assert exact timings
  with a hand-driven clock instead of tolerances.

``NULL_TRACER`` is the default tracer everywhere: every method is a
no-op returning a shared null span, so untraced code pays one attribute
lookup and one call per site.
"""
from __future__ import annotations

import json
import os
import threading
from collections import deque
from typing import Dict, Iterable, List, Optional

from repro_torch.obs.clock import monotonic

_VALID_PH = ("X", "i", "C", "M")


class _Span:
    """Context manager for one "X" event; reusable args via ``set``."""

    __slots__ = ("_tr", "name", "args", "_t0")

    def __init__(self, tr: "SpanTracer", name: str, args: Optional[Dict]):
        self._tr = tr
        self.name = name
        self.args = args
        self._t0 = 0.0

    def set(self, **kw) -> None:
        """Attach args discovered mid-span (e.g. the chosen jit bucket).

        Must be called before the ``with`` block exits — the event is
        written at ``__exit__``.
        """
        if self.args is None:
            self.args = kw
        else:
            self.args.update(kw)

    def __enter__(self) -> "_Span":
        self._t0 = self._tr.clock()
        return self

    def __exit__(self, *exc) -> None:
        tr = self._tr
        t1 = tr.clock()
        tr._push({"name": self.name, "ph": "X",
                  "ts": (self._t0 - tr._epoch) * 1e6,
                  "dur": (t1 - self._t0) * 1e6,
                  "pid": tr.pid, "tid": threading.get_ident(),
                  **({"args": self.args} if self.args else {})})


class _NullSpan:
    """Shared no-op span: zero allocation on the untraced path."""

    __slots__ = ()

    def set(self, **kw) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Do-nothing tracer; the default wired into every subsystem."""

    enabled = False
    device_annotate = False
    dropped = 0

    def span(self, name: str, **args) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, **args) -> None:
        pass

    def counter(self, name: str, value) -> None:
        pass

    def clear(self) -> None:
        pass

    def __len__(self) -> int:
        return 0


NULL_TRACER = NullTracer()


class SpanTracer:
    """Ring-buffered host tracer emitting Chrome trace events.

    Parameters
    ----------
    clock: a ``() -> float`` seconds source; injected for determinism
        (defaults to the repo monotonic clock).
    capacity: ring size in events; the oldest events are dropped (and
        counted in ``dropped``) when full.
    device_annotate: when True, instrumented dispatch sites additionally
        open ``torch.profiler`` annotations (see ``repro_torch.obs.profile``),
        so device timelines carry the same names as host spans.
    """

    enabled = True

    def __init__(self, clock=monotonic, capacity: int = 65536, *,
                 device_annotate: bool = False):
        self.clock = clock
        self.capacity = int(capacity)
        self.device_annotate = bool(device_annotate)
        self.pid = os.getpid()
        self._events: deque = deque(maxlen=self.capacity)
        self.dropped = 0
        self._epoch = clock()

    # -- emit ---------------------------------------------------------
    def _push(self, ev: Dict) -> None:
        if len(self._events) == self.capacity:
            self.dropped += 1
        self._events.append(ev)

    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args or None)

    def instant(self, name: str, **args) -> None:
        self._push({"name": name, "ph": "i", "s": "t",
                    "ts": (self.clock() - self._epoch) * 1e6,
                    "pid": self.pid, "tid": threading.get_ident(),
                    **({"args": args} if args else {})})

    def counter(self, name: str, value) -> None:
        self._push({"name": name, "ph": "C",
                    "ts": (self.clock() - self._epoch) * 1e6,
                    "pid": self.pid, "tid": threading.get_ident(),
                    "args": {"value": value}})

    # -- inspect / export ---------------------------------------------
    def __len__(self) -> int:
        return len(self._events)

    def events(self) -> List[Dict]:
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()
        self.dropped = 0
        self._epoch = self.clock()

    def to_chrome_trace(self) -> Dict:
        """The ``{"traceEvents": [...]}`` document Perfetto loads."""
        meta = [{"name": "process_name", "ph": "M", "pid": self.pid,
                 "tid": 0, "ts": 0,
                 "args": {"name": "repro_torch"}}]
        return {"traceEvents": meta + self.events(),
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)


def validate_chrome_trace(doc, *, require_nonempty: bool = True
                          ) -> List[str]:
    """Schema check for an exported trace; returns a list of problems.

    An empty list means the document is a well-formed Chrome trace
    (``traceEvents`` array of X/i/C/M events with numeric timestamps,
    non-negative durations and int pid/tid) that Perfetto will load.
    Run it on an exported trace before handing the file to a viewer.
    """
    problems: List[str] = []
    if not isinstance(doc, dict):
        return [f"trace root must be an object, got {type(doc).__name__}"]
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    n_real = 0
    for i, ev in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        name, ph = ev.get("name"), ev.get("ph")
        if not isinstance(name, str) or not name:
            problems.append(f"{where}: missing/empty name")
        if ph not in _VALID_PH:
            problems.append(f"{where}: bad ph {ph!r}")
            continue
        if ph != "M":
            n_real += 1
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"{where}: bad ts {ts!r}")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                problems.append(f"{where}: {key} must be int")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: X event bad dur {dur!r}")
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args:
                problems.append(f"{where}: C event needs args")
        if "args" in ev and not isinstance(ev["args"], dict):
            problems.append(f"{where}: args must be an object")
    if require_nonempty and n_real == 0 and not problems:
        problems.append("trace has no events (metadata only)")
    return problems
