"""Summarize a trace of the port:
``python -m repro_torch.launch.obs_report TRACE.json`` (counterpart of
``repro.launch.obs_report``).

Validates the Chrome-trace document against the obs schema first
(:func:`repro_torch.obs.trace.validate_chrome_trace`) and exits nonzero on
a malformed or empty trace, so a change that breaks trace export fails
the command, not just the viewer. The trace is what
``repro_torch.obs.trace.SpanTracer.save`` writes.

On a valid trace it prints per-span-name aggregates (count, total /
mean / p99 / max milliseconds, sorted by total), instant-event counts
(admissions, hot-swaps, finishes, watchdog fires) and the last value of
each counter series. ``--json OUT`` additionally writes the summary as
JSON for trend tracking.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

import numpy as np

from repro_torch.obs.trace import validate_chrome_trace


def summarize(doc: Dict) -> Dict:
    """Aggregate a validated trace document into a plain summary dict."""
    spans: Dict[str, List[float]] = {}
    instants: Dict[str, int] = {}
    counters: Dict[str, float] = {}
    for ev in doc.get("traceEvents", []):
        ph, name = ev.get("ph"), ev.get("name")
        if ph == "X":
            spans.setdefault(name, []).append(float(ev["dur"]) / 1e3)
        elif ph == "i":
            instants[name] = instants.get(name, 0) + 1
        elif ph == "C":
            counters[name] = list(ev["args"].values())[0]
    span_stats = {}
    for name, durs in spans.items():
        a = np.asarray(durs)
        span_stats[name] = {
            "count": int(a.size), "total_ms": float(a.sum()),
            "mean_ms": float(a.mean()), "p99_ms": float(np.percentile(a, 99)),
            "max_ms": float(a.max()),
        }
    return {"spans": span_stats, "instants": instants,
            "counters_last": counters,
            "dropped_events": doc.get("otherData", {}).get(
                "dropped_events", 0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="validate + summarize a Chrome trace of the port")
    ap.add_argument("trace", help="trace JSON path (SpanTracer.save)")
    ap.add_argument("--json", default=None, metavar="OUT",
                    help="also write the summary as JSON")
    args = ap.parse_args(argv)

    try:
        with open(args.trace) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"obs_report: cannot load {args.trace}: {e}", file=sys.stderr)
        return 1
    problems = validate_chrome_trace(doc)
    if problems:
        print(f"obs_report: {args.trace} failed schema validation:",
              file=sys.stderr)
        for p in problems[:20]:
            print(f"  - {p}", file=sys.stderr)
        if len(problems) > 20:
            print(f"  ... and {len(problems) - 20} more", file=sys.stderr)
        return 1

    s = summarize(doc)
    print(f"# {args.trace}: "
          f"{sum(v['count'] for v in s['spans'].values())} spans, "
          f"{sum(s['instants'].values())} instants, "
          f"{s['dropped_events']} dropped")
    print(f"{'span':<24}{'count':>8}{'total ms':>12}{'mean ms':>10}"
          f"{'p99 ms':>10}{'max ms':>10}")
    for name, st in sorted(s["spans"].items(),
                           key=lambda kv: -kv[1]["total_ms"]):
        print(f"{name:<24}{st['count']:>8}{st['total_ms']:>12.2f}"
              f"{st['mean_ms']:>10.3f}{st['p99_ms']:>10.3f}"
              f"{st['max_ms']:>10.3f}")
    if s["instants"]:
        print("events: " + "  ".join(
            f"{k}={v}" for k, v in sorted(s["instants"].items())))
    if s["counters_last"]:
        print("counters (last): " + "  ".join(
            f"{k}={v}" for k, v in sorted(s["counters_last"].items())))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(s, f, indent=2)
        print(f"# wrote {args.json}")
    return 0


__all__ = ["summarize", "main"]


if __name__ == "__main__":
    raise SystemExit(main())
