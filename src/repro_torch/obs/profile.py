"""``torch.profiler`` hooks for the port (the reference's
``repro.obs.profile`` wraps ``jax.profiler``).

- :func:`trace` — context manager around a whole run, writing a Chrome
  trace of host and device activity into a directory.
- :func:`annotate` — a ``record_function`` range, so a host-side span name
  shows up on the profiler's timeline; the scheduler opens one around
  each dispatch when its tracer was built with ``device_annotate=True``.
- :func:`available` — whether this build of torch can record a trace.

Outside a profiling session ``record_function`` costs one host-side
range push and pop, and no device sync.
"""
from __future__ import annotations

import os
from contextlib import contextmanager

import torch


def available() -> bool:
    """True when torch was built with its Kineto profiler, which
    :func:`trace` records through (host activity, and the card's when
    one is present)."""
    return bool(torch.autograd.kineto_available())


@contextmanager
def trace(log_dir):
    """Profile the block (CPU, plus CUDA when a card is present) and write
    ``trace.json`` into ``log_dir``; a no-op when ``log_dir`` is empty."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(str(log_dir), exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(str(log_dir), "trace.json"))


def annotate(name: str):
    """A ``torch.profiler.record_function`` range named ``name``."""
    return torch.profiler.record_function(name)


__all__ = ["available", "trace", "annotate"]
