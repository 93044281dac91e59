"""Async host pipeline: event ticks -> incremental rows -> fixed-shape batches
(counterpart of ``repro.stream.pipeline``).

A background thread drains a data-layer event source (an iterable of event
ticks, e.g. ``data.requests.make_event_stream``), runs incremental prompt
construction (``IncrementalDTI.extend_prompts``), FFD-packs the resulting
rows into shared segment-isolated rows (``core.dti.pack_prompts``) and
queues fixed-shape numpy batches for the train step, so host work overlaps
device work. The worker does numpy work only and makes no CUDA call: the
train step (``train.trainer.make_train_step``) moves each batch to the
params' device.

Shape discipline: the batch dim is always ``batch_size`` (a partial final
batch is padded by repeating its first row with ``target_mask`` cleared —
zero CTR loss weight, zero CTR gradient; an MoE config's batch-global
load-balancing aux term still sees the padding row, exactly as the batch
trainer's wrap-around padding does) and the sequence dim is the smallest
``bucket`` covering the longest packed row in the batch, so the step sees
at most ``len(buckets)`` shapes.

``PromptStats.pad_fraction`` is tracked over the emitted batches (slots =
rows x bucket length); padding-by-duplication rows count as slots carrying
tokens — they are real compute — but contribute no targets.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.core.dti import PromptStats, pack_prompts, prompt_length
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.stream.incremental import IncrementalDTI

_DONE = object()


class StreamPipeline:
    """Iterate ``batches()`` on the trainer side; the worker thread keeps
    the queue fed. ``stats`` carries the packed-batch token accounting
    (``pad_fraction``); ``n_targets`` below equals the number of supervised
    [SUM] positions emitted, each exactly once."""

    def __init__(self, source: Iterable[List[Dict]], inc: IncrementalDTI, *,
                 batch_size: int, buckets: Optional[Sequence[int]] = None,
                 pack: bool = True, queue_size: int = 8,
                 tracer=None, metrics: Optional[MetricsRegistry] = None):
        if batch_size <= 0:
            raise ValueError(f"batch_size {batch_size} must be positive")
        self.inc = inc
        self.batch_size = batch_size
        self.buckets = tuple(sorted(buckets)) if buckets else (inc.max_len,)
        if self.buckets[-1] != inc.max_len:
            raise ValueError(f"largest bucket {self.buckets[-1]} must equal "
                             f"max_len {inc.max_len}")
        self.pack = pack
        self.stats = PromptStats()
        # worker-thread safe: span emission is a clock read plus a
        # deque.append (atomic under the GIL), counters a single +=
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._c_ticks = self.metrics.counter("stream.ticks")
        self._c_rows = self.metrics.counter("stream.rows")
        self._c_batches = self.metrics.counter("stream.batches")
        self._source = source
        self._q: queue.Queue = queue.Queue(maxsize=queue_size)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._started = False

    # -- worker side ----------------------------------------------------------

    def _put(self, item) -> bool:
        """Bounded put that aborts when ``stop`` is requested, so an
        abandoned consumer never leaves the worker blocked forever."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _work(self):
        try:
            for tick in self._source:
                if self._stop.is_set():
                    return
                with self.tracer.span("stream.tick", events=len(tick)):
                    rows = self.inc.extend_prompts(tick)
                    if self.pack and rows:
                        rows = pack_prompts(rows, self.inc.max_len,
                                            sp=self.inc.sp)
                self._c_ticks.inc()
                self._c_rows.inc(len(rows))
                for batch in self._batches_from(rows):
                    self._c_batches.inc()
                    if not self._put(batch):
                        return
        except BaseException as e:  # noqa: BLE001 — surfaced on consumer side
            self._err = e
        finally:
            self._put(_DONE)

    def _batches_from(self, rows: List[Dict[str, np.ndarray]]):
        for lo in range(0, len(rows), self.batch_size):
            group = rows[lo: lo + self.batch_size]
            while len(group) < self.batch_size:       # fixed batch dim
                blank = dict(group[0])
                blank["target_mask"] = np.zeros_like(blank["target_mask"])
                group.append(blank)
            need = max(prompt_length(r) for r in group)
            bucket = next(b for b in self.buckets if b >= need)
            batch = {key: np.stack([r[key][:bucket] for r in group])
                     for key in group[0]}
            for r in group:
                self.stats.add_packed_row(
                    prompt_length(r), int(r["segment_ids"].max()) + 1,
                    int(r["target_mask"].sum()), bucket)
            yield batch

    # -- trainer side ---------------------------------------------------------

    def start(self) -> "StreamPipeline":
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def batches(self):
        """Yield fixed-shape batches until the source is exhausted; re-raises
        any worker-thread exception. A consumer stopping early (e.g.
        ``OnlineTrainer.run(..., n_steps=N)``) can resume from the same
        generator later, or call ``stop()`` to release the worker."""
        self.start()
        while True:
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                # normally the sentinel ends the loop; if the worker is
                # gone (stop(), or a prior iteration already consumed the
                # sentinel) an empty queue is final — never block forever
                if not self._thread.is_alive():
                    break
                continue
            if item is _DONE:
                break
            yield item
        if self._err is not None:
            raise self._err
        self._thread.join()

    def stop(self) -> None:
        """Abandon the stream: unblock and join the worker, drop queued
        batches. Targets already emitted into dropped batches were marked
        supervised by ``IncrementalDTI`` and will not be re-emitted — stop
        is for shutdown, not pause (pause = just stop consuming). A
        consumer still (or later) blocked in ``batches()`` terminates
        cleanly: a sentinel is re-enqueued after the worker dies."""
        self._stop.set()

        def drain():
            while True:
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    return

        if self._started:
            drain()                         # release a put-blocked worker
            self._thread.join()
            drain()                         # its in-flight put may have won
        self._q.put_nowait(_DONE)           # wake any (future) consumer

    def __iter__(self):
        return self.batches()


__all__ = ["StreamPipeline"]
