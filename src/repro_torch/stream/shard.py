"""User-sharded streaming: one event stream fanned over N shard workers
(counterpart of ``repro.stream.shard``).

Scale-out for the stream half of the train->serve loop:
``shard_events`` partitions an event stream *by user*, so each shard's
``IncrementalDTI``/``StreamPipeline``/``OnlineTrainer`` stack sees every
interaction of its users in order (incremental prompt construction needs
per-user chronology; user-disjoint shards preserve it by construction)
while the shards run independently — separate hosts in production, separate
objects in tests.

Aggregation is exact, not approximate: ``StreamingAUC`` (binned count
histograms) and ``StreamingLogLoss`` (a sum and a count) merge
associatively, so the merged value over any shard partition equals the
single-shard value on the unpartitioned stream (the log-loss sums up to
float re-association). The serve side aggregates
the same way: every ``ServeScheduler`` keeps its counters in a mergeable
``MetricsRegistry``, and ``fleet_serve_snapshot`` folds per-shard
``serve.*`` snapshots into one fleet view (counters add, gauges keep the
newest, histograms add bin-wise; a histogram's float ``total`` is summed
in argument order, so it may differ in its last bits between shard
orders).
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence

from repro_torch.core.metrics import StreamingAUC, StreamingLogLoss
from repro_torch.obs.metrics import Snapshot, merge_snapshots


def shard_key(event: Dict, n_shards: int) -> int:
    """Shard index of one event: its user id mod ``n_shards`` (stable,
    stateless — any worker can route without a directory service)."""
    return int(event["user"]) % n_shards


def shard_events(ticks: Iterable[List[Dict]], n_shards: int, *,
                 key: Optional[Callable[[Dict], int]] = None
                 ) -> List[List[List[Dict]]]:
    """Partition an event stream (iterable of ticks, each a list of event
    dicts carrying ``"user"``) into ``n_shards`` per-shard streams.

    Every shard gets the *same number of ticks* (possibly empty ones), so
    shard workers stay tick-aligned with the global stream — publish
    cadences and drift windows line up across the fleet. Events within a
    tick keep their order; users never split across shards, so per-user
    chronology — the invariant ``IncrementalDTI`` builds on — holds per
    shard exactly as it did globally.

    ``key`` overrides the routing function (default: ``user % n_shards``);
    it must be stable across ticks or a user's history would tear across
    shards.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards {n_shards} must be >= 1")
    if key is None:
        key = lambda e: shard_key(e, n_shards)
    out: List[List[List[Dict]]] = [[] for _ in range(n_shards)]
    for tick in ticks:
        split: List[List[Dict]] = [[] for _ in range(n_shards)]
        for e in tick:
            s = key(e)
            if not 0 <= s < n_shards:
                raise ValueError(f"shard key {s} out of range")
            split[s].append(e)
        for s in range(n_shards):
            out[s].append(split[s])
    return out


def merged_streaming_auc(accs: Sequence[StreamingAUC]) -> StreamingAUC:
    """Fold per-shard AUC accumulators into a fresh one (inputs are not
    mutated — shards keep accumulating). Exact: the merged bin histograms
    equal the single-shard histograms over the unpartitioned stream."""
    accs = list(accs)
    if not accs:
        raise ValueError("nothing to merge")
    out = StreamingAUC(n_bins=accs[0].n_bins, lo=accs[0].lo, hi=accs[0].hi)
    for a in accs:
        out.merge(a)
    return out


def merged_streaming_log_loss(accs: Sequence[StreamingLogLoss]
                              ) -> StreamingLogLoss:
    """Fold per-shard log-loss accumulators into a fresh one (inputs are
    not mutated)."""
    accs = list(accs)
    if not accs:
        raise ValueError("nothing to merge")
    out = StreamingLogLoss(eps=accs[0].eps)
    for a in accs:
        out.merge(a)
    return out


def fleet_eval(trainers: Sequence) -> Dict[str, float]:
    """Fleet-wide progressive-validation summary over per-shard
    ``OnlineTrainer``s: lifetime AUC / log loss / target count, merged from
    the shards' accumulators."""
    auc = merged_streaming_auc([t.lifetime_auc for t in trainers])
    ll = merged_streaming_log_loss([t.lifetime_log_loss for t in trainers])
    return {"auc": auc.value(), "log_loss": ll.value(), "n_targets": auc.n}


def fleet_serve_snapshot(schedulers: Sequence) -> Snapshot:
    """One fleet-wide ``serve.*`` metrics snapshot merged from per-shard
    ``ServeScheduler`` registries (associative + commutative up to the
    summation order of histogram totals). Counter values are fleet
    totals; e.g. ``serve.steps`` is the total decode steps the fleet ran,
    ``serve.cross_row_hits`` the total radix-index admissions."""
    return merge_snapshots(*(s.metrics.snapshot(prefix="serve.")
                             for s in schedulers))


__all__ = ["shard_key", "shard_events", "merged_streaming_auc",
           "merged_streaming_log_loss", "fleet_eval",
           "fleet_serve_snapshot"]
