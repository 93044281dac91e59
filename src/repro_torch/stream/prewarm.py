"""Hot-user prefix prewarming: stream -> serve cache priming (counterpart
of ``repro.stream.prewarm``).

The paged serving cache (`serve.scheduler.ServeScheduler` with
``paged=True``) keeps committed context prefixes alive in a radix page
index even after their cache row is reused, so *any* later request that
shares the prefix maps the pages back in with zero recompute. That only
pays off if the prefix is resident when the request arrives. This module
closes the loop from the streaming side: the stream pipeline already
holds every active user's recent interaction history
(`stream.incremental.IncrementalDTI` per-user state), which is
exactly the context the serving fleet will be asked to score next — so
between training ticks it *prewarms* the scheduler with the histories of
the currently hottest users.

Prewarms are ordinary candidate-less requests (``ServeScheduler.
prewarm``): they ride the admission ladder and the prefill token budget,
never inflating a scoring wave's shape, and publish their full pages
into the radix index on completion. ``tick(swapped=True)`` skips a tick:
a weight hot-swap just invalidated every cached prefix, and the swap
tick itself is the worst moment to add prefill load — warming resumes on
the next quiet tick, repopulating the index under the new weights.

Hotness is an exponentially-decayed event count, so a user's priority
follows their recent activity rather than lifetime volume; users are
re-warmed only after new events arrive (``_warmed_at`` tracks the
history length last published — re-enqueueing an unchanged prefix is
free at admission, but skipping it saves queue churn).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from repro_torch.stream.incremental import IncrementalDTI


class PrefixPrewarmer:
    """Publishes hot users' history prefixes into a serving scheduler.

    ``dti`` supplies per-user histories (its buffered suffix — the same
    items future prompts reference); ``scheduler`` is anything with a
    ``prewarm(context) -> Optional[rid]`` method. ``top_k`` users are
    warmed per tick, ranked by decayed event count; ``min_events``
    gates users too cold to be worth a row.
    """

    def __init__(self, dti: IncrementalDTI, scheduler, *, top_k: int = 4,
                 min_events: float = 2.0, decay: float = 0.5):
        if not (top_k >= 1 and 0.0 < decay <= 1.0):
            raise ValueError(f"top_k {top_k} must be >= 1 and decay {decay} "
                             f"in (0, 1]")
        self.dti = dti
        self.scheduler = scheduler
        self.top_k = int(top_k)
        self.min_events = float(min_events)
        self.decay = float(decay)
        self._heat: Dict[int, float] = {}
        self._warmed_at: Dict[int, int] = {}
        self.warmed = 0                 # prewarm requests actually enqueued
        self.skipped_swap_ticks = 0

    def observe(self, events: Iterable[Dict]) -> None:
        """Credit each event's user with one (decaying) unit of heat.
        Call with the same event batches the pipeline feeds the DTI."""
        for ev in events:
            u = int(ev["user"])
            self._heat[u] = self._heat.get(u, 0.0) + 1.0

    def tick(self, *, swapped: bool = False) -> List[int]:
        """Warm the hottest users' prefixes; returns the enqueued rids.

        ``swapped=True`` marks a tick on which a weight hot-swap landed:
        nothing is warmed (the index was just flushed and the new
        weights' first scoring wave should not queue behind prewarm
        prefill), but every warmed-length marker is dropped so the same
        prefixes re-warm — under the new weights — on the next tick."""
        for u in list(self._heat):
            self._heat[u] *= self.decay
            if self._heat[u] < 1e-3:
                del self._heat[u]
        if swapped:
            self.skipped_swap_ticks += 1
            self._warmed_at.clear()
            return []
        hot = sorted((u for u, h in self._heat.items()
                      if h >= self.min_events),
                     key=lambda u: (-self._heat[u], u))
        rids: List[int] = []
        for u in hot[:self.top_k]:
            st = self.dti._users.get(u)
            if st is None or not st.items:
                continue
            if self._warmed_at.get(u) == st.m:
                continue                 # nothing new since the last warm
            rid: Optional[int] = self.scheduler.prewarm(st.items)
            self._warmed_at[u] = st.m
            if rid is not None:
                rids.append(rid)
                self.warmed += 1
        return rids


__all__ = ["PrefixPrewarmer"]
