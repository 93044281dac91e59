"""Incremental DTI prompt construction over growing user histories.

The paper's cost argument is really about *retraining*: sliding-window
training costs O(m·n²) tokens for a user with m interactions, and
production histories never stop growing. Batch DTI cuts one full pass to
O(m·n); this module applies the same k-target packing *incrementally*, so
keeping a model fresh as Δm new interactions arrive costs O(Δm·(n+k))
supervised tokens instead of re-deriving (and re-training) the full
corpus.

Counterpart of ``repro.stream.incremental``; rows are byte-identical to
the reference's for the same events. Group geometry is identical to
``core.dti.build_streaming_prompts``:
target interactions (absolute index ≥ n_ctx) partition into stride-k
groups; group g starts at ``n_ctx + g·k`` and its prompt is

    [BOS] ctx(n_ctx items)  t_gs [SUM]  t_gs+1 [SUM]  ...

Crucially the group boundaries depend only on (n_ctx, k) — never on the
current history length — so a group's prompt converges to exactly the row
a full rebuild would produce. When new events land, the builder re-emits
each *affected* group with every target present (old targets keep their
[SUM] tokens, labels and geometry: under causal attention they are context
for the new ones) but supervises only the newly arrived targets via a
``target_mask`` field layered on the canonical batch schema. The loss
masks on ``target_mask`` while the forward still sees ``is_sum``, so each
supervised (target, context) pair — and, packed, each gradient — is
identical to rebuilding the full DTI corpus and keeping only the new
targets.

Per-user state is trimmed to the suffix future groups can reference
(≤ n_ctx + k interactions), so memory is O(users·(n_ctx+k)), not O(m).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

import numpy as np

from repro_torch.core.dti import PromptStats, SpecialTokens, _pack, _pad_to


@dataclasses.dataclass
class _UserState:
    base: int = 0                      # absolute index of items[0]
    items: List[List[int]] = dataclasses.field(default_factory=list)
    labels: List[int] = dataclasses.field(default_factory=list)
    supervised: int = 0                # targets with index < this are trained

    @property
    def m(self) -> int:
        return self.base + len(self.items)


class IncrementalDTI:
    """Per-user history state + ``extend_prompts``.

    ``extend_prompts(events)`` consumes interaction events (dicts with
    ``user``, ``item_tokens``, ``label`` — ``data.requests.
    make_event_stream``'s schema) and returns canonical-schema rows (plus
    ``target_mask``) supervising exactly the targets that had not been
    supervised before. ``seed_history`` installs a warm corpus the model
    was already trained on (its targets are marked supervised and never
    re-emitted).
    """

    def __init__(self, *, n_ctx: int, k: int, max_len: int,
                 sp: SpecialTokens = SpecialTokens(),
                 stats: Optional[PromptStats] = None):
        if not (n_ctx > 0 and k > 0):
            raise ValueError(f"n_ctx {n_ctx} and k {k} must be positive")
        self.n_ctx = n_ctx
        self.k = k
        self.max_len = max_len
        self.sp = sp
        self.stats = stats if stats is not None else PromptStats()
        self._users: Dict[int, _UserState] = {}

    # -- state ---------------------------------------------------------------

    def seed_history(self, user: int, item_tokens: List[List[int]],
                     labels: List[int], *, supervised: bool = True) -> None:
        if user in self._users:
            raise ValueError(f"user {user} already seeded")
        st = _UserState(items=[list(t) for t in item_tokens],
                        labels=[int(l) for l in labels])
        if supervised:
            st.supervised = st.m
        self._users[user] = st
        self._trim(st)

    def user_count(self) -> int:
        return len(self._users)

    def buffered_interactions(self, user: int) -> int:
        """Interactions currently held for ``user`` (bounded by n_ctx+k)."""
        return len(self._users[user].items)

    # -- the streaming step --------------------------------------------------

    def extend_prompts(self, events: Iterable[Dict]
                       ) -> List[Dict[str, np.ndarray]]:
        """Append events to their users' histories and emit one row per
        affected group, supervising only the newly arrived targets."""
        touched: List[int] = []
        seen = set()
        for ev in events:
            u = int(ev["user"])
            st = self._users.get(u)
            if st is None:
                st = self._users[u] = _UserState()
            if "index" in ev and int(ev["index"]) != st.m:
                # a dropped or redelivered event would silently shift every
                # later target's context
                raise ValueError(
                    f"user {u}: event index {ev['index']} != expected "
                    f"{st.m}")
            st.items.append([int(t) for t in ev["item_tokens"]])
            st.labels.append(int(ev["label"]))
            if u not in seen:             # first-event order, each user once
                seen.add(u)
                touched.append(u)
        rows: List[Dict[str, np.ndarray]] = []
        for u in touched:
            rows.extend(self._emit(self._users[u]))
        return rows

    # -- internals -----------------------------------------------------------

    def _emit(self, st: _UserState) -> List[Dict[str, np.ndarray]]:
        n_ctx, k, sp = self.n_ctx, self.k, self.sp
        m = st.m
        s = max(st.supervised, n_ctx)     # first unsupervised target index
        if m <= n_ctx or s >= m:
            self._trim(st)
            return []
        rows = []
        g_lo = (s - n_ctx) // k
        g_hi = (m - 1 - n_ctx) // k
        for g in range(g_lo, g_hi + 1):
            gs = n_ctx + g * k
            toks: List[int] = [sp.bos]
            for j in range(gs - n_ctx, gs):
                toks.extend(st.items[j - st.base])
            is_sum = [False] * len(toks)
            lab = [0] * len(toks)
            tmask = [False] * len(toks)
            n_new = 0
            for t in range(gs, min(gs + k, m)):
                it = st.items[t - st.base]
                toks.extend(it)
                is_sum.extend([False] * len(it))
                lab.extend([0] * len(it))
                tmask.extend([False] * len(it))
                toks.append(sp.sum)
                is_sum.append(True)
                lab.append(int(st.labels[t - st.base]))
                new = t >= s
                tmask.append(new)
                n_new += int(new)
            row = _pack(toks, is_sum, lab, self.max_len, sp)
            row["target_mask"] = _pad_to(np.asarray(tmask, bool),
                                         self.max_len, False)
            self.stats.add(len(toks), n_new)
            rows.append(row)
        st.supervised = m
        self._trim(st)
        return rows

    def _trim(self, st: _UserState) -> None:
        # keep from the start of the group the next *unemitted* target
        # belongs to, minus its context — everything older is never
        # referenced again. The anchor is the first unsupervised target (a
        # supervised=False seed keeps its whole pending history until
        # emitted), or m when nothing is pending (the next future target).
        anchor = min(max(st.supervised, self.n_ctx), st.m)
        gs_next = self.n_ctx + self.k * max(0, (anchor - self.n_ctx)
                                            // self.k)
        keep_from = max(st.base, gs_next - self.n_ctx)
        drop = keep_from - st.base
        if drop > 0:
            del st.items[:drop]
            del st.labels[:drop]
            st.base = keep_from


__all__ = ["IncrementalDTI"]
