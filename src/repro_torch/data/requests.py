"""Synthetic serving request streams, interaction event streams, and the
prefix indexes serving uses to detect shareable contexts (a numpy copy of
``repro.data.requests``; seeded streams are byte-identical to the
reference's).

Two stream shapes, both built on the same latent-factor corpus as training
(``repro_torch.data.synthetic``):

* ``make_request_stream``  — serving requests: per page view, one user's
  recent interaction history and a slate of k candidate items to score.
  Context interactions carry their rating token, candidates are unrated
  (their click is what serving predicts). ``repeat_frac`` re-issues
  earlier contexts with fresh slates (the "same user, next page view"
  shape) so schedulers exercising cross-request prefix sharing see hits.
  Consumed by ``repro_torch.serve.scheduler.ServeScheduler.submit``.
* ``make_event_stream``    — training events: each user's *future*
  interactions replayed in chronological per-user order, interleaved
  across users and sliced into arrival ticks (for the streaming slice).

``ContextTrie`` indexes committed context token sequences so admission can
find, in O(|new context|), the deepest already-cached prefix of an
incoming request. ``RadixTree`` is its path-compressed successor: the same
owner API plus a page layer mapping full pages of committed prefixes to KV
pool pages (``repro_torch.serve.pages``), so prefixes survive row eviction
and are reusable across every cache row. The scheduler uses
``RadixTree``; ``ContextTrie`` remains as the reference hash-trie
implementation.

Determinism contract: every draw comes from one ``np.random.default_rng``
(PCG64) in a fixed, documented order, and every emitted value is a plain
Python int/list — no set/dict iteration, no float jitter — so the same
seed yields a byte-identical stream (``stream_digest`` canonicalises a
stream for comparison).
"""
from __future__ import annotations

import hashlib
import json
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.data.synthetic import CTRDataset


def make_request_stream(ds: CTRDataset, *, n_requests: int, k: int,
                        n_ctx: int, seed: int = 0,
                        repeat_frac: float = 0.0,
                        n_ctx_tail: int = None,
                        tail_alpha: float = 1.5) -> List[Dict]:
    """Draw ``n_requests`` requests: a random user's ``n_ctx`` consecutive
    interactions (with rating tokens) as context, and ``k`` random items
    (without ratings) as the candidate slate. Returns dicts with ``context``
    and ``candidates``, each a list of per-item token lists.

    ``repeat_frac`` > 0 makes that fraction of requests (after the first)
    *revisits*: the same user + context window as an earlier request but a
    freshly drawn candidate slate — the traffic shape cross-request prefix
    sharing exploits (one user paging through results, or a hot context).

    ``n_ctx_tail`` (> ``n_ctx``) switches the per-request context length
    from the constant ``n_ctx`` to a heavy-tailed draw: ``n_ctx`` plus a
    Pareto(``tail_alpha``) excess, clamped to ``n_ctx_tail`` interactions.
    Most requests stay near ``n_ctx``; a few are much longer — the
    mixed-length traffic shape whose tail a batched scheduler must not let
    one long prefill impose on every co-batched short slate (the
    heavy-tail serving workload). Alpha 1.5
    is the classic infinite-variance web-traffic tail.

    Draw order per request (fixed so seeded runs are byte-deterministic):
    [revisit coin + source index when ``repeat_frac > 0``,] [context
    length when ``n_ctx_tail`` is set,] user id, context window offset,
    then the k candidate item ids; revisits skip the length/user/offset
    draws (they copy their source's context). Defaults draw exactly the
    historical sequence, so pre-existing seeded streams are unchanged.
    """
    rng = np.random.default_rng(seed)
    out = []
    n_items = len(ds.item_tokens)
    if n_ctx_tail is not None:
        assert n_ctx_tail >= n_ctx, "n_ctx_tail must be >= n_ctx"
    for _ in range(n_requests):
        revisit = None
        if repeat_frac > 0.0 and out:
            if float(rng.random()) < repeat_frac:
                revisit = out[int(rng.integers(0, len(out)))]
        if revisit is not None:
            u = revisit["user"]
            context = [list(it) for it in revisit["context"]]
        else:
            n_i = n_ctx
            if n_ctx_tail is not None:
                n_i = min(n_ctx + int(n_ctx * float(rng.pareto(tail_alpha))),
                          n_ctx_tail)
            u = int(rng.integers(0, len(ds.sequences)))
            toks, _ = ds.user_prompt_material(u)
            assert len(toks) >= n_i, (
                f"user history {len(toks)} < context length {n_i}")
            lo = int(rng.integers(0, len(toks) - n_i + 1))
            context = [[int(t) for t in it] for it in toks[lo: lo + n_i]]
        cands = rng.integers(0, n_items, size=k)
        out.append({
            "user": u,
            "context": context,
            "candidates": [[int(t) for t in ds.item_tokens[int(i)]]
                           for i in cands],
        })
    return out


class ContextTrie:
    """Hash-trie over context token sequences -> opaque owner handles.

    Serving admission asks one question per incoming request: *of the
    context blocks currently committed in the KV cache, which shares the
    longest prefix with this request's context, and does any of them end
    inside it?* The trie answers in O(|context|): nodes are hash maps
    keyed by token id; each node records the owners whose full context
    **ends** there and the owners whose context **passes through** it.

    Owners are opaque hashables (the scheduler uses cache row ids). One
    owner owns at most one sequence at a time — re-inserting an owner
    under a new sequence requires removing the old one first (the
    scheduler does this when it extends or trims a retained context).
    """

    def __init__(self):
        self._root = self._node()
        self._len: Dict[object, int] = {}       # owner -> |its sequence|

    @staticmethod
    def _node() -> Dict:
        return {"kids": {}, "ends": set(), "through": set()}

    def __len__(self) -> int:
        return len(self._len)

    def owner_length(self, owner) -> int:
        """Length of the sequence ``owner`` currently owns (KeyError if
        absent)."""
        return self._len[owner]

    def insert(self, tokens: Sequence[int], owner) -> None:
        assert owner not in self._len, f"owner {owner!r} already in trie"
        node = self._root
        node["through"].add(owner)
        for t in tokens:
            node = node["kids"].setdefault(int(t), self._node())
            node["through"].add(owner)
        node["ends"].add(owner)
        self._len[owner] = len(tokens)

    def remove(self, tokens: Sequence[int], owner) -> None:
        assert self._len.get(owner) == len(tokens), (
            f"owner {owner!r} does not own a length-{len(tokens)} sequence")
        node, path = self._root, []
        node["through"].discard(owner)
        for t in tokens:
            path.append((node, int(t)))
            node = node["kids"][int(t)]
            node["through"].discard(owner)
        node["ends"].discard(owner)
        del self._len[owner]
        # prune now-unowned branches so the trie stays O(live contexts)
        for parent, t in reversed(path):
            child = parent["kids"][t]
            if not child["through"]:
                del parent["kids"][t]

    def match(self, tokens: Sequence[int]) -> Tuple[int, set, int, set]:
        """Walk ``tokens`` as deep as the trie goes.

        Returns ``(end_depth, end_owners, through_depth, through_owners)``:

        * ``end_owners`` — owners whose **entire** sequence is a prefix of
          ``tokens``, at the deepest such depth ``end_depth`` (these can be
          reused as-is: commit/score only the suffix);
        * ``through_owners`` — owners passing through the deepest reachable
          node at ``through_depth`` (their sequences share the first
          ``through_depth`` tokens with ``tokens`` but continue past it —
          reusable only by trimming back to the shared prefix).

        Empty sets / depth 0 when nothing matches. In particular a
        first-token mismatch reports ``through_owners == set()``, *not* the
        root's through set (which holds every owner): a depth-0 "match"
        shares nothing, so there is nothing to reuse.
        """
        node = self._root
        end_depth, end_owners = 0, set()
        depth = 0
        for t in tokens:
            nxt = node["kids"].get(int(t))
            if nxt is None:
                break
            node = nxt
            depth += 1
            if node["ends"]:
                end_depth, end_owners = depth, set(node["ends"])
        if depth == 0:
            return end_depth, end_owners, 0, set()
        return end_depth, end_owners, depth, set(node["through"])


class _RadixNode:
    """One path-compressed node: the edge from its parent spans logical
    depths ``(start, start + len(edge)]``."""

    __slots__ = ("edge", "start", "kids", "ends", "through", "pages",
                 "last_used", "parent")

    def __init__(self, edge: List[int], start: int, parent):
        self.edge = edge            # token label on the edge from parent
        self.start = start          # depth at which this edge begins
        self.kids: Dict[int, "_RadixNode"] = {}   # first edge token -> child
        self.ends = set()           # owners whose sequence ends at self.end
        self.through = set()        # owners whose sequence covers >= self.end
        self.pages: Dict[int, int] = {}   # page index -> pool page id
        self.last_used = 0
        self.parent = parent

    @property
    def end(self) -> int:
        return self.start + len(self.edge)


class RadixTree:
    """Path-compressed radix tree over context token sequences, with an
    optional **page layer** indexing the KV-cache pages that hold each
    full page of a committed prefix (see ``repro_torch.serve.pages.PagePool``).

    Drop-in upgrade of :class:`ContextTrie` for the scheduler's admission
    ladder: the owner API (``insert``/``remove``/``match``/
    ``owner_length``) has identical semantics — including the fixed
    depth-0 contract: a first-token mismatch returns empty owner sets,
    never the root's — but nodes are O(live branching points), not O(live
    tokens). On top of it, three page-layer calls make prefixes reusable
    across *all* rows, not just rows whose block is still retained:

    * ``attach_pages(tokens, pages)`` — publish the pool pages holding the
      full pages of ``tokens`` (the index takes one pool reference per
      page it newly adopts; the caller performs the incref).
    * ``match_pages(tokens)`` — longest contiguous indexed page run
      covering a prefix of ``tokens`` (what a new admission can map into
      its page table instead of recomputing).
    * ``evict_pages(need, page_ref)`` — reclaim least-recently-used pages
      held *only* by the index (pool refcount 1), deepest-first within a
      node so contiguous prefixes shrink from the tail.

    Page nodes may outlive their owners (a stolen row's prefix stays
    indexed until evicted); owner removal never prunes a node that still
    holds pages.
    """

    def __init__(self, page_size: int = 0):
        self._root = _RadixNode([], 0, None)
        self._len: Dict[object, int] = {}       # owner -> |its sequence|
        self._page_size = int(page_size)
        self._clock = 0

    def __len__(self) -> int:
        return len(self._len)

    def owner_length(self, owner) -> int:
        """Length of the sequence ``owner`` currently owns (KeyError if
        absent)."""
        return self._len[owner]

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _split(self, child: _RadixNode, j: int) -> _RadixNode:
        """Split ``child``'s edge after ``j`` tokens; return the new upper
        node. Owners and pages redistribute by the spans they cover."""
        parent = child.parent
        upper = _RadixNode(child.edge[:j], child.start, parent)
        parent.kids[upper.edge[0]] = upper
        child.edge = child.edge[j:]
        child.start += j
        child.parent = upper
        upper.kids[child.edge[0]] = child
        # every owner below the split covers the upper span too; nobody can
        # end exactly at the new boundary yet (that would have split earlier)
        upper.through = set(child.through)
        upper.last_used = child.last_used
        if self._page_size:
            ps = self._page_size
            moved = [p for p in child.pages if (p + 1) * ps <= upper.end]
            for p in moved:
                upper.pages[p] = child.pages.pop(p)
        return upper

    def _extend_path(self, tokens: Sequence[int]) -> List[_RadixNode]:
        """Create/split nodes so the path spelling ``tokens`` ends on a node
        boundary; return the nodes along it (root excluded), each fully
        covered by ``tokens``."""
        node, i, n = self._root, 0, len(tokens)
        path: List[_RadixNode] = []
        while i < n:
            t = int(tokens[i])
            child = node.kids.get(t)
            if child is None:
                child = _RadixNode([int(x) for x in tokens[i:]], i, node)
                node.kids[t] = child
                path.append(child)
                return path
            e = child.edge
            j, m = 0, min(len(e), n - i)
            while j < m and e[j] == int(tokens[i + j]):
                j += 1
            if j == len(e):
                path.append(child)
                node, i = child, i + j
                continue
            upper = self._split(child, j)
            path.append(upper)
            if i + j == n:
                return path
            node, i = upper, i + j
            # next iteration diverges from the lower half -> fresh leaf
        return path

    def insert(self, tokens: Sequence[int], owner) -> None:
        assert owner not in self._len, f"owner {owner!r} already in tree"
        clock = self._tick()
        self._root.through.add(owner)
        path = self._extend_path(tokens)
        for nd in path:
            nd.through.add(owner)
            nd.last_used = clock
        (path[-1] if path else self._root).ends.add(owner)
        self._len[owner] = len(tokens)

    def _maybe_prune(self, node: _RadixNode) -> None:
        while (node is not self._root and not node.through and not node.ends
               and not node.kids and not node.pages):
            parent = node.parent
            del parent.kids[node.edge[0]]
            node = parent

    def remove(self, tokens: Sequence[int], owner) -> None:
        assert self._len.get(owner) == len(tokens), (
            f"owner {owner!r} does not own a length-{len(tokens)} sequence")
        self._root.through.discard(owner)
        node, i = self._root, 0
        while i < len(tokens):
            child = node.kids[int(tokens[i])]
            assert child.edge == [int(t) for t in
                                  tokens[i:i + len(child.edge)]], (
                "owner path must lie on node boundaries")
            child.through.discard(owner)
            node, i = child, i + len(child.edge)
        node.ends.discard(owner)
        del self._len[owner]
        self._maybe_prune(node)

    def match(self, tokens: Sequence[int]) -> Tuple[int, set, int, set]:
        """Identical contract to :meth:`ContextTrie.match` — see its
        docstring; depth 0 always reports empty owner sets."""
        node, i, n = self._root, 0, len(tokens)
        depth, thr = 0, set()
        end_depth, end_owners = 0, set()
        clock = self._tick()
        while i < n:
            child = node.kids.get(int(tokens[i]))
            if child is None:
                break
            e = child.edge
            j, m = 0, min(len(e), n - i)
            while j < m and e[j] == int(tokens[i + j]):
                j += 1
            child.last_used = clock
            depth = i + j
            thr = child.through
            i += j
            if j < len(e):
                break
            if child.ends:
                end_depth, end_owners = depth, set(child.ends)
            node = child
        if depth == 0:
            return 0, set(), 0, set()
        return end_depth, end_owners, depth, set(thr)

    # -- page layer ---------------------------------------------------------

    def attach_pages(self, tokens: Sequence[int],
                     pages: Sequence[int]) -> List[int]:
        """Index pool pages covering ``tokens[:len(pages) * page_size]``;
        ``pages[i]`` holds tokens ``[i*ps, (i+1)*ps)``. Returns the page
        ids *newly* adopted (the caller takes one pool reference per
        returned id); indices already indexed keep their existing id."""
        ps = self._page_size
        assert ps > 0, "tree built without a page_size"
        assert len(tokens) >= len(pages) * ps
        path = self._extend_path([int(t) for t in tokens[:len(pages) * ps]])
        clock = self._tick()
        new: List[int] = []
        k = 0
        for nd in path:
            nd.last_used = clock
            while k < len(pages) and (k + 1) * ps <= nd.end:
                if k not in nd.pages:
                    nd.pages[k] = int(pages[k])
                    new.append(int(pages[k]))
                k += 1
        assert k == len(pages)
        return new

    def match_pages(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """Longest contiguous indexed page run covering a prefix of
        ``tokens``: returns ``(covered_tokens, page_ids)`` with
        ``covered_tokens == len(page_ids) * page_size``."""
        ps = self._page_size
        assert ps > 0, "tree built without a page_size"
        node, i, n = self._root, 0, len(tokens)
        clock = self._tick()
        got: List[int] = []
        while i < n:
            child = node.kids.get(int(tokens[i]))
            if child is None:
                break
            e = child.edge
            j, m = 0, min(len(e), n - i)
            while j < m and e[j] == int(tokens[i + j]):
                j += 1
            child.last_used = clock
            depth = i + j
            while ((len(got) + 1) * ps <= depth
                   and len(got) in child.pages):
                got.append(child.pages[len(got)])
            if j < len(e) or (len(got) + 1) * ps <= depth:
                break                     # diverged, exhausted, or page gap
            node, i = child, depth
        return len(got) * ps, got

    def evict_pages(self, need: int, page_ref) -> List[int]:
        """Drop up to ``need`` least-recently-used pages held only by the
        index (``page_ref[pid] == 1``), deepest-first within a node.
        Returns the evicted page ids; the caller releases the pool
        reference for each."""
        nodes, stack = [], [self._root]
        while stack:
            nd = stack.pop()
            stack.extend(nd.kids.values())
            if nd.pages:
                nodes.append(nd)
        nodes.sort(key=lambda nd: (nd.last_used, -nd.start))
        out: List[int] = []
        for nd in nodes:
            if len(out) >= need:
                break
            for pidx in sorted(nd.pages, reverse=True):
                if len(out) >= need:
                    break
                pid = nd.pages[pidx]
                if page_ref[pid] == 1:
                    del nd.pages[pidx]
                    out.append(pid)
            self._maybe_prune(nd)
        return out

    def drop_pages(self, tokens: Sequence[int], from_page: int) -> List[int]:
        """Un-index the pages covering ``tokens[from_page * page_size:]``
        (global page index ``>= from_page`` along the matching path).
        Returns the dropped page ids; the caller releases the index's
        pool reference for each. Used when a trim needs to recommit into
        a partially-covered boundary page: dropping the boundary (and the
        now-unreachable deeper pages behind it) makes it private again,
        so the rewrite cannot corrupt a prefix some future adoption would
        map in. Pages other rows still read keep their row references —
        only the index's hold is released."""
        ps = self._page_size
        assert ps > 0, "tree built without a page_size"
        node, i, n = self._root, 0, len(tokens)
        out: List[int] = []
        touched: List[_RadixNode] = []
        while i < n:
            child = node.kids.get(int(tokens[i]))
            if child is None:
                break
            e = child.edge
            j, m = 0, min(len(e), n - i)
            while j < m and e[j] == int(tokens[i + j]):
                j += 1
            touched.append(child)
            for pidx in [p for p in child.pages if p >= from_page]:
                out.append(child.pages.pop(pidx))
            if j < len(e):
                break
            node, i = child, i + j
        for nd in reversed(touched):
            self._maybe_prune(nd)
        return out

    def drop_all_pages(self) -> List[int]:
        """Flush the whole page layer (weight hot-swap: indexed KV was
        computed under the old parameters). Returns every held page id."""
        out, stack, seen = [], [self._root], []
        while stack:
            nd = stack.pop()
            stack.extend(nd.kids.values())
            seen.append(nd)
            out.extend(nd.pages.values())
            nd.pages.clear()
        for nd in reversed(seen):
            self._maybe_prune(nd)
        return out

    def held_pages(self) -> int:
        """Number of pages currently held by the index (telemetry)."""
        n, stack = 0, [self._root]
        while stack:
            nd = stack.pop()
            stack.extend(nd.kids.values())
            n += len(nd.pages)
        return n


def make_event_stream(ds: CTRDataset, *, n_ticks: int,
                      start_frac: float = 0.5, end_frac: float = 1.0,
                      seed: int = 0) -> List[List[Dict]]:
    """Replay a slice of every user's history as a stream of arrival ticks.

    Interactions before ``start_frac`` of each user's timeline are the warm
    corpus (seed them into the incremental builder / pretrain on them);
    those from ``end_frac`` on are held back (an untouched chronological
    tail for evaluation); the rest become events. Per-user chronology is preserved — user u's i-th
    event always precedes their (i+1)-th — while users interleave in a
    seeded random order (one global shuffle of (user, slot) pairs, then a
    stable per-user reorder). The flat order is sliced into ``n_ticks``
    near-equal chunks.

    Each event is ``{"user", "index", "item_tokens", "label"}`` where
    ``index`` is the interaction's absolute position in the user's history
    and ``item_tokens`` includes the rating token (the same per-interaction
    material training prompts are built from).
    """
    assert n_ticks > 0 and 0.0 <= start_frac < end_frac <= 1.0
    rng = np.random.default_rng(seed)
    events: List[Dict] = []
    pending: List[List[Dict]] = []
    for u in range(len(ds.sequences)):
        toks, labels = ds.user_prompt_material(u)
        start = int(len(toks) * start_frac)
        end = int(len(toks) * end_frac)
        pending.append([
            {"user": u, "index": i,
             "item_tokens": [int(t) for t in toks[i]],
             "label": int(labels[i])}
            for i in range(start, end)])
    owners = np.repeat(np.arange(len(pending)),
                       [len(p) for p in pending])
    rng.shuffle(owners)
    cursor = [0] * len(pending)
    for u in owners:                       # per-user order preserved
        events.append(pending[u][cursor[u]])
        cursor[u] += 1
    n = len(events)
    ticks, lo = [], 0
    for t in range(n_ticks):
        hi = (n * (t + 1)) // n_ticks
        ticks.append(events[lo:hi])
        lo = hi
    return ticks


def warm_histories(ds: CTRDataset, *, start_frac: float = 0.5):
    """The warm prefix ``make_event_stream`` does not replay: per user,
    (per-interaction token lists, labels) up to ``start_frac``."""
    out = []
    for u in range(len(ds.sequences)):
        toks, labels = ds.user_prompt_material(u)
        start = int(len(toks) * start_frac)
        out.append(([[int(t) for t in it] for it in toks[:start]],
                    [int(l) for l in labels[:start]]))
    return out


def stream_digest(stream) -> str:
    """Canonical sha256 of a request/event stream (nested python
    ints/lists/dicts; dict keys sorted) — the byte-determinism regression
    check: same seed, same digest."""
    blob = json.dumps(stream, sort_keys=True, separators=(",", ":"),
                      default=int).encode()
    return hashlib.sha256(blob).hexdigest()


__all__ = ["make_request_stream", "ContextTrie", "RadixTree",
           "make_event_stream", "warm_histories", "stream_digest"]
