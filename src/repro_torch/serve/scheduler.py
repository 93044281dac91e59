"""Continuous-batching CTR serving with shared-context KV reuse,
cross-request prefix sharing, token-budgeted chunked prefill and
one-step-ahead overlap scheduling (the port of ``repro.serve.scheduler``;
the same stream gives the same steps, admissions and telemetry counters).

The paper's training trick — isolate k targets against one shared context
instead of re-encoding the context k times — applied at inference. A request
is one user context plus k candidate items; the end-to-end LLM-ranker
deployment shape (one user, many candidates per page view). Per request the
scheduler:

  1. prefills the context once into the request's cache rows (committed
     decode chunks — decode == prefill);
  2. scores candidates as *non-committing bursts*: a burst attends the
     cached context plus itself, reads p(click) at each [SUM] slot, and
     leaves the cache's pos/cursor untouched — the next burst sees the
     pristine context again. As many candidates as fit the largest bucket
     ride one burst, isolated from each other by in-burst segment ids
     (the decode-side analog of the training paradigm's k isolated
     targets), so a whole slate usually costs one decode step.

On top of the per-request reuse, **cross-request prefix sharing** reuses
context KV *between* requests (``share_prefix=True``): committed context
blocks are refcounted (`repro_torch.serve.cache`), indexed by a radix
tree (`repro_torch.data.requests.RadixTree`), and retained after their request
finishes instead of being freed. Admission matches an incoming context
against the trie and reuses the best block — see ``_try_place`` for the
exact policy ladder. Two users with a common context prefix (or one user
paging through result slates) then share one KV copy; step 1 shrinks to
the unshared suffix, or disappears entirely.

Continuous batching: a fixed-capacity batched cache (``n_slots`` rows x
``capacity`` token slots); requests are admitted into rows as they arrive
and a row returns to the reusable pool the moment its last candidate is
scored, so short requests never wait for long ones. Every step feeds one
work unit per busy row, right-padded to a fixed bucket length — the
decode step only ever sees ``len(buckets)`` shapes. ``attn_impl="cuda"``
runs every step through the hand-written decode-attention kernel
(`repro_torch.kernels.decode_attn`, its int8 mode on an int8 cache)
instead of the dense einsums.

Two hot-path policies keep the batched step latency-uniform under
mixed-length traffic (the tail-latency killer: one long user history
stalling every co-batched short slate):

* **Token-budgeted chunked prefill.** Pending context commits are held as
  *resumable* per-slot prefill state (`_Prefill`), not pre-cut chunks.
  Each step packs decode bursts first — they alone pick the wave's bucket
  — then cuts prefill chunks to whatever fits ``min(bucket,
  prefill_budget)``. A long prefill therefore rides along a few tokens at
  a time without ever inflating the wave's shape, and resumes
  mid-context on the next step. (``monolithic_prefill=True`` restores the
  pre-budget behaviour — largest-bucket chunks that drag every
  co-scheduled burst into the largest shape — as a reference mode.)
* **One-step-ahead overlap.** The decode step is dispatched async; its
  scores are *not* synced before the next step is built and dispatched
  from already-decided host state. Harvest (the only device sync: it
  waits on an event recorded after the step's scores were copied to
  pinned host memory) runs one step behind, so admission, unit packing
  and row bookkeeping overlap the device step instead of serializing with
  it. The reference threads the cache through every jitted call as a
  value; here the decode step and the row operations update the cache's
  tensors in place, all on one stream, in the order the reference calls
  them — so device-side ordering (commit-before-burst, trim-before-
  recommit) is stream order, never a host sync. Host arrays reach the
  device through pinned staging copies made at upload time, so the
  scheduler may mutate its own arrays (page tables, wave buffers) while a
  copy is still in flight.

Cost: per request O(n^2 + k·n·s) attention reads instead of the O(k·n^2) of
re-prefilling the context per candidate — less again whatever prefix
sharing removes; ``RequestResult.cached_tokens`` tracks the prompt tokens
served from cache (own-context reuse + shared prefixes) instead of
recomputed. ``telemetry()`` reports queue depth, per-bucket step counts,
prefill-budget utilization and watchdog state; ``RequestResult`` splits
latency into ``queue_s`` (submit → admitted) and ``service_s`` (admitted →
last score) so tail regressions are attributable.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from contextlib import nullcontext
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.dti import SpecialTokens
from repro_torch.data.requests import RadixTree
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import ModelConfig
from repro_torch.obs import profile as obs_profile
from repro_torch.obs.clock import monotonic
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serve.cache import (adopt_slots, free_slots, init_lm_cache,
                                     kv_cache_bytes, kv_token_bytes,
                                     retain_slots, trim_slots)
from repro_torch.serve.engine import make_decode_fn
from repro_torch.serve.pages import PagePool

_NULLCTX = nullcontext()

#: Lifecycle schema of every key ``telemetry()`` may report. ``kind``:
#: ``counter`` (accumulates, zeroed by ``reset_telemetry``), ``derived``
#: (computed from counters, falls to its documented reset value),
#: ``state`` (live cache/pool occupancy — reset does not touch it),
#: ``config`` (construction-time constant). ``reset`` is the exact
#: post-``reset_telemetry()`` value for resettable keys
#: ("zero_map" = dict with every value 0). The keys are the reference's;
#: ``mesh``, ``drain_before_swap`` and the swap-drain counters report the
#: knobs that wait for later slices (None, False, 0).
TELEMETRY_SCHEMA: Dict[str, Dict[str, Any]] = {
    "steps": {"kind": "counter", "reset": 0},
    "overlap": {"kind": "config"},
    "bucket_steps": {"kind": "counter", "reset": "zero_map"},
    "queue_depth_mean": {"kind": "derived", "reset": 0.0},
    "queue_depth_max": {"kind": "counter", "reset": 0},
    "prefill_budget": {"kind": "config"},
    "prefill_tokens": {"kind": "counter", "reset": 0},
    "prefill_steps": {"kind": "counter", "reset": 0},
    "budget_utilization": {"kind": "derived", "reset": None},
    "prefill_starved_steps": {"kind": "counter", "reset": 0},
    "watchdog_fired": {"kind": "counter", "reset": 0},
    "watchdog_rows": {"kind": "counter", "reset": []},
    "watchdog_stuck_rids": {"kind": "counter", "reset": []},
    "paged": {"kind": "config"},
    "cross_row_hits": {"kind": "counter", "reset": 0},
    "cross_row_tokens": {"kind": "counter", "reset": 0},
    "prefix_hit_rate": {"kind": "derived", "reset": 0.0},
    "kv_dtype": {"kind": "config"},
    "kv_bytes": {"kind": "state"},
    "kv_token_bytes": {"kind": "config"},
    "kv_bytes_committed": {"kind": "counter", "reset": 0},
    "page_size": {"kind": "config"},
    "pages_in_use": {"kind": "state"},
    "pages_free": {"kind": "state"},
    "page_evictions": {"kind": "counter", "reset": 0},
    "radix_pages": {"kind": "state"},
    "pool_capacity_tokens": {"kind": "config"},
    "pool_bytes": {"kind": "config"},
    "mesh": {"kind": "config"},
    "drain_before_swap": {"kind": "config"},
    "swap_drains": {"kind": "counter", "reset": 0},
    "swap_drain_steps": {"kind": "counter", "reset": 0},
}


@dataclasses.dataclass
class RequestResult:
    rid: int
    scores: List[float]                # p(click) per candidate, in order
    latency_s: float                   # submit -> last candidate scored
                                       # (== queue_s + service_s)
    queue_s: float                     # submit -> admitted onto a row
    service_s: float                   # admitted -> last candidate scored
    context_tokens: int                # logical context length n (incl. BOS)
    prefill_tokens: int                # context tokens this request committed
    burst_tokens: int                  # tokens fed in non-committing bursts
                                       # (candidates + [SUM] + suffix copies)
    shared_prefix_tokens: int          # context prefix reused from another
                                       # request's committed block
    cached_tokens: int                 # logical prompt tokens served from
                                       # cache: logical - (prefill + burst)
    logical_tokens: int                # what k independent prefills compute
    params_versions: List[Optional[int]] = dataclasses.field(
        default_factory=list)          # every weight version some work unit
                                       # of this request was dispatched
                                       # under, sorted; len > 1 means the
                                       # request straddled a hot-swap

    @property
    def cache_hit_fraction(self) -> float:
        """Fraction of the logical prompt tokens (k x context+candidate)
        that were read from cache instead of recomputed — own-context
        reuse across the k candidates plus any cross-request shared
        prefix."""
        return self.cached_tokens / max(self.logical_tokens, 1)


@dataclasses.dataclass
class _Unit:
    """One fixed-shape step's worth of work for one slot."""
    tokens: np.ndarray                 # (n,) int32
    positions: np.ndarray              # (n,) int32
    is_sum: np.ndarray                 # (n,) bool
    seg: np.ndarray                    # (n,) int32; -1 shared, else candidate
    commit: bool                       # context chunk (True) vs burst (False)
    score_at: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
                                       # (candidate idx, offset) per [SUM]


@dataclasses.dataclass
class _Prefill:
    """Resumable committed-context work: ``tokens`` land at positions
    ``start .. start+len-1``; ``done`` of them have already been cut into
    dispatched chunks. Chunk size is decided per step (`_build_wave`) from
    the wave's bucket and the prefill token budget — never fixed at
    admission — so a long context commits across many small steps."""
    tokens: List[int]
    start: int
    done: int = 0

    @property
    def remaining(self) -> int:
        return len(self.tokens) - self.done


@dataclasses.dataclass
class _Slot:
    """One in-flight request (possibly one of several sharing a row)."""
    rid: int
    row: int
    units: deque                       # its remaining burst _Units, FIFO
    prefill: Optional[_Prefill]        # resumable context commit (None when
                                       # nothing to commit)
    context: List[int]                 # full flattened context incl. [BOS]
                                       # (kept for mid-prefill restart on a
                                       # weight hot-swap)
    scores: List[Optional[float]]
    submit_t: float
    admit_t: float                     # when the request landed on its row
    n_context: int                     # logical context length n
    prefill_tokens: int
    burst_tokens: int                  # all non-commit feeds (suffix copies
                                       # included)
    slate_tokens: int                  # sum(len(cand) + 1) — the logical
                                       # candidate+[SUM] feed
    shared_prefix_tokens: int
    n_candidates: int
    versions: set = dataclasses.field(default_factory=set)
                                       # params versions its dispatches ran
                                       # under (RequestResult.params_versions)


@dataclasses.dataclass
class _Row:
    """Host-side state of one cache row (one batch index of the KV cache).

    ``committed`` is the row's context block — the token sequence whose KV
    occupies slots ``0..len-1`` once ``pending_commit`` reaches 0 (the
    number of active slots whose prefill has not fully dispatched; a row
    is *sharable* only at ``pending_commit == 0``, enforced by
    ``_try_place``). ``active`` are the requests currently scoring bursts
    against the block; ``retained`` marks an inactive row whose block is
    kept (and refcounted) for future prefix reuse. The cache-side refcount
    invariant is ``ref == len(active) + retained``.
    """
    committed: List[int] = dataclasses.field(default_factory=list)
    pending_commit: int = 0
    active: List[_Slot] = dataclasses.field(default_factory=list)
    retained: bool = False
    stale: bool = False                # KV predates a weight swap: keep
                                       # serving in-flight readers, never
                                       # share with or retain for new ones
    last_used: int = 0                 # step counter, for LRU steal
    last_progress: int = 0             # step counter, for the watchdog
    rr: int = 0                        # round-robin pointer over active


class _Scores:
    """A dispatched step's p_click on its way to the host. On the card the
    scores are copied into pinned host memory right after the step is
    enqueued and an event is recorded behind the copy: ``is_ready`` polls
    it, ``get`` waits for it alone (not for steps enqueued later), which
    keeps one step in flight under ``overlap``."""

    def __init__(self, p: torch.Tensor):
        self._event = None
        if p.is_cuda:
            self._host = torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
            self._host.copy_(p, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = p

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def get(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.float().numpy()


class ServeScheduler:
    """Continuous-batching multi-target CTR scorer.

    ``submit`` enqueues a request (context = per-interaction token lists,
    candidates = per-candidate token lists); ``run`` drains queue and rows
    and returns {rid: RequestResult}. ``step`` advances one batched decode
    step (exposed for tests). The decode step sees one shape per bucket
    length; admission/eviction are O(rows) host bookkeeping plus int32
    refcount/pos/cursor updates on the touched rows (never KV traffic).

    ``share_prefix=True`` (default) enables cross-request prefix sharing:
    finished contexts are retained and refcounted, and admission reuses
    the longest matching committed prefix (`_try_place`). Shared requests
    score bit-identically to unshared ones — sharing changes which cache
    row a burst reads, never what the burst attends. ``min_shared_prefix``
    sets the shortest prefix worth reusing (every context starts with
    [BOS], so a floor of 1 would "share" almost nothing of value while
    trimming away retained blocks).

    ``attn_impl`` picks the decode attention path ("dense", "cuda", or
    None = follow ``cfg.attn_impl``); see ``make_decode_fn``. ``kv_dtype``
    None keeps KV in ``cache_dtype`` (which must be the model's compute
    dtype on the kernel path); "int8" stores codes plus scales, which the
    kernel's int8 mode reads. ``device`` None means the card: without one
    the scheduler raises unless given ``device="cpu"``.

    Scheduling policy knobs:

    * ``prefill_budget`` — max committed context tokens dispatched per
      step, across all rows (None = one largest-bucket worth,
      ``buckets[-1]``). Decode bursts are packed first and alone size the
      wave's bucket; prefill chunks are then cut to
      ``min(bucket, budget remaining)``, so prefill progress rides along
      without inflating any co-scheduled burst's shape.
    * ``monolithic_prefill`` — restore the pre-budget behaviour (context
      chunks cut at ``buckets[-1]``, inflating the whole wave's bucket)
      as a reference/baseline mode; ``prefill_budget`` is ignored.
    * ``overlap`` — keep one decode step in flight: dispatch step t+1
      before syncing step t's scores (default True). Commit gating, row
      op ordering and hot-swap invalidation stay correct because every
      cache update is in stream order; the only observable difference is
      that row reuse and admission run one step behind request
      completion.
    * ``watchdog_steps`` — a row holding undispatchable backlog for more
      than this many steps (or a request still unfinished when ``run``
      drains) increments ``watchdog_fired`` and is recorded in
      ``telemetry()`` — a stalled/never-draining row is a scheduler bug
      surfaced rather than a silent hang.

    Knobs that wait for later slices raise ``NotImplementedError``:
    ``mesh`` (scale-out, ROADMAP queue A item 8), ``drain_before_swap=True``
    and ``attach_param_source`` (streaming, item 6). ``update_params``
    works in its default mixed-version mode.
    """

    def __init__(self, params, cfg: ModelConfig, *, n_slots: int = 8,
                 capacity: int = 256, window: Optional[int] = None,
                 buckets: Sequence[int] = (8, 16, 32, 64),
                 sp: SpecialTokens = SpecialTokens(),
                 yes_id: int = 3, no_id: int = 4,
                 cache_dtype: torch.dtype = torch.float32,
                 kv_dtype: Optional[str] = None,
                 attn_impl: Optional[str] = None,
                 share_prefix: bool = True, min_shared_prefix: int = 4,
                 prefill_budget: Optional[int] = None,
                 monolithic_prefill: bool = False,
                 overlap: bool = True,
                 watchdog_steps: int = 256,
                 paged: bool = True, page_size: int = 16,
                 n_pages: Optional[int] = None,
                 mesh=None, drain_before_swap: bool = False,
                 tracer=None, device: DeviceLike = None):
        if mesh is not None:
            raise NotImplementedError(
                "a serving mesh waits for the scale-out slice (ROADMAP "
                "queue A, item 8)")
        if drain_before_swap:
            raise NotImplementedError(
                "drain_before_swap waits for the streaming slice (ROADMAP "
                "queue A, item 6); the default mixed-version swap works")
        self.device = resolve_device(device)
        if window is None:
            window = cfg.window          # match make_prefill_fn's default
        self.params = params
        self.cfg = cfg
        self.n_slots = n_slots
        self.capacity = capacity
        self.kv_dtype = kv_dtype
        self.buckets = tuple(sorted(buckets))
        self.sp = sp
        self.attn_impl = attn_impl
        self.share_prefix = share_prefix
        self.min_shared_prefix = max(int(min_shared_prefix), 1)
        if prefill_budget is None:
            prefill_budget = self.buckets[-1]
        assert prefill_budget >= 1, "prefill_budget must be >= 1"
        self.prefill_budget = int(prefill_budget)
        self.monolithic_prefill = bool(monolithic_prefill)
        self.overlap = bool(overlap)
        self.watchdog_steps = int(watchdog_steps)
        self.paged = bool(paged)
        # observability: a tracer (default no-op) plus the metrics
        # registry backing every counter telemetry() reports. The public
        # counter attributes (`n_steps`, `shared_admissions`, ...) are
        # read-only properties over these — same names, same values.
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = MetricsRegistry()
        m = self.metrics
        self._c_steps = m.counter("serve.steps")
        self._c_shared_admissions = m.counter("serve.shared_admissions")
        self._c_cross_row_hits = m.counter("serve.cross_row_hits")
        self._c_cross_row_tokens = m.counter("serve.cross_row_tokens")
        self._c_watchdog_fired = m.counter("serve.watchdog_fired")
        self._c_budget_used = m.counter("serve.prefill_tokens")
        self._c_budget_avail = m.counter("serve.prefill_budget_avail")
        self._c_kv_committed = m.counter("serve.kv_bytes_committed")
        self._c_starved = m.counter("serve.prefill_starved_steps")
        self._c_prefill_steps = m.counter("serve.prefill_steps")
        self._c_swap_drains = m.counter("serve.swap_drains")
        self._c_swap_drain_steps = m.counter("serve.swap_drain_steps")
        self._c_ctx_done = m.counter("serve.ctx_tokens_done")
        self._c_shared_done = m.counter("serve.shared_tokens_done")
        self._c_bucket = {int(b): m.counter(f"serve.bucket_steps.{int(b)}")
                          for b in self.buckets}
        self._h_qdepth = m.histogram("serve.queue_depth")
        if self.paged:
            # each row addresses the global page pool through its page
            # table; the pool defaults to the same total slot count as the
            # contiguous layout, so pages freed by short contexts fund
            # radix-index retention instead of sitting idle in long rows
            cap_eff = -(-capacity // page_size) * page_size
            self.page_size = int(page_size)
            max_pages = cap_eff // page_size
            if n_pages is None:
                n_pages = n_slots * max_pages
            self._pool = PagePool(n_pages, page_size, metrics=self.metrics)
            # host mirror of the device page tables (authoritative copy;
            # uploaded to the cache whenever dirty)
            self._tables = np.full((n_slots, max_pages), -1, np.int32)
            self._tables_dirty = False
        else:
            cap_eff = capacity
            self.page_size = None
            self._pool = None
        # the decode step and the row ops update the cache in place (the
        # reference donates it to each jitted op and rebinds the result)
        self._decode = make_decode_fn(cfg, window=window, ring=False,
                                      yes_id=yes_id, no_id=no_id,
                                      attn_impl=attn_impl)
        self.cache = init_lm_cache(
            cfg, n_slots, cap_eff, dtype=cache_dtype, kv_dtype=kv_dtype,
            page_size=self.page_size,
            n_pages=n_pages if self.paged else None, device=self.device)
        # per-token KV footprint (codes + scale sidecars, all layers):
        # stamped on the pool so capacity can be asked in bytes — what lets
        # benchmarks size int8 and bf16 pools to equal HBM budgets
        self._kv_token_bytes = kv_token_bytes(self.cache)
        if self.paged:
            self._pool.token_bytes = self._kv_token_bytes
        self._queue: deque = deque()
        self._rows: List[_Row] = [_Row() for _ in range(n_slots)]
        self._trie = RadixTree(page_size=self.page_size or 0)
        # host shadow of the device per-row refcounts: lets the row-op
        # batcher detect double-frees (`_flush_row_ops`) and the paged path
        # unmap pages exactly when a row resets, without a device sync
        self._row_ref = np.zeros((n_slots,), np.int32)
        self._pending = self._fresh_pending()
        self._results: Dict[int, RequestResult] = {}
        self._next_rid = 0
        self._inflight: deque = deque()  # dispatched, un-harvested steps
        self._prefill_rr = 0             # rotates budget priority over rows
        self.params_version: Optional[int] = None
        self.reset_stats()

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without a sync. On the card the data
        is first copied into a pinned buffer that PyTorch's host allocator
        keeps until the async copy has run, so the caller may mutate ``a``
        (the page-table mirror, the wave buffers) right away."""
        if self.device.type == "cuda":
            return torch.from_numpy(a).pin_memory().to(self.device,
                                                       non_blocking=True)
        return torch.from_numpy(np.array(a, copy=True)).to(self.device)

    # -- telemetry -----------------------------------------------------------

    # registry-backed views keeping the historic attribute API
    # (`sched.n_steps`, benchmarks, tests — reads and writes) intact
    # post-migration
    @property
    def n_steps(self) -> int:
        return self._c_steps.value

    @n_steps.setter
    def n_steps(self, v: int) -> None:
        self._c_steps.set(int(v))

    @property
    def shared_admissions(self) -> int:
        """Requests that reused a prefix."""
        return self._c_shared_admissions.value

    @shared_admissions.setter
    def shared_admissions(self, v: int) -> None:
        self._c_shared_admissions.set(int(v))

    @property
    def cross_row_hits(self) -> int:
        """Admissions served from the radix page index (pages another
        row or no row currently holds)."""
        return self._c_cross_row_hits.value

    @cross_row_hits.setter
    def cross_row_hits(self, v: int) -> None:
        self._c_cross_row_hits.set(int(v))

    @property
    def cross_row_tokens(self) -> int:
        return self._c_cross_row_tokens.value

    @cross_row_tokens.setter
    def cross_row_tokens(self, v: int) -> None:
        self._c_cross_row_tokens.set(int(v))

    @property
    def watchdog_fired(self) -> int:
        return self._c_watchdog_fired.value

    @watchdog_fired.setter
    def watchdog_fired(self, v: int) -> None:
        self._c_watchdog_fired.set(int(v))

    def reset_stats(self) -> None:
        """Zero the step/telemetry counters (benchmarks call this after
        warmup so first calls don't pollute the measured run). In-flight
        state, retained blocks and results are untouched — and so are the
        one-shot ``jit.*`` warmup gauges (``jit_stats()``), which live
        outside the ``serve.``/``pool.`` reset scopes."""
        self.metrics.reset(prefix="serve.")
        self.watchdog_stuck_rids: List[int] = []
        self._watchdog_rows: set = set()
        if self.paged:
            self._pool.evictions = 0
        for r in self._rows:
            r.last_used = 0
            r.last_progress = 0

    def reset_telemetry(self) -> None:
        """Documented alias of ``reset_stats`` — clears every counter
        ``telemetry()`` reports, including the watchdog state
        (``_watchdog_rows`` / ``watchdog_stuck_rids``)."""
        self.reset_stats()

    def telemetry(self) -> Dict[str, Any]:
        """Scheduler-health counters since construction / ``reset_stats``:

        * ``bucket_steps``        — decode steps per bucket shape (the
          tail-latency fingerprint: monolithic prefill piles steps into
          the largest bucket, the token budget keeps burst waves small);
        * ``queue_depth_mean/max``— submitted-but-unadmitted requests,
          sampled once per dispatched step after admission;
        * ``prefill_budget`` / ``prefill_tokens`` / ``budget_utilization``
          — the per-step budget, committed tokens actually dispatched and
          dispatched / available-under-demand (None when
          ``monolithic_prefill`` disables the budget);
        * ``prefill_starved_steps`` — steps where some row's prefill got
          nothing because the budget ran out (rotation keeps this fair);
        * ``watchdog_fired`` / ``watchdog_rows`` / ``watchdog_stuck_rids``
          — stalled-row detections (see ``watchdog_steps``).
        """
        # guard the burst-only / zero-prefill case: with no prefill steps
        # dispatched there is no budget demand to divide by — report None,
        # never a ZeroDivisionError
        util = (self._c_budget_used.value / self._c_budget_avail.value
                if self._c_budget_avail.value else None)
        qd = self._h_qdepth
        out = {
            "steps": int(self.n_steps),
            "overlap": bool(self.overlap),
            "bucket_steps": {b: int(c.value)
                             for b, c in sorted(self._c_bucket.items())},
            "queue_depth_mean": qd.mean if qd.count else 0.0,
            "queue_depth_max": int(qd.vmax) if qd.count else 0,
            "prefill_budget": (None if self.monolithic_prefill
                               else int(self.prefill_budget)),
            "prefill_tokens": int(self._c_budget_used.value),
            "prefill_steps": int(self._c_prefill_steps.value),
            "budget_utilization": (None if self.monolithic_prefill else util),
            "prefill_starved_steps": int(self._c_starved.value),
            "watchdog_fired": int(self.watchdog_fired),
            "watchdog_rows": sorted(int(i) for i in self._watchdog_rows),
            "watchdog_stuck_rids": list(self.watchdog_stuck_rids),
            "paged": bool(self.paged),
            "cross_row_hits": int(self.cross_row_hits),
            "cross_row_tokens": int(self.cross_row_tokens),
            "prefix_hit_rate": (self._c_shared_done.value
                                / self._c_ctx_done.value
                                if self._c_ctx_done.value else 0.0),
            # KV footprint: dtype, whole-cache bytes, per-token bytes
            # (codes + any scale sidecar) and bytes landed by commits —
            # the equal-HBM-budget axis of the quantized-vs-bf16 benches
            "kv_dtype": self.kv_dtype or "native",
            "kv_bytes": int(kv_cache_bytes(self.cache)),
            "kv_token_bytes": float(self._kv_token_bytes),
            "kv_bytes_committed": int(self._c_kv_committed.value),
            # multi-device and drain-before-swap wait for later slices
            "mesh": None,
            "drain_before_swap": False,
            "swap_drains": int(self._c_swap_drains.value),
            "swap_drain_steps": int(self._c_swap_drain_steps.value),
        }
        if self.paged:
            out.update({
                "page_size": int(self.page_size),
                "pages_in_use": int(self._pool.pages_in_use()),
                "pages_free": int(self._pool.free_count()),
                "page_evictions": int(self._pool.evictions),
                "radix_pages": int(self._trie.held_pages()),
                "pool_capacity_tokens": int(self._pool.capacity_tokens()),
                "pool_bytes": int(self._pool.pool_bytes()),
            })
        return out

    def warmup(self) -> None:
        """Run the decode step for every bucket shape with an
        all-invalid, non-committing wave, then the row ops with no-op
        masks. No row state changes (invalid slots write pos -1 that
        ``commit=False`` discards).

        There is nothing to compile here: the first call of the first
        bucket builds (with ``nvcc``, once per checkout) and loads the
        decode kernel on the kernel path. Each bucket runs twice and the
        ``jit.*`` gauges keep the reference's names: ``first_s`` is the
        first call, ``execute_s`` the second, and ``compile_s`` their
        difference — the first call's overhead (kernel build and load,
        allocator warm-up), not a compile. The blocking syncs here are
        warmup-only; the serving hot path stays at its single harvest
        sync."""
        for s in self.buckets:
            z = np.zeros((self.n_slots, s), np.int32)
            f = np.zeros((self.n_slots, s), bool)
            args = (self._upload(z), self._upload(z), self._upload(f),
                    self._upload(f),
                    self._upload(np.zeros((self.n_slots,), bool)),
                    self._upload(np.full((self.n_slots, s), -1, np.int32)))
            t0 = monotonic()
            p, self.cache = self._decode(self.params, self.cache, *args)
            self._sync()
            t1 = monotonic()
            p, self.cache = self._decode(self.params, self.cache, *args)
            self._sync()
            t2 = monotonic()
            first, execute = t1 - t0, t2 - t1
            pre = f"jit.bucket{int(s)}"
            self.metrics.gauge(pre + ".first_s").set(first)
            self.metrics.gauge(pre + ".execute_s").set(execute)
            self.metrics.gauge(pre + ".compile_s").set(
                max(0.0, first - execute))
        # the row ops too (no-op masks/counts)
        none = self._upload(np.zeros((self.n_slots,), bool))
        zc = self._upload(np.zeros((self.n_slots,), np.int32))
        free_slots(self.cache, zc)
        trim_slots(self.cache, none, zc, ring=False)
        adopt_slots(self.cache, none, zc)
        retain_slots(self.cache, zc)
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def jit_stats(self) -> Dict[int, Dict[str, float]]:
        """Per-bucket first-call-vs-execute timing measured by
        ``warmup()``: ``{bucket: {compile_s, execute_s, first_s}}`` (see
        ``warmup`` for what ``compile_s`` holds here). Empty before warmup.
        Survives ``reset_stats`` (the gauges sit under the un-reset
        ``jit.`` prefix)."""
        out: Dict[int, Dict[str, float]] = {}
        for s in self.buckets:
            pre = f"jit.bucket{int(s)}"
            g = self.metrics.gauge(pre + ".first_s")
            if g.seq:
                out[int(s)] = {
                    "compile_s": self.metrics.gauge(pre + ".compile_s").value,
                    "execute_s": self.metrics.gauge(pre + ".execute_s").value,
                    "first_s": g.value,
                }
        return out

    # -- weight hot-swap -----------------------------------------------------

    def attach_param_source(self, source, *, poll_every: int = 8) -> None:
        """Polling a weight publisher waits for the streaming slice
        (ROADMAP queue A, item 6); call ``update_params`` directly."""
        raise NotImplementedError(
            "attach_param_source waits for the streaming slice (ROADMAP "
            "queue A, item 6)")

    def update_params(self, params, version: Optional[int] = None) -> None:
        """Swap serving weights in place; queued requests and busy rows are
        untouched (the reference's default mixed-version mode).

        Retained context blocks are **invalidated**: their KV encodes the
        old weights, so sharing them with post-swap requests would score
        fresh traffic against stale context. Idle retained blocks are
        freed and deregistered immediately; blocks with in-flight readers
        keep serving them (a request straddling a swap is scored under
        mixed versions) but are flagged ``stale`` — never matched for new
        sharing, and freed instead of retained when their last reader
        leaves.

        A row whose context is **still committing** when the swap lands is
        *restarted* instead: mixing weight versions inside one context
        block would make the block's KV internally inconsistent, so the
        row's slots are rolled back to empty (``trim_slots`` at keep=0 —
        enqueued after any in-flight chunk, in stream order) and the
        committer re-commits its full context from position 0 under the
        new weights."""
        self.tracer.instant("hot_swap", version=version)
        self.params = params
        if version is not None:
            self.params_version = version
        if self.paged:
            # the radix page index holds pre-swap KV: flush it before any
            # restart re-allocates, so freed pages fund the recommits
            dropped = self._trie.drop_all_pages()
            if dropped:
                self._pool.decref(dropped)
        for i, r in enumerate(self._rows):
            committer = self._committer(r) if r.pending_commit > 0 else None
            if committer is not None:
                n = len(committer.context)
                committer.prefill = _Prefill(tokens=list(committer.context),
                                             start=0)
                # accounting restarts with the prefill: the request now
                # commits its full context itself (any shared prefix it
                # had borrowed predates the swap)
                committer.prefill_tokens = n
                committer.shared_prefix_tokens = 0
                self._mark("trim", i, keep=0)
                if self.paged:
                    # radix-adopted pages may be shared with other rows —
                    # a full recommit must write only private pages
                    self._unmap_row(i)
                    if not self._ensure_pages(i, min(self.capacity,
                                                     n + self.buckets[-1]),
                                              exclude={i}):
                        raise RuntimeError(
                            f"page pool exhausted re-committing row {i} "
                            f"after a weight hot-swap")
                continue
            if not self.share_prefix or not r.committed:
                continue
            if r.active:
                r.stale = True
            else:                              # idle retention hold
                self._trie.remove(r.committed, i)
                r.committed, r.retained = [], False
                self._mark("free", i)
                if self.paged:
                    self._unmap_row(i)

    # -- request intake ------------------------------------------------------

    def submit(self, context: Sequence[Sequence[int]],
               candidates: Sequence[Sequence[int]],
               rid: Optional[int] = None) -> int:
        assert len(candidates) > 0, "a request needs at least one candidate"
        if rid is None:
            rid = self._next_rid
        assert (rid not in self._results
                and all(q[0] != rid for q in self._queue)
                and all(s.rid != rid for r in self._rows
                        for s in r.active)), (
            f"request id {rid} already pending")
        self._next_rid = max(self._next_rid, rid + 1)
        ctx = [self.sp.bos]
        for it in context:
            ctx.extend(it)
        j_long = max(range(len(candidates)),
                     key=lambda j: len(candidates[j]))
        longest = len(candidates[j_long]) + 1
        if longest > self.buckets[-1]:
            raise ValueError(
                f"request {rid}: candidate {j_long} burst {longest} tokens "
                f"> largest bucket {self.buckets[-1]}")
        # explicit capacity-overflow rejection: non-ring `slot_indices`
        # never wraps or clamps, so a commit running past capacity would
        # silently scatter-drop KV (mode="drop") and score garbage — the
        # overflow must be refused here, with the offending lengths named,
        # before any row state is touched
        if len(ctx) + longest > self.capacity:
            raise ValueError(
                f"request {rid}: context {len(ctx)} + candidate {j_long} "
                f"burst {longest} tokens overflow capacity {self.capacity} "
                f"(commits past capacity would be silently dropped)")
        self._queue.append((rid, ctx, [list(c) for c in candidates],
                            monotonic()))
        if self.tracer.enabled:
            self.tracer.instant("submit", rid=rid, context=len(ctx),
                                k=len(candidates))
        return rid

    def prewarm(self, context: Sequence[Sequence[int]]) -> Optional[int]:
        """Enqueue a candidate-less request that commits ``context`` into
        the cache (and, on a paged cache, publishes its full pages into
        the radix index) without scoring anything — so a user's *next*
        real request admits against an already-resident prefix. The
        reference's stream pipeline calls this for hot users on
        hot-swap-free ticks.

        Prewarms ride the normal admission ladder and prefill budget, so
        they never preempt scoring traffic's shapes; the context is
        clamped to leave one largest-bucket of burst headroom for the
        real request that follows. Returns the rid (its RequestResult
        has ``scores == []``), or None when sharing is off, the usable
        context is shorter than ``min_shared_prefix``, or the prefix is
        already fully resident (nothing to warm)."""
        if not self.share_prefix:
            return None
        ctx = [self.sp.bos]
        for it in context:
            ctx.extend(it)
        ctx = ctx[:max(0, self.capacity - self.buckets[-1])]
        if len(ctx) < self.min_shared_prefix:
            return None
        end_d, _, _, _ = self._trie.match(ctx)
        if end_d >= len(ctx):
            return None
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append((rid, ctx, [], monotonic()))
        if self.tracer.enabled:
            self.tracer.instant("submit", rid=rid, context=len(ctx),
                                k=0, prewarm=True)
        return rid

    # -- unit construction ---------------------------------------------------

    def _burst_units(self, candidates: List[List[int]], n: int,
                     suffix: List[int], burst_cap: int
                     ) -> Tuple[List[_Unit], int]:
        """Non-committing scoring bursts: greedy-fill candidate+[SUM]
        groups into shared bursts; each group carries its candidate index
        as an in-burst segment, so one decode step scores as many
        candidates as fit. A burst also writes (unreachable) KV after the
        committed block, so it must stay within ``burst_cap`` slots.

        ``suffix`` is the request's uncommitted context tail (nonempty
        only when sharing a busy row's shorter committed prefix): it rides
        at the head of **every** burst as shared (seg −1) tokens at
        positions ``n−len(suffix)..n−1``, re-creating the request's full
        context without writing to the shared block. Candidate positions
        restart at ``n`` either way — identical to the unshared layout.

        Returns (units, total burst tokens incl. suffix copies).
        """
        units: List[_Unit] = []
        total = 0
        toks: List[int] = []
        pos: List[int] = []
        is_sum: List[bool] = []
        seg: List[int] = []
        score_at: List[Tuple[int, int]] = []

        def begin():
            toks.extend(suffix)
            pos.extend(range(n - len(suffix), n))
            is_sum.extend([False] * len(suffix))
            seg.extend([-1] * len(suffix))

        def flush():
            nonlocal total
            if len(toks) > len(suffix) or (toks and not suffix):
                units.append(_Unit(
                    tokens=np.asarray(toks, np.int32),
                    positions=np.asarray(pos, np.int32),
                    is_sum=np.asarray(is_sum),
                    seg=np.asarray(seg, np.int32),
                    commit=False, score_at=list(score_at)))
                total += len(toks)
            for l in (toks, pos, is_sum, seg, score_at):
                l.clear()

        begin()
        for j, cand in enumerate(candidates):
            group = list(cand) + [self.sp.sum]
            if len(toks) > len(suffix) and len(toks) + len(group) > burst_cap:
                flush()
                begin()
            toks.extend(group)
            pos.extend(range(n, n + len(group)))   # every candidate restarts
            is_sum.extend([False] * len(cand) + [True])
            seg.extend([j] * len(group))
            score_at.append((j, len(toks) - 1))
        flush()
        return units, total

    # -- paged-cache page management (host-side, no device syncs) ------------

    def _unmap_row(self, row: int, from_page: int = 0) -> None:
        """Drop the row's page-table references from ``from_page`` on.
        Pages whose last reference this was return to the pool; pages the
        radix index still holds stay resident (and matchable) rowlessly."""
        tbl = self._tables[row]
        pids = tbl[from_page:]
        pids = pids[pids >= 0]
        if len(pids):
            self._pool.decref([int(p) for p in pids])
            tbl[from_page:] = -1
            self._tables_dirty = True

    def _alloc_pages(self, n: int, exclude=()) -> Optional[List[int]]:
        """Allocate ``n`` private pages, reclaiming under pressure: first
        LRU pages held only by the radix index, then whole LRU retained
        rows (their trie entries drop, like a steal). ``exclude`` protects
        rows the current admission is about to use. None when the pool is
        truly exhausted (every page pinned by an active or excluded row)."""
        if n == 0:
            return []
        while True:
            pids = self._pool.alloc(n)
            if pids is not None:
                return pids
            short = n - self._pool.free_count()
            ev = self._trie.evict_pages(short, self._pool.ref)
            if ev:
                self._pool.note_evictions(len(ev))
                self._pool.decref(ev)
                continue
            victims = [i for i, r in enumerate(self._rows)
                       if i not in exclude and not r.active and r.retained
                       and r.pending_commit == 0]
            if not victims:
                return None
            row = min(victims, key=lambda i: self._rows[i].last_used)
            r = self._rows[row]
            self._trie.remove(r.committed, row)
            r.committed, r.retained = [], False
            self._mark("free", row)
            self._unmap_row(row)

    def _mapped_pages(self, row: int) -> int:
        """Mapped page-table prefix length (mappings are always a
        contiguous prefix: adopt/extend grow it, trim/free shrink it)."""
        return int((self._tables[row] >= 0).sum())

    def _ensure_pages(self, row: int, upto_tokens: int, exclude=()) -> bool:
        """Grow ``row``'s mapped prefix to cover ``upto_tokens`` logical
        slots (committed context plus the burst-scratch extent). New pages
        are private (ref 1, owned by the row)."""
        need = -(-min(upto_tokens, self.capacity) // self.page_size)
        have = self._mapped_pages(row)
        if need <= have:
            return True
        pids = self._alloc_pages(need - have, exclude=exclude)
        if pids is None:
            return False
        self._tables[row, have:need] = pids
        self._tables_dirty = True
        return True

    def _publish_pages(self, row: int) -> None:
        """Index the row's full committed pages in the radix tree (the
        index takes one pool reference per newly adopted page), so the
        prefix stays reusable by *any* row even after this one is stolen."""
        r = self._rows[row]
        full = len(r.committed) // self.page_size
        if full == 0:
            return
        pids = [int(p) for p in self._tables[row, :full]]
        assert all(p >= 0 for p in pids)
        new = self._trie.attach_pages(r.committed, pids)
        if new:
            self._pool.incref(new)

    def _max_burst_extent(self, candidates: List[List[int]],
                          suffix_len: int, burst_cap: int) -> int:
        """Largest slot extent any single burst unit will write past the
        committed block — mirrors ``_burst_units``'s greedy packing."""
        cur, out = suffix_len, 0
        for c in candidates:
            g = len(c) + 1
            if cur > suffix_len and cur + g > burst_cap:
                cur = suffix_len
            cur += g
            out = max(out, cur)
        return out

    # -- admission -----------------------------------------------------------

    def _mark(self, which: str, row: int, keep: int = 0) -> None:
        """Queue a refcount/trim/adopt update for ``row``; applied in one
        batched call per phase (`_flush_row_ops`) instead of per event —
        per-event dispatch would dominate the step at small model sizes.
        Retain/free marks are *counts*, not flags: several requests
        can take (or drop) references on the same row within one wave."""
        if which == "trim":
            self._pending["trim"][row] = True
            self._pending["trim_keep"][row] = keep
        elif which == "adopt":
            self._pending["adopt"][row] = True
            self._pending["adopt_len"][row] = keep
        else:
            self._pending[which][row] += 1

    def _flush_row_ops(self) -> None:
        """Apply queued row ops in dependency order: free (steal resets)
        -> trim (roll back retained blocks) -> adopt (install radix-mapped
        prefixes) -> retain (new references). The phases touch disjoint
        rows within one flush except steal, which queues free+retain (and
        possibly adopt) on the same row — exactly the order applied.

        Before applying, the free counts are audited against the host
        shadow refcounts: freeing more references than a row holds is a
        scheduler accounting bug that the device op would silently
        *saturate* (resetting ``pos``/``cursor`` under a still-active
        sharer mid-burst), so it fails loudly here with the row and its
        active rids named instead.
        """
        p = self._pending
        over = p["free"] > self._row_ref
        if over.any():
            parts = []
            for row in np.flatnonzero(over):
                rids = sorted(s.rid for s in self._rows[row].active)
                parts.append(
                    f"row {int(row)}: freeing {int(p['free'][row])} ref(s) "
                    f"but only {int(self._row_ref[row])} held "
                    f"(active rids {rids})")
            raise RuntimeError("double-free in row-op batch — " +
                               "; ".join(parts))
        self._row_ref += p["retain"] - p["free"]
        up = self._upload
        if p["free"].any():
            free_slots(self.cache, up(p["free"]))
        if p["trim"].any():
            trim_slots(self.cache, up(p["trim"]), up(p["trim_keep"]),
                       ring=False)
        if p["adopt"].any():
            adopt_slots(self.cache, up(p["adopt"]), up(p["adopt_len"]))
        if p["retain"].any():
            retain_slots(self.cache, up(p["retain"]))
        if self.paged and self._tables_dirty:
            # in place, in stream order: steps already dispatched read the
            # old tables, the next one reads these
            self.cache["page_table"].copy_(up(self._tables))
            self._tables_dirty = False
        self._pending = self._fresh_pending()

    def _fresh_pending(self) -> Dict[str, np.ndarray]:
        return {"free": np.zeros((self.n_slots,), np.int32),
                "trim": np.zeros((self.n_slots,), bool),
                "retain": np.zeros((self.n_slots,), np.int32),
                "trim_keep": np.zeros((self.n_slots,), np.int32),
                "adopt": np.zeros((self.n_slots,), bool),
                "adopt_len": np.zeros((self.n_slots,), np.int32)}

    def _admit(self, row: int, rid: int, ctx: List[int],
               candidates: List[List[int]], t0: float, *,
               shared_depth: int, commit_from: int,
               suffix_in_burst: bool, rung: int = 0) -> None:
        """Build the request's work on ``row``: resumable prefill state for
        the context tokens no committed block covers, plus its burst queue.

        ``shared_depth``   — context prefix reused from the row's block;
        ``commit_from``    — first context index this request commits
                             (== len(ctx) when nothing is committed);
        ``suffix_in_burst``— True when the row is busy with other readers,
                             so the unshared tail ``ctx[shared_depth:]``
                             must ride each burst instead of extending the
                             shared block;
        ``rung``           — which admission-ladder rung placed it
                             (1..4, see ``_try_place``; trace-only).
        """
        n = len(ctx)
        r = self._rows[row]
        to_commit = ctx[commit_from:]
        prefill = None
        if to_commit:
            prefill = _Prefill(tokens=list(to_commit), start=commit_from)
            r.pending_commit += 1
            if r.committed:
                self._trie.remove(r.committed, row)
            r.committed = list(ctx)
            self._trie.insert(r.committed, row)
        elif not r.committed:
            r.committed = list(ctx)
            self._trie.insert(r.committed, row)
        suffix = ctx[shared_depth:] if suffix_in_burst else []
        committed_len = shared_depth if suffix_in_burst else n
        burst_cap = min(self.buckets[-1], self.capacity - committed_len)
        bursts, burst_total = self._burst_units(candidates, n, suffix,
                                                burst_cap)
        slot = _Slot(rid=rid, row=row, units=deque(bursts), prefill=prefill,
                     context=list(ctx),
                     scores=[None] * len(candidates), submit_t=t0,
                     admit_t=monotonic(),
                     n_context=n, prefill_tokens=len(to_commit),
                     burst_tokens=burst_total,
                     slate_tokens=sum(len(c) + 1 for c in candidates),
                     shared_prefix_tokens=shared_depth,
                     n_candidates=len(candidates))
        r.active.append(slot)
        if shared_depth > 0:
            self._c_shared_admissions.inc()
        if self.tracer.enabled:
            self.tracer.instant("admission", rid=rid, row=row, rung=rung,
                                shared=shared_depth,
                                commit=len(to_commit))
        if prefill is None and not slot.units:
            # a prewarm whose context is already fully resident: nothing
            # to dispatch, the request completes at admission
            self._finish(slot, monotonic())

    def _try_place(self, rid: int, ctx: List[int],
                   candidates: List[List[int]], t0: float) -> bool:
        """Place one queued request onto a cache row, preferring the most
        reusable committed context block. The policy ladder (first match
        wins; every rung needs a non-stale block with a usable prefix of
        >= ``min_shared_prefix`` tokens; rungs 1 and 3 mutate the block so
        they additionally need its commits drained):

        1. **extend a retained block** — an inactive row whose full
           committed context is a prefix of ``ctx``: commit only the
           suffix (the block grows; its trie entry is re-keyed). Exact
           matches commit nothing.
        2. **read a busy block** — an active row whose full committed
           context is a prefix of ``ctx``: take a reference and ride the
           unshared suffix inside each burst (the block itself is
           immutable while others read it). Needs suffix + largest
           candidate to fit one bucket. The block may still be committing
           (a same-wave admission): the sharer's bursts are gated behind
           the commits by ``_build_wave``.
        3. **trim a retained block** — an inactive row sharing only a
           proper prefix: roll the block back to the shared prefix
           (`trim_slots`), then commit the rest, as in 1. Paged caches
           trim at a page boundary when the boundary page is shared
           (writing the recommit into it would corrupt its other
           readers); a private boundary page trims at the exact depth.
        4. **fresh row / steal** — a never-used/reset row, else steal the
           least-recently-used retained row (`free_slots` drops the
           retention reference, resetting it). On a paged cache this rung
           first consults the radix **page index**: a prefix another row
           committed — even one whose row has since been stolen — is
           mapped straight into the new row's page table (`adopt_slots`
           installs the bookkeeping; zero KV recompute, zero KV copy) and
           only the tail is committed. These are the *cross-row* hits a
           per-slot contiguous cache cannot serve.

        On a paged cache every rung first maps enough pages to cover the
        committed block plus the burst-scratch extent; a rung whose pages
        cannot be allocated (pool exhausted even after evicting
        index-only pages and stealing retained rows) is skipped.

        Returns False when nothing can host the request (all rows busy).
        """
        n = len(ctx)
        max_group = max((len(c) + 1 for c in candidates), default=0)

        def extent(committed_len: int, suffix_len: int) -> int:
            cap = min(self.buckets[-1], self.capacity - committed_len)
            return committed_len + self._max_burst_extent(
                candidates, suffix_len, cap)

        if self.share_prefix:
            end_d, end_rows, thr_d, thr_rows = self._trie.match(ctx)
            ok = lambda i: (self._rows[i].pending_commit == 0
                            and not self._rows[i].stale)
            if end_d >= self.min_shared_prefix:
                idle = [i for i in sorted(end_rows)
                        if ok(i) and not self._rows[i].active]
                # a busy block may still have commits in flight (its
                # committer was admitted this very wave): sharers can be
                # placed anyway — their bursts are gated behind the
                # commits by `_build_wave`, never reading a half-written
                # block
                busy = [i for i in sorted(end_rows)
                        if not self._rows[i].stale and self._rows[i].active]
                if idle:
                    row = idle[0]
                    if not self.paged or self._ensure_pages(
                            row, extent(n, 0), exclude={row}):
                        self._rows[row].retained = False  # hold transfers
                        self._admit(row, rid, ctx, candidates, t0,
                                    shared_depth=end_d, commit_from=end_d,
                                    suffix_in_burst=False, rung=1)
                        return True
                # the suffix-fits check depends only on the request: all
                # rows in `busy` share the same committed length end_d
                if busy and (n - end_d) + max_group <= min(
                        self.buckets[-1], self.capacity - end_d):
                    row = busy[0]
                    if not self.paged or self._ensure_pages(
                            row, extent(end_d, n - end_d), exclude={row}):
                        self._mark("retain", row)
                        self._admit(row, rid, ctx, candidates, t0,
                                    shared_depth=end_d, commit_from=n,
                                    suffix_in_burst=True, rung=2)
                        return True
            if thr_d >= self.min_shared_prefix:
                trimmable = [i for i in sorted(thr_rows)
                             if ok(i) and not self._rows[i].active
                             and self._rows[i].retained
                             and len(self._rows[i].committed) > thr_d]
                if trimmable:
                    row = min(trimmable,
                              key=lambda i: self._rows[i].last_used)
                    r = self._rows[row]
                    keep = thr_d
                    usable = True
                    if self.paged:
                        ps = self.page_size
                        bp, rem = divmod(thr_d, ps)
                        bref = (int(self._pool.ref[self._tables[row, bp]])
                                if rem else 1)
                        if bref == 2:
                            # the boundary page's only other holder is the
                            # index (a second *row* would imply ref >= 3,
                            # since adoption keeps the index's hold):
                            # un-index it — and the deeper pages behind
                            # it, unreachable once the boundary is gone —
                            # so the recommit writes a private page
                            dropped = self._trie.drop_pages(r.committed, bp)
                            if dropped:
                                self._pool.decref(dropped)
                        elif bref > 2:
                            # another row is reading the boundary page —
                            # fall back to the aligned prefix, or skip
                            # the rung if too short
                            keep = bp * ps
                            usable = keep >= self.min_shared_prefix
                        if usable:
                            self._unmap_row(row, from_page=-(-keep // ps))
                            if not self._ensure_pages(row, extent(n, 0),
                                                      exclude={row}):
                                # pool exhausted mid-trim: the tail pages
                                # are already gone, so reset the row to
                                # fresh rather than leave its committed
                                # block partially unmapped
                                self._trie.remove(r.committed, row)
                                r.committed, r.retained = [], False
                                self._mark("free", row)
                                self._unmap_row(row)
                                usable = False
                    if usable:
                        self._trie.remove(r.committed, row)
                        r.committed = []
                        r.retained = False             # hold transfers
                        self._mark("trim", row, keep=keep)
                        self._admit(row, rid, ctx, candidates, t0,
                                    shared_depth=keep, commit_from=keep,
                                    suffix_in_burst=False, rung=3)
                        return True
        row = None
        fresh = [i for i, r in enumerate(self._rows)
                 if not r.active and not r.retained and not r.committed]
        if fresh:
            row = fresh[0]
            self._mark("retain", row)
        else:
            stealable = [i for i, r in enumerate(self._rows)
                         if not r.active and r.retained
                         and r.pending_commit == 0]
            if stealable:
                row = min(stealable, key=lambda i: self._rows[i].last_used)
                r = self._rows[row]
                self._trie.remove(r.committed, row)
                r.committed, r.retained = [], False
                self._mark("free", row)                # drop hold -> reset
                self._mark("retain", row)
                if self.paged:
                    self._unmap_row(row)
        if row is None:
            return False
        if not self.paged:
            self._admit(row, rid, ctx, candidates, t0,
                        shared_depth=0, commit_from=0, suffix_in_burst=False,
                        rung=4)
            return True
        # paged rung 4: adopt any radix-indexed prefix pages (shared KV
        # that survives row steals), then allocate private pages for the
        # remainder. Shared pages take their reference *before* the
        # private allocation so the allocator's eviction sweep cannot
        # reclaim them out from under the admission.
        depth = 0
        adopted: List[int] = []
        if self.share_prefix:
            covered, pages = self._trie.match_pages(ctx)
            if covered >= self.min_shared_prefix:
                self._pool.incref(pages)
                adopted, depth = list(pages), covered
        need = -(-min(extent(n, 0), self.capacity) // self.page_size)
        priv = self._alloc_pages(need - len(adopted), exclude={row})
        if priv is None and adopted:
            # not enough private pages alongside the shared prefix: give
            # the prefix back and retry as a plain admission
            self._pool.decref(adopted)
            adopted, depth = [], 0
            priv = self._alloc_pages(need, exclude={row})
        if priv is None:
            # the pool cannot host this request at all right now — undo
            # this rung's reference mark and leave it queued
            self._pending["retain"][row] -= 1
            return False
        self._tables[row, :len(adopted)] = adopted
        self._tables[row, len(adopted):need] = priv
        self._tables_dirty = True
        if depth:
            self._mark("adopt", row, keep=depth)
            self._c_cross_row_hits.inc()
            self._c_cross_row_tokens.inc(depth)
        self._admit(row, rid, ctx, candidates, t0,
                    shared_depth=depth, commit_from=depth,
                    suffix_in_burst=False, rung=4)
        return True

    # -- the batched step ----------------------------------------------------

    @staticmethod
    def _committer(r: _Row) -> Optional[_Slot]:
        """The row's active slot with prefill still to dispatch (at most
        one: only idle-row admissions commit)."""
        for s in r.active:
            if s.prefill is not None and s.prefill.remaining > 0:
                return s
        return None

    def _next_unit(self, r: _Row) -> Optional[Tuple[_Slot, _Unit]]:
        """Round-robin the row's active requests' burst queues. Only called
        on rows with no commits in flight (``pending_commit == 0``): while
        a context is still committing, ``_build_wave`` schedules prefill
        chunks instead, so a sharer admitted onto a mid-commit block waits
        there rather than bursting against a half-written context."""
        if not r.active:
            return None
        for off in range(len(r.active)):
            slot = r.active[(r.rr + off) % len(r.active)]
            if not slot.units:
                continue
            r.rr = (r.rr + off + 1) % len(r.active)
            return slot, slot.units.popleft()
        return None

    def _build_wave(self) -> Optional[Tuple[List[Tuple[int, _Slot, _Unit]],
                                            int]]:
        """Pack one batched step: decode bursts first (they alone pick the
        wave's bucket unless ``monolithic_prefill``), then cut resumable
        prefill chunks into the remaining rows under the token budget.
        Advances prefill cursors and pops burst units — callers must
        dispatch exactly what is returned. None when nothing can run."""
        work: List[Tuple[int, _Slot, _Unit]] = []
        pending: List[Tuple[int, _Slot]] = []
        for i, r in enumerate(self._rows):
            if r.pending_commit > 0:
                c = self._committer(r)
                if c is not None:
                    pending.append((i, c))
                continue                   # bursts wait for the block
            picked = self._next_unit(r)
            if picked is not None:
                work.append((i, picked[0], picked[1]))
        if not work and not pending:
            return None
        if pending:
            # rotate which row gets budget first, so a tight budget
            # round-robins across competing prefills instead of starving
            # the highest-numbered rows
            self._prefill_rr += 1
            off = self._prefill_rr % len(pending)
            pending = pending[off:] + pending[:off]
        if self.monolithic_prefill:
            # pre-budget behaviour: prefill chunks are largest-bucket
            # sized and inflate the whole wave's shape
            budget = None
            need = max([len(u.tokens) for _, _, u in work]
                       + [min(c.prefill.remaining, self.buckets[-1])
                          for _, c in pending])
        else:
            budget = self.prefill_budget
            if work:
                need = max(len(u.tokens) for _, _, u in work)
            else:
                # prefill-only wave: no burst to keep small, so every
                # pending row fills a chunk — the budget caps the bucket
                # (and so the chunk), not the wave's total tokens, else a
                # drained pipeline would commit slower than monolithic
                # for no latency benefit
                need = min(max(c.prefill.remaining for _, c in pending),
                           budget)
        s = next(b for b in self.buckets
                 if b >= min(need, self.buckets[-1]))
        left = s * len(pending) if (budget is None or not work) else budget
        cap0 = left
        used = demand = 0
        starved = False
        for i, c in pending:
            pf = c.prefill
            demand += pf.remaining
            take = min(pf.remaining, s, left)
            if take <= 0:
                starved = True
                continue
            work.append((i, c, _Unit(
                tokens=np.asarray(pf.tokens[pf.done:pf.done + take],
                                  np.int32),
                positions=np.arange(pf.start + pf.done,
                                    pf.start + pf.done + take,
                                    dtype=np.int32),
                is_sum=np.zeros(take, bool),
                seg=np.full(take, -1, np.int32), commit=True)))
            pf.done += take
            left -= take
            used += take
            if pf.remaining == 0:
                self._rows[i].pending_commit -= 1
        if pending:
            self._c_budget_used.inc(used)
            self._c_kv_committed.inc(int(used * self._kv_token_bytes))
            if budget is not None:
                self._c_budget_avail.inc(min(cap0, demand))
                if starved:
                    self._c_starved.inc()
        return work, s

    def _finish(self, slot: _Slot, now: float) -> None:
        """Harvested the request's last [SUM]: record the result and drop
        its cache reference. The row's context block outlives the request
        when sharing is on — the last departing reader flips the row to
        ``retained`` (keeping the reference as the retention hold) instead
        of freeing, so the block stays matchable in the trie until stolen
        or trimmed.

        Accounting: ``logical_tokens`` is what k standalone prefills would
        compute (k·n context re-encodes + the slate); ``computed`` is what
        this scheduler actually fed (committed prefill + burst tokens,
        suffix copies included); ``cached_tokens`` is the difference — the
        prompt tokens served from cache, whether by own-context reuse
        across the k candidates or by a cross-request shared prefix."""
        r = self._rows[slot.row]
        n, k = slot.n_context, slot.n_candidates
        computed = slot.prefill_tokens + slot.burst_tokens
        # a prewarm (k == 0) has no logical k-prefill equivalent: its
        # logical cost is exactly what it computed (cached_tokens = 0)
        logical_tokens = (k * n + slot.slate_tokens) if k else computed
        if k:
            self._c_ctx_done.inc(n)
            self._c_shared_done.inc(slot.shared_prefix_tokens)
        self._results[slot.rid] = RequestResult(
            rid=slot.rid, scores=list(slot.scores),
            latency_s=now - slot.submit_t,
            queue_s=slot.admit_t - slot.submit_t,
            service_s=now - slot.admit_t,
            context_tokens=n, prefill_tokens=slot.prefill_tokens,
            burst_tokens=slot.burst_tokens,
            shared_prefix_tokens=slot.shared_prefix_tokens,
            cached_tokens=logical_tokens - computed,
            logical_tokens=logical_tokens,
            params_versions=sorted(slot.versions,
                                   key=lambda v: (v is not None, v)))
        if self.tracer.enabled:
            self.tracer.instant("finish", rid=slot.rid, row=slot.row)
        r.active.remove(slot)
        if self.share_prefix:
            if r.active:
                self._mark("free", slot.row)           # drop reader ref
            elif r.stale:                              # pre-swap KV: drop it
                self._trie.remove(r.committed, slot.row)
                r.committed, r.retained, r.stale = [], False, False
                self._mark("free", slot.row)
                if self.paged:
                    self._unmap_row(slot.row)
            else:
                r.retained = True                      # ref becomes the hold
                if self.paged:
                    # index the block's full pages so the prefix outlives
                    # even a steal of this row (rung-4 radix map-in)
                    self._publish_pages(slot.row)
        else:
            if r.committed and not r.active:
                self._trie.remove(r.committed, slot.row)
                r.committed = []
            self._mark("free", slot.row)
            if self.paged and not r.active:
                self._unmap_row(slot.row)

    def _harvest_one(self) -> bool:
        """Sync the oldest in-flight step's scores (the only host<->device
        sync on the hot path: a wait on the event recorded after their copy
        to the host), record them, retire finished requests and
        flush their reference drops. Returns False when nothing was in
        flight."""
        if not self._inflight:
            return False
        with self.tracer.span("harvest"):
            self._harvest_body()
        return True

    def _harvest_body(self) -> None:
        p, work, _ = self._inflight.popleft()
        p = p.get()
        now = monotonic()
        for row, slot, u in work:
            for j, off in u.score_at:
                slot.scores[j] = float(p[row, off])
            # a slot finishes on the harvest that fills its last score —
            # never on queue emptiness, which overlap races (units are
            # popped at dispatch, one step ahead of this harvest)
            if u.score_at and all(sc is not None for sc in slot.scores):
                self._finish(slot, now)
            elif (slot.n_candidates == 0 and u.commit
                  and slot.prefill.remaining == 0
                  and slot in self._rows[row].active):
                # a prewarm has no [SUM] to score: it finishes when its
                # last committed chunk has been dispatched and a chunk
                # harvested after that (device order makes the block
                # fully written before any adopter reads it)
                self._finish(slot, now)
        self._flush_row_ops()          # departing readers' refs drop once

    def _watchdog_scan(self, scheduled: set) -> None:
        """Flag rows holding backlog that has not dispatched for more than
        ``watchdog_steps`` steps — a stall (gating bug, corrupted row
        state) surfaced as a counter instead of a silent hang."""
        for i, r in enumerate(self._rows):
            backlog = any(s.units or (s.prefill is not None
                                      and s.prefill.remaining > 0)
                          for s in r.active)
            if not backlog or i in scheduled:
                r.last_progress = self.n_steps
            elif (self.n_steps - r.last_progress > self.watchdog_steps
                  and i not in self._watchdog_rows):
                self._watchdog_rows.add(i)
                self._c_watchdog_fired.inc()
                self.tracer.instant("watchdog", row=i)

    def step(self) -> bool:
        """Admit queued requests (strict FIFO, as many as place), dispatch
        one batched decode step over every busy row's next work unit, and
        harvest scores — one step behind the dispatch when ``overlap`` is
        on, immediately otherwise. Returns False when queue, rows and the
        in-flight pipeline are all drained (nothing happened).

        With a tracer attached each step emits one ``scheduler.step``
        span with nested ``admit`` / ``build_wave`` / per-unit
        ``prefill_chunk``/``burst`` / ``dispatch`` / ``harvest`` child
        spans; the tracer touches only host clocks + a ring append, so
        the step's device-sync profile is identical traced or not."""
        sp = self.tracer.span("scheduler.step")
        with sp:
            return self._step_impl(sp)

    def _step_impl(self, sp) -> bool:
        # un-lag the pipeline when it pays: harvest an in-flight step
        # before admission if (a) it's free — the device already finished
        # it — or (b) requests are queued and the step is known (at
        # dispatch time) to finish a request, so harvesting releases a row
        # this wave's admission can use. (b) trades one step of overlap
        # for a row exactly when rows are the bottleneck; under light load
        # the pipeline stays a full step ahead.
        while self._inflight and (
                self._inflight[0][0].is_ready()
                or (self._queue and self._inflight[0][2])):
            self._harvest_one()
        if self._queue:
            with self.tracer.span("admit"):
                while self._queue:
                    rid, ctx, cands, t0 = self._queue[0]
                    if not self._try_place(rid, ctx, cands, t0):
                        break
                    self._queue.popleft()
        self._flush_row_ops()          # steals/trims land before the decode

        with self.tracer.span("build_wave"):
            wave = self._build_wave()
        if wave is None:
            return self._harvest_one()     # drain the pipeline tail
        work, s = wave
        tr = self.tracer

        tokens = np.zeros((self.n_slots, s), np.int32)
        positions = np.zeros((self.n_slots, s), np.int32)
        is_sum = np.zeros((self.n_slots, s), bool)
        valid = np.zeros((self.n_slots, s), bool)
        seg = np.full((self.n_slots, s), -1, np.int32)
        commit = np.zeros((self.n_slots,), bool)
        for row, slot, u in work:
            # the version whose weights compute this unit — what
            # RequestResult.params_versions reports
            slot.versions.add(self.params_version)
            with tr.span("prefill_chunk" if u.commit else "burst",
                         row=row, rid=slot.rid,
                         tokens=int(len(u.tokens))) if tr.enabled \
                    else _NULLCTX:
                m = len(u.tokens)
                tokens[row, :m] = u.tokens
                positions[row, :m] = u.positions
                is_sum[row, :m] = u.is_sum
                seg[row, :m] = u.seg
                valid[row, :m] = True
                commit[row] = u.commit

        # async dispatch: p stays on device until this step is harvested
        ann = (obs_profile.annotate(f"decode.b{int(s)}")
               if tr.device_annotate else _NULLCTX)
        up = self._upload
        with tr.span("dispatch", bucket=int(s), rows=len(work)), ann:
            p, self.cache = self._decode(
                self.params, self.cache, up(tokens), up(positions),
                up(is_sum), up(valid), up(commit), up(seg))
            p = _Scores(p)
        self._c_steps.inc()
        self._c_bucket[int(s)].inc()
        if any(u.commit for _, _, u in work):
            self._c_prefill_steps.inc()
        qd = len(self._queue)
        self._h_qdepth.observe(qd)
        if tr.enabled:
            tr.counter("queue_depth", qd)
            sp.set(bucket=int(s), rows=len(work))
        scheduled = set()
        for row, _, _u in work:
            self._rows[row].last_used = self.n_steps
            scheduled.add(row)
        self._watchdog_scan(scheduled)
        # decidable at dispatch (units pop at dispatch): does this step
        # carry some request's final [SUM]? drives the queued-harvest rule
        finishes = any(u.score_at and not slot.units
                       and (slot.prefill is None
                            or slot.prefill.remaining == 0)
                       for _, slot, u in work)
        self._inflight.append((p, work, finishes))
        if not self.overlap or len(self._inflight) > 1:
            self._harvest_one()
        return True

    def run(self) -> Dict[int, RequestResult]:
        """Drain queue, rows and the in-flight pipeline; returns results
        for every request scored since the last ``run``. Retained context
        blocks survive across ``run`` calls, so later traffic still shares
        them. A request left unfinished after the drain (a stalled row —
        scheduler bug or corrupted state) fires the watchdog instead of
        hanging; its rid is recorded in ``telemetry()``."""
        while self.step():
            pass
        stuck = sorted([s.rid for r in self._rows for s in r.active]
                       + [q[0] for q in self._queue])
        if stuck:
            self._c_watchdog_fired.inc()
            self.watchdog_stuck_rids = stuck
            self.tracer.instant("watchdog", stuck_rids=stuck)
        out, self._results = self._results, {}
        return out


__all__ = ["ServeScheduler", "RequestResult", "TELEMETRY_SCHEMA"]
