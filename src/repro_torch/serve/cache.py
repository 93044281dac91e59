"""Decode KV caches (counterpart of ``repro.serve.cache``): contiguous or
paged, bf16/fp32 or int8, with refcounted context blocks for cross-request
prefix sharing.

A cache is a flat dict. Per-layer KV tensors are stacked on a leading L
dim and hold **unroped** keys:

* contiguous layout — ``k``, ``v`` ``(L, B, cap, Hk, hd)``: one row of
  ``cap`` slots per batch row;
* paged layout (``page_size`` set) — ``k``, ``v`` ``(L, n_pages *
  page_size, Hk, hd)``: one global slot axis shared by every row, which
  addresses it through ``page_table (B, cap // page_size) int32`` of pool
  page ids (-1 = unmapped). Logical slot ``j`` of a row lives at physical
  slot ``page_table[row, j // ps] * ps + j % ps`` (``physical_slots``).
  Page allocation and refcounts are host state
  (``repro_torch.serve.pages.PagePool``); the device sees page tables only;
* int8 layout (``kv_dtype="int8"``) — ``k``/``v`` hold int8 codes and
  ``k_scale``/``v_scale`` ``(L, ..., cap, Hk)`` fp32 one symmetric absmax
  scale per (slot, kv head) on the same slot axis as the codes
  (``repro_torch.core.quant``), so a page carries its own scales.

Bookkeeping shared by every layer, logical per row in every layout:

* ``pos (B, cap) int32`` — the logical position each slot holds; ``-1``
  marks an empty or unreachable slot. The single source of truth for
  attendability: KV bytes are never cleared.
* ``cursor (B,) int32`` — the next slot a committed write lands in.
* ``ref (B,) int32`` — references on the row's committed context: the
  scheduler keeps ``ref == (#active requests on the row) + (1 if the
  context is retained for reuse)``.

The reference threads the cache through donated jitted calls as a
functional value. Here the decode step (``repro_torch.serve.engine``) and
the row operations below update the cache's tensors **in place**, in
stream order, and return the same dict: one copy of the cache, which at
dti-llama widths is gigabytes.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import ModelConfig, check_supported

Cache = Dict[str, Any]

#: Bookkeeping keys present in every cache layout; everything else in the
#: dict is a per-layer KV tensor (codes or scale sidecar).
BOOK_KEYS = ("pos", "cursor", "ref", "page_table")


def init_lm_cache(cfg: ModelConfig, batch: int, capacity: int, *,
                  dtype: torch.dtype = torch.bfloat16,
                  kv_dtype: str = None, page_size: int = None,
                  n_pages: int = None, device: DeviceLike = None) -> Cache:
    """Allocate a decode cache of ``capacity`` logical slots per row:
    contiguous (``page_size=None``) or paged over ``n_pages`` pages of
    ``page_size`` slots; ``kv_dtype="int8"`` stores codes plus scale
    sidecars, and ``dtype`` is then ignored for the KV tensors."""
    check_supported(cfg)
    if kv_dtype not in (None, "int8"):
        raise ValueError(f"unsupported kv_dtype {kv_dtype!r}")
    device = resolve_device(device)
    quant = kv_dtype == "int8"
    store = torch.int8 if quant else dtype
    if page_size is not None:
        if capacity % page_size:
            raise ValueError(f"paged capacity {capacity} must be a multiple "
                             f"of page_size {page_size}")
        if n_pages is None or n_pages <= 0:
            raise ValueError("a paged cache needs n_pages > 0")
        slots = (n_pages * page_size,)                 # global slot axis
    else:
        slots = (batch, capacity)
    l, hk, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    cache = {"k": torch.zeros((l, *slots, hk, hd), dtype=store, device=device),
             "v": torch.zeros((l, *slots, hk, hd), dtype=store, device=device)}
    if quant:
        for key in ("k_scale", "v_scale"):
            cache[key] = torch.zeros((l, *slots, hk), dtype=torch.float32,
                                     device=device)
    if page_size is not None:
        cache["page_table"] = torch.full((batch, capacity // page_size), -1,
                                         dtype=torch.int32, device=device)
    cache["pos"] = torch.full((batch, capacity), -1, dtype=torch.int32,
                              device=device)
    cache["cursor"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    cache["ref"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return cache


def is_paged(cache: Cache) -> bool:
    """True when the cache uses the global page-pool layout."""
    return "page_table" in cache


def is_quantized(cache: Cache) -> bool:
    """True when KV is stored as int8 codes + fp32 scale sidecars."""
    return "k_scale" in cache


def kv_keys(cache: Cache):
    """The per-layer KV tensor keys of ``cache`` (codes + scale sidecars),
    in a fixed order."""
    return tuple(k for k in ("k", "v", "k_scale", "v_scale") if k in cache)


def kv_cache_bytes(cache: Cache) -> int:
    """Total bytes of the KV tensors (codes + scale sidecars; bookkeeping
    excluded)."""
    return int(sum(cache[k].numel() * cache[k].element_size()
                   for k in kv_keys(cache)))


def kv_token_bytes(cache: Cache) -> float:
    """KV bytes per token slot, summed over layers (codes + scales)."""
    k = cache["k"]
    n_slots = k.shape[1] if is_paged(cache) else k.shape[1] * k.shape[2]
    return kv_cache_bytes(cache) / n_slots


def page_size_of(cache: Cache) -> int:
    """Page size of a paged cache (tokens per page)."""
    return cache["pos"].shape[1] // cache["page_table"].shape[1]


def physical_slots(cache: Cache) -> torch.Tensor:
    """Logical->physical slot map of a paged cache: (B, cap) int32 into the
    global KV slot axis, -1 where the logical slot's page is unmapped.
    Gathering the pool with the clamped map gives the per-row ``(B, cap,
    ...)`` view a contiguous cache stores directly; ``pos = -1`` keeps the
    unmapped entries unattendable."""
    pt = cache["page_table"]
    ps = page_size_of(cache)
    base = pt[:, :, None] * ps + torch.arange(ps, dtype=torch.int32,
                                              device=pt.device)[None, None]
    flat = torch.where(pt[:, :, None] < 0, -1, base)
    return flat.reshape(pt.shape[0], -1).to(torch.int32)


def slot_indices(cache: Cache, s_new: int, *, ring: bool) -> torch.Tensor:
    """Logical slots the next ``s_new`` tokens occupy: (B, s_new) int64.

    Non-ring indices are not wrapped or clamped: slots past capacity are
    dropped by the writer (``repro_torch.serve.engine``); the scheduler
    refuses requests whose real tokens would not fit.
    """
    cap = cache["pos"].shape[1]
    idx = cache["cursor"].long()[:, None] + torch.arange(
        s_new, device=cache["cursor"].device)[None]
    return idx % cap if ring else idx


def _counts(cache: Cache, counts) -> torch.Tensor:
    return torch.as_tensor(counts).to(device=cache["ref"].device,
                                      dtype=torch.int32)


def retain_slots(cache: Cache, counts) -> Cache:
    """Take references on rows: ``counts`` is (B,) bool (one per True row)
    or int (that many per row). Int32 bookkeeping only."""
    cache["ref"].add_(_counts(cache, counts))
    return cache


def free_slots(cache: Cache, counts) -> Cache:
    """Drop references on rows (``counts`` as in ``retain_slots``) and reset
    the touched rows whose count reaches zero: ``pos`` to -1, ``cursor`` to
    0. KV bytes stay (``pos = -1`` already makes them unreachable). The
    count saturates at zero, so freeing a zero-ref row resets it."""
    counts = _counts(cache, counts)
    ref = cache["ref"] - counts
    reset = (counts > 0) & (ref <= 0)
    cache["pos"].masked_fill_(reset[:, None], -1)
    cache["cursor"].masked_fill_(reset, 0)
    cache["ref"].copy_(ref.clamp(min=0))
    return cache


def trim_slots(cache: Cache, mask, keep, *, ring: bool = False) -> Cache:
    """Roll the rows selected by ``mask`` (B,) bool back to their first
    ``keep`` (B,) committed tokens: later slots become unreachable and the
    cursor drops to ``keep``. Non-ring caches only (on a ring, slot order
    is not commit order): ``ring=True`` raises."""
    if ring:
        raise ValueError(
            "trim_slots on a ring cache: slot index != committed order, "
            "trimming would corrupt attendability (non-ring caches only)")
    mask = torch.as_tensor(mask).to(cache["pos"].device, torch.bool)
    keep = _counts(cache, keep)
    cap = cache["pos"].shape[1]
    idx = torch.arange(cap, dtype=torch.int32, device=mask.device)[None]
    cache["pos"].masked_fill_(mask[:, None] & (idx >= keep[:, None]), -1)
    cache["cursor"].copy_(torch.where(
        mask, torch.minimum(cache["cursor"], keep), cache["cursor"]))
    return cache


def adopt_slots(cache: Cache, mask, length) -> Cache:
    """Install an already-written shared prefix on the rows selected by
    ``mask``: logical slots ``0..length-1`` become attendable at positions
    ``0..length-1``, later slots -1, cursor ``length``; no KV is written
    (the page table already maps the prefix's pages)."""
    mask = torch.as_tensor(mask).to(cache["pos"].device, torch.bool)
    length = _counts(cache, length)
    cap = cache["pos"].shape[1]
    idx = torch.arange(cap, dtype=torch.int32, device=mask.device)[None]
    pos = torch.where(mask[:, None] & (idx < length[:, None]), idx,
                      cache["pos"])
    pos = torch.where(mask[:, None] & (idx >= length[:, None]), -1, pos)
    cache["pos"].copy_(pos)
    cache["cursor"].copy_(torch.where(mask, length, cache["cursor"]))
    return cache


__all__ = ["Cache", "BOOK_KEYS", "init_lm_cache", "is_paged", "is_quantized",
           "kv_keys", "kv_cache_bytes", "kv_token_bytes", "page_size_of",
           "physical_slots", "slot_indices", "retain_slots", "free_slots",
           "trim_slots", "adopt_slots"]
