"""Contiguous decode KV cache (the serving slice of ``repro.serve.cache``).

A cache is a flat dict:

* ``k``, ``v``  ``(L, B, cap, Hk, hd)`` — **unroped** keys and values, one
  row of ``cap`` slots per batch row. The decode step writes them in
  place (the reference threads them through a donated ``lax.scan`` carry;
  updating in place keeps one copy of the cache, which at dti-llama
  widths is gigabytes).
* ``pos (B, cap) int32`` — the logical position each slot holds; ``-1``
  marks an empty or unreachable slot. The single source of truth for
  attendability: KV bytes are never cleared.
* ``cursor (B,) int32`` — the next slot a committed write lands in.
* ``ref (B,) int32`` — reference count of the row's committed context
  (kept for the scheduler slice).

Paged and int8 layouts wait for their slices.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import ModelConfig, check_supported

Cache = Dict[str, Any]


def init_lm_cache(cfg: ModelConfig, batch: int, capacity: int, *,
                  dtype: torch.dtype = torch.bfloat16,
                  kv_dtype: str = None, page_size: int = None,
                  device: DeviceLike = None) -> Cache:
    """Allocate a contiguous cache of ``capacity`` slots per row."""
    check_supported(cfg)
    if kv_dtype is not None:
        raise NotImplementedError(
            f"kv_dtype={kv_dtype!r} waits for the int8-cache slice "
            "(ROADMAP queue A, serving)")
    if page_size is not None:
        raise NotImplementedError(
            "paged caches wait for the paged-cache slice (ROADMAP queue A, "
            "serving)")
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, capacity, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((batch, capacity), -1, dtype=torch.int32,
                          device=device),
        "cursor": torch.zeros((batch,), dtype=torch.int32, device=device),
        "ref": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def kv_keys(cache: Cache):
    """The per-layer KV tensor keys of ``cache``, in a fixed order."""
    return tuple(k for k in ("k", "v") if k in cache)


def slot_indices(cache: Cache, s_new: int, *, ring: bool) -> torch.Tensor:
    """Slots the next ``s_new`` tokens occupy: (B, s_new) int64.

    Non-ring indices are not wrapped or clamped: slots past capacity are
    dropped by the writer (``repro_torch.serve.engine``).
    """
    cap = cache["pos"].shape[1]
    idx = cache["cursor"].long()[:, None] + torch.arange(
        s_new, device=cache["cursor"].device)[None]
    return idx % cap if ring else idx


__all__ = ["Cache", "init_lm_cache", "kv_keys", "slot_indices"]
