"""Embedding substrate (counterpart of ``repro.sparse.embedding``).

Lookup is a row gather (``table[ids]``); a bag is a masked, weighted sum
(or mean, or max) over the gathered rows; a ragged bag sums rows into
segments with ``index_add_``. These are the plain versions the recsys
models use, as the reference's models use its substrate; the
hand-written bag kernel (``repro_torch.kernels.embedding_bag``) computes
the same sum/mean op, as ``repro.kernels.embedding_bag`` does there.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from repro_torch.models.layers import normal_init


def init_table(gen: torch.Generator, vocab: int, dim: int, *,
               scale: float = 0.01, dtype=torch.float32,
               device="cpu") -> torch.Tensor:
    return normal_init(gen, (vocab, dim), scale, dtype, device)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Single-hot lookup: ids (...,) -> (..., dim)."""
    return table[ids]


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  valid: Optional[torch.Tensor] = None, *,
                  mode: str = "sum",
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fixed-shape multi-hot bag: ids (..., H) -> (..., dim).

    ``valid (..., H)`` masks padding slots (their ids must still be in
    range here; the kernel's op clamps them)."""
    e = table[ids]                                         # (..., H, dim)
    if weights is not None:
        e = e * weights[..., None].to(e.dtype)
    if valid is not None:
        e = e * valid[..., None].to(e.dtype)
    s = e.sum(dim=-2)
    if mode == "sum":
        return s
    if mode == "mean":
        n = (valid.sum(dim=-1, keepdim=True).to(s.dtype) if valid is not None
             else torch.tensor(float(ids.shape[-1]), dtype=s.dtype,
                               device=s.device))
        return s / torch.clamp(n, min=1)
    if mode == "max":
        if valid is not None:
            e = torch.where(valid[..., None], e,
                            torch.finfo(e.dtype).min)
        return e.amax(dim=-2)
    raise ValueError(mode)


def embedding_bag_ragged(table: torch.Tensor, flat_ids: torch.Tensor,
                         segment_ids: torch.Tensor, num_segments: int, *,
                         weights: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Ragged bag: flat_ids (N,), segment_ids (N,) -> (num_segments, dim).

    As ``jax.ops.segment_sum``, rows whose segment id lies outside
    ``[0, num_segments)`` are dropped; ``index_add_`` would raise on them,
    so they are zeroed and sent to segment 0 (adding 0 there is exact, and
    no host sync decides which rows to keep)."""
    e = table[flat_ids]
    if weights is not None:
        e = e * weights[:, None].to(e.dtype)
    keep = (segment_ids >= 0) & (segment_ids < num_segments)
    e = torch.where(keep[:, None], e, torch.zeros((), dtype=e.dtype,
                                                  device=e.device))
    seg = torch.where(keep, segment_ids, torch.zeros_like(segment_ids))
    out = torch.zeros((num_segments, table.shape[1]), dtype=e.dtype,
                      device=e.device)
    return out.index_add_(0, seg.long(), e)


_U32 = 0xFFFFFFFF


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c`` modulo 2^32 for x in [0, 2^32) held in int64: the full
    product can pass 2^63, so multiply by c's 16-bit halves (each partial
    product stays under 2^48)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def hash_bucket(ids: torch.Tensor, vocab: int, *,
                salt: int = 0x9E3779B9) -> torch.Tensor:
    """Deterministic hash trick for open-vocabulary ids (QR-embed style),
    bit for bit the reference's uint32 arithmetic: ids are taken modulo
    2^32 (negative int32 ids wrap as ``astype(uint32)`` does)."""
    x = ids.to(torch.int64) & _U32
    x = _mul_u32(x, salt)
    x = x ^ (x >> 16)
    x = _mul_u32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    return (x % (vocab & _U32)).to(torch.int32)


def init_field_tables(gen: torch.Generator, vocab_sizes: Sequence[int],
                      dim: int, *, dtype=torch.float32,
                      device="cpu") -> Dict[str, torch.Tensor]:
    """One table per categorical field (recsys layout)."""
    return {f"field{i}": init_table(gen, v, dim, dtype=dtype, device=device)
            for i, v in enumerate(vocab_sizes)}


def field_lookup(tables: Dict[str, torch.Tensor],
                 ids: torch.Tensor) -> torch.Tensor:
    """ids (B, F) with per-field tables -> (B, F, dim)."""
    cols = [embedding_lookup(tables[f"field{i}"], ids[:, i])
            for i in range(ids.shape[1])]
    return torch.stack(cols, dim=1)


__all__ = ["init_table", "embedding_lookup", "embedding_bag",
           "embedding_bag_ragged", "hash_bucket", "init_field_tables",
           "field_lookup"]
