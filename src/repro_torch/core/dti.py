"""Sliding-window prompt formulation (numpy), the serving slice of
``repro.core.dti``.

Byte-identical to the reference for the same inputs. Rows follow the
canonical batch schema (docs/batch_schema.md):

  tokens      (L,) int32
  positions   (L,) int32
  segment_ids (L,) int32   0 on the prompt, -1 on padding
  is_sum      (L,) bool    [SUM] readout positions
  labels      (L,) int32   label at the [SUM] position, 0 elsewhere
  valid       (L,) bool    padding mask
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np


@dataclasses.dataclass
class SpecialTokens:
    pad: int = 0
    bos: int = 1
    sum: int = 2
    yes: int = 3
    no: int = 4
    sep: int = 5
    n_reserved: int = 8


def _pad_to(arr: np.ndarray, length: int, fill=0) -> np.ndarray:
    out = np.full((length,), fill, dtype=arr.dtype)
    out[: len(arr)] = arr[:length]
    return out


def _pack(tokens: List[int], is_sum: List[bool], labels: List[int],
          max_len: int, sp: SpecialTokens) -> Dict[str, np.ndarray]:
    n = len(tokens)
    if n > max_len:
        raise ValueError(f"prompt length {n} > max_len {max_len}")
    t = _pad_to(np.asarray(tokens, np.int32), max_len, sp.pad)
    s = _pad_to(np.asarray(is_sum, bool), max_len, False)
    l = _pad_to(np.asarray(labels, np.int32), max_len, 0)
    valid = np.zeros((max_len,), bool)
    valid[:n] = True
    seg = np.full((max_len,), -1, np.int32)
    seg[:n] = 0
    return {"tokens": t, "is_sum": s, "labels": l, "valid": valid,
            "positions": np.arange(max_len, dtype=np.int32),
            "segment_ids": seg}


def build_sliding_prompts(
    item_tokens: Sequence[Sequence[int]], labels: Sequence[int], *,
    n_ctx: int, max_len: int, sp: SpecialTokens = SpecialTokens(),
) -> List[Dict[str, np.ndarray]]:
    """One prompt per target interaction i in [n_ctx, m): context =
    interactions [i-n_ctx, i), then the target, then [SUM]."""
    m = len(item_tokens)
    out = []
    for i in range(n_ctx, m):
        toks: List[int] = [sp.bos]
        for j in range(i - n_ctx, i + 1):
            toks.extend(item_tokens[j])
        toks.append(sp.sum)
        is_sum = [False] * (len(toks) - 1) + [True]
        lab = [0] * (len(toks) - 1) + [int(labels[i])]
        out.append(_pack(toks, is_sum, lab, max_len, sp))
    return out


__all__ = ["SpecialTokens", "build_sliding_prompts"]
