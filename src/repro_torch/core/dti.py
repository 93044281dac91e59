"""DTI prompt formulation (numpy): a copy of ``repro.core.dti``'s
sliding-window and streaming prompts, packing, multi-target serving rows,
batching and the row-length and window rules.

Byte-identical to the reference for the same inputs. Rows follow the
canonical batch schema (docs/batch_schema.md):

  tokens      (L,) int32
  positions   (L,) int32   token index, restarting at 0 per segment
  segment_ids (L,) int32   packed-prompt id within the row, -1 on padding
  is_sum      (L,) bool    [SUM] readout positions
  labels      (L,) int32   label at the [SUM] position, 0 elsewhere
  valid       (L,) bool    padding mask
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

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


@dataclasses.dataclass
class PromptStats:
    n_prompts: int = 0
    n_tokens: int = 0          # non-pad tokens fed to the model
    n_targets: int = 0         # supervised [SUM] positions
    n_rows: int = 0            # physical batch rows (== n_prompts unpacked)
    n_slots: int = 0           # rows * max_len (pad slots included)

    def add(self, tokens: int, targets: int, slots: int = 0):
        self.n_prompts += 1
        self.n_tokens += tokens
        self.n_targets += targets
        if slots:
            self.n_rows += 1
            self.n_slots += slots

    def add_packed_row(self, tokens: int, prompts: int, targets: int,
                       slots: int):
        self.n_prompts += prompts
        self.n_tokens += tokens
        self.n_targets += targets
        self.n_rows += 1
        self.n_slots += slots

    @property
    def pad_fraction(self) -> float:
        """Share of batch slots burnt on pad tokens."""
        if self.n_slots == 0:
            return 0.0
        return 1.0 - self.n_tokens / self.n_slots


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
    stats: Optional[PromptStats] = None,
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
        if stats is not None:
            stats.add(len(toks), 1, slots=max_len)
        out.append(_pack(toks, is_sum, lab, max_len, sp))
    return out


def build_streaming_prompts(
    item_tokens: Sequence[Sequence[int]], labels: Sequence[int], *,
    n_ctx: int, k: int, max_len: int, sp: SpecialTokens = SpecialTokens(),
    stats: Optional[PromptStats] = None,
) -> List[Dict[str, np.ndarray]]:
    """Stride-k traversal: each prompt = n_ctx context interactions followed
    by up to k (target, [SUM]) groups (paper fig. 1.ii(a), fig. 5)."""
    m = len(item_tokens)
    out = []
    i = n_ctx
    while i < m:
        targets = list(range(i, min(i + k, m)))
        toks: List[int] = [sp.bos]
        for j in range(i - n_ctx, i):
            toks.extend(item_tokens[j])
        is_sum = [False] * len(toks)
        lab = [0] * len(toks)
        for j in targets:
            toks.extend(item_tokens[j])
            is_sum.extend([False] * len(item_tokens[j]))
            lab.extend([0] * len(item_tokens[j]))
            toks.append(sp.sum)
            is_sum.append(True)
            lab.append(int(labels[j]))
        if stats is not None:
            stats.add(len(toks), len(targets), slots=max_len)
        out.append(_pack(toks, is_sum, lab, max_len, sp))
        i += k
    return out


def prompt_length(p: Dict[str, np.ndarray]) -> int:
    """Non-pad length of a built prompt (valid is always a prefix)."""
    return int(p["valid"].sum())


def pack_prompts(prompts: List[Dict[str, np.ndarray]], max_len: int, *,
                 sp: SpecialTokens = SpecialTokens(),
                 stats: Optional[PromptStats] = None,
                 ) -> List[Dict[str, np.ndarray]]:
    """Greedy first-fit-decreasing packing of prompts into shared rows.

    Each row holds whole prompts back to back: ``segment_ids`` 0, 1, ...
    per prompt (-1 on padding), ``positions`` restarting at 0 per segment,
    the other fields concatenated, ``target_mask`` carried through when
    present. Segments are isolated downstream by the attention mask.
    """
    lengths = [prompt_length(p) for p in prompts]
    for n in lengths:
        if not 0 < n <= max_len:
            raise ValueError(f"prompt length {n} not in (0, {max_len}]")
    order = sorted(range(len(prompts)), key=lambda i: -lengths[i])
    bins: List[List[int]] = []
    free: List[int] = []
    for i in order:
        n = lengths[i]
        for b, cap in enumerate(free):
            if n <= cap:
                bins[b].append(i)
                free[b] = cap - n
                break
        else:
            bins.append([i])
            free.append(max_len - n)

    has_tm = bool(prompts) and "target_mask" in prompts[0]
    if not all(("target_mask" in p) == has_tm for p in prompts):
        raise ValueError("mixed prompts: target_mask must be present on all "
                         "rows or none")
    rows = []
    for members in bins:
        t = np.full((max_len,), sp.pad, np.int32)
        pos = np.zeros((max_len,), np.int32)
        seg = np.full((max_len,), -1, np.int32)
        s = np.zeros((max_len,), bool)
        lab = np.zeros((max_len,), np.int32)
        valid = np.zeros((max_len,), bool)
        tm = np.zeros((max_len,), bool)
        off = 0
        for si, i in enumerate(members):
            n = lengths[i]
            p = prompts[i]
            sl = slice(off, off + n)
            t[sl] = p["tokens"][:n]
            pos[sl] = np.arange(n, dtype=np.int32)
            seg[sl] = si
            s[sl] = p["is_sum"][:n]
            lab[sl] = p["labels"][:n]
            valid[sl] = True
            if has_tm:
                tm[sl] = p["target_mask"][:n]
            off += n
        if stats is not None:
            stats.add_packed_row(off, len(members),
                                 int((tm if has_tm else s).sum()), max_len)
        row = {"tokens": t, "positions": pos, "segment_ids": seg,
               "is_sum": s, "labels": lab, "valid": valid}
        if has_tm:
            row["target_mask"] = tm
        rows.append(row)
    return rows


def build_multi_target_request(
    context_tokens: Sequence[Sequence[int]],
    candidate_tokens: Sequence[Sequence[int]], *, max_len: int,
    sp: SpecialTokens = SpecialTokens(),
    stats: PromptStats | None = None,
) -> Dict[str, np.ndarray]:
    """One serving request — a shared user context + k candidate items —
    laid out as a single canonical-schema row (the serving analog of the
    streaming training prompt):

        [BOS] ctx...              segment 0, positions 0..n-1
        cand_1... [SUM]           segment 1, positions n..n+c_1
        ...
        cand_k... [SUM]           segment k, positions n..n+c_k

    Candidate positions *continue* after the context instead of restarting
    at 0, and the attention mask treats segment 0 as a shared prefix
    (``seg_shared=0``): every candidate attends the context plus itself,
    never another candidate. Each candidate therefore sees exactly the
    token/position geometry of a standalone ``[BOS] ctx cand [SUM]``
    sliding-window prompt, so one prefill over this row reproduces k
    independent prefills — O(n^2 + k·n) attention instead of O(k·n^2).

    Scores are read at the [SUM] slots, in candidate order
    (``candidate_sum_slots``). Labels are zero: serving rows carry no
    supervision.
    """
    toks: List[int] = [sp.bos]
    for it in context_tokens:
        toks.extend(it)
    n = len(toks)
    pos = list(range(n))
    seg = [0] * n
    is_sum = [False] * n
    for j, cand in enumerate(candidate_tokens):
        toks.extend(cand)
        toks.append(sp.sum)
        pos.extend(range(n, n + len(cand) + 1))
        seg.extend([j + 1] * (len(cand) + 1))
        is_sum.extend([False] * len(cand) + [True])
    total = len(toks)
    if total > max_len:
        raise ValueError(f"request length {total} > max_len {max_len}")
    if stats is not None:
        stats.add_packed_row(total, len(candidate_tokens),
                            len(candidate_tokens), max_len)
    return {
        "tokens": _pad_to(np.asarray(toks, np.int32), max_len, sp.pad),
        "positions": _pad_to(np.asarray(pos, np.int32), max_len, 0),
        "segment_ids": _pad_to(np.asarray(seg, np.int32), max_len, -1),
        "is_sum": _pad_to(np.asarray(is_sum, bool), max_len, False),
        "labels": np.zeros((max_len,), np.int32),
        "valid": _pad_to(np.ones((total,), bool), max_len, False),
    }


def candidate_sum_slots(row: Dict[str, np.ndarray]) -> np.ndarray:
    """Physical indices of the k [SUM] readouts of a multi-target row, in
    candidate order."""
    return np.flatnonzero(row["is_sum"])


def batch_prompts(prompts: List[Dict[str, np.ndarray]],
                  batch_size: int, *, drop_remainder: bool = False,
                  rng: Optional[np.random.Generator] = None):
    """Yield stacked batches (shuffled if rng given); a short last batch is
    dropped or filled from the start of the order."""
    idx = np.arange(len(prompts))
    if rng is not None:
        rng.shuffle(idx)
    for s in range(0, len(idx), batch_size):
        sel = idx[s: s + batch_size]
        if len(sel) < batch_size:
            if drop_remainder:
                return
            sel = np.concatenate([sel, idx[: batch_size - len(sel)]])
        yield {key: np.stack([prompts[i][key] for i in sel])
               for key in prompts[0]}


def train_max_len(n_ctx: int, k: int, avg_item_tokens: float) -> int:
    """Fixed-shape training row length for prompts with ``n_ctx`` context
    interactions and ``k`` targets (1 for sliding-window): headroom over the
    expected token count, rounded up to a multiple of 64."""
    n = int((n_ctx + k) * (avg_item_tokens + 1.5) + 8)
    return ((n + 63) // 64) * 64


def window_tokens(n_ctx: int, avg_item_tokens: float, cap: int = 1024) -> int:
    """Token-level attention window covering n_ctx interactions, capped
    (the paper caps at 1024)."""
    return int(min(cap, round(n_ctx * (avg_item_tokens + 0.5) + 2)))


def effective_window(attn_impl: str, window: int, n_ctx: int,
                     avg_item_tokens: float) -> int:
    """Banded attention paths need a finite window; dense treats 0 as
    unlimited."""
    if attn_impl != "dense" and window == 0:
        return window_tokens(n_ctx, avg_item_tokens)
    return window


__all__ = ["SpecialTokens", "PromptStats", "build_sliding_prompts",
           "build_streaming_prompts", "prompt_length", "pack_prompts",
           "build_multi_target_request", "candidate_sum_slots",
           "batch_prompts", "train_max_len", "window_tokens",
           "effective_window"]
