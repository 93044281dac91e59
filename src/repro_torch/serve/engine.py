"""Serving: prefill scoring and cached decode (counterpart of
``repro.serve.engine``).

* ``make_prefill_fn`` — full forward over sliding-window prompts (the
  paper's inference procedure). [SUM] rows keep NoPE+ALiBi and isolation,
  without the training-only hidden-state reset.
* ``make_decode_fn`` — incremental steps against the KV cache, with the
  scheduler's ``valid``/``commit``/``seg`` operands and ring caches. The
  cache holds unroped keys and their positions; RoPE is applied at read
  time, so a [SUM] query scores the same cache with NoPE+ALiBi.
* ``CTRServer.score`` — batched scoring of sliding-window prompts.

The cache is updated in place (see ``repro_torch.serve.cache``): the
caller's dict is mutated and returned.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.losses import ctr_logits
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.decode_attn import (decode_attention,
                                             decode_attention_plain)
from repro_torch.models.layers import (alibi_slopes, apply_rope, dense,
                                       rmsnorm, swiglu)
from repro_torch.models.transformer import (ModelConfig, check_supported,
                                            forward)
from repro_torch.serve.cache import Cache, kv_keys, slot_indices

Params = Dict[str, Any]


def _p_click(params: Params, cfg: ModelConfig, hidden, yes_id: int,
             no_id: int) -> torch.Tensor:
    logits2 = ctr_logits(params, cfg, hidden, yes_id, no_id)
    return torch.softmax(logits2.float(), dim=-1)[..., 0]


def make_prefill_fn(cfg: ModelConfig, *, yes_id: int = 3, no_id: int = 4,
                    window: Optional[int] = None) -> Callable:
    """(params, batch of tensors) -> p_click (B, S); valid only at [SUM]
    positions. Multi-target rows (shared-prefix segments) wait for a later
    slice."""
    icfg = dataclasses.replace(cfg, dti_reset=False)

    @torch.no_grad()
    def prefill(params: Params, batch: Dict[str, torch.Tensor]):
        out = forward(params, icfg, batch["tokens"],
                      positions=batch["positions"], is_sum=batch["is_sum"],
                      valid=batch["valid"], dti_enabled=True, window=window)
        p = _p_click(params, cfg, out["hidden"], yes_id, no_id)
        return torch.where(batch["is_sum"], p, torch.zeros_like(p))

    return prefill


def _rope_read(k: torch.Tensor, pos: torch.Tensor, theta: float):
    """Rope cached (unroped) keys with their stored positions; slots with
    pos < 0 are masked later, rope them at 0."""
    return apply_rope(k, pos.clamp(min=0), theta)


def _cache_write(buf: torch.Tensor, write, new: torch.Tensor) -> None:
    """Scatter fresh KV into one layer's ``(B, cap, ...)`` cache in place.

    ``write = (rows, slots, cols)`` lists only the tokens whose slot lies
    inside capacity: a chunk right-padded to its bucket may point past the
    end, and those writes must vanish (the reference's ``mode="drop"``),
    not raise, clamp, or wrap onto another slot.
    """
    rows, slots, cols = write
    buf[rows, slots] = new[rows, cols].to(buf.dtype)


def _ffn(lp: Params, h, cfg: ModelConfig):
    return h + swiglu(lp["ffn"], rmsnorm(lp["ln_ffn"], h, cfg.norm_eps))


def _gqa_decode_layer(lp: Params, h, kv: Dict[str, torch.Tensor], *,
                      cfg: ModelConfig, write, pos_buf, positions, is_sum,
                      window: int, seg_q=None, seg_buf=None, impl="dense"):
    b, s, _ = h.shape
    hq, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    x = rmsnorm(lp["ln_attn"], h, cfg.norm_eps)
    q = dense(lp["attn"]["q"], x).reshape(b, s, hq, hd)
    _cache_write(kv["k"], write, dense(lp["attn"]["k"], x).reshape(b, s, hk, hd))
    _cache_write(kv["v"], write, dense(lp["attn"]["v"], x).reshape(b, s, hk, hd))

    # Two key views per layer, as in the reference: the roped copy for
    # ordinary rows and the raw cache for the NoPE stream of [SUM] rows.
    # The roped copy is a full-capacity pass per layer (a cost noted in
    # PERF.md; RoPE at read time inside the kernel removes it later).
    q_rope = apply_rope(q, positions, cfg.rope_theta)
    k_rope = _rope_read(kv["k"], pos_buf, cfg.rope_theta)
    nope = cfg.dti_sum_alibi
    attend = decode_attention if impl == "cuda" else decode_attention_plain
    out = attend(q_rope, k_rope, kv["v"], positions, pos_buf, window=window,
                 is_sum_q=is_sum if nope else None,
                 q_nope=q if nope else None,
                 k_nope=kv["k"] if nope else None,
                 alibi=alibi_slopes(hq, h.device) if nope else None,
                 seg_q=seg_q, seg_k=seg_buf, scale=hd ** -0.5).to(h.dtype)
    h = h + dense(lp["attn"]["o"], out.reshape(b, s, hq * hd))
    return _ffn(lp, h, cfg)


def make_decode_fn(cfg: ModelConfig, *, window: int, ring: bool,
                   yes_id: int = 3, no_id: int = 4) -> Callable:
    """(params, cache, tokens (B,s), positions (B,s), is_sum (B,s)[, valid
    (B,s), commit (B,), seg (B,s)]) -> (p_click (B, s), cache).

    ``cfg.attn_impl`` picks the attention: ``"cuda"`` (the decode kernel)
    or ``"dense"`` (the plain oracle).

    * ``valid``  — right-padded chunks: invalid tokens are written with
      position -1 (never attendable) and the cursor advances by the valid
      count only.
    * ``commit`` — per-row bool. A ``commit=False`` row is a scoring burst:
      its tokens attend the committed context plus themselves, and
      ``pos``/``cursor`` stay as they were. Its KV is still written in
      place, at slots from the cursor on, whose ``pos`` stays -1 — so the
      next burst sees the pristine context and nothing needs copying or
      restoring. Requires ``ring=False``.
    * ``seg``    — per-token segment for multi-candidate bursts: -1 = shared
      context, 0..k-1 = candidate; a candidate attends the context and
      itself only.
    """
    check_supported(cfg)
    attn_impl = cfg.attn_impl
    if attn_impl == "blocked":
        raise NotImplementedError(
            "blocked attention comes with the training slice "
            "(ROADMAP queue A); use 'dense' or 'cuda'")
    if attn_impl not in ("dense", "cuda"):
        raise ValueError(f"unknown attention impl {attn_impl!r}")

    @torch.no_grad()
    def decode(params: Params, cache: Cache, tokens, positions, is_sum,
               valid=None, commit=None, seg=None):
        b, s = tokens.shape
        cap = cache["pos"].shape[1]
        slots = slot_indices(cache, s, ring=ring)
        # tokens whose slot lies inside capacity; the rest are dropped
        rows, cols = (slots < cap).nonzero(as_tuple=True)
        write = (rows, slots[rows, cols], cols)
        pos_write = (positions if valid is None
                     else torch.where(valid, positions, -1))
        pos_buf = cache["pos"].clone()
        pos_buf[write[0], write[1]] = pos_write[rows, cols].to(torch.int32)
        seg_buf = None
        if seg is not None:
            seg_buf = torch.full((b, cap), -1, dtype=torch.int32,
                                 device=tokens.device)
            seg_buf[write[0], write[1]] = seg[rows, cols].to(torch.int32)

        h = params["embed"][tokens].to(cfg.cdtype)
        for li, lp in enumerate(params["layers"]):
            kv = {nm: cache[nm][li] for nm in kv_keys(cache)}
            h = _gqa_decode_layer(lp, h, kv, cfg=cfg, write=write,
                                  pos_buf=pos_buf, positions=positions,
                                  is_sum=is_sum, window=window, seg_q=seg,
                                  seg_buf=seg_buf, impl=attn_impl)

        n_new = s if valid is None else valid.sum(dim=-1).to(torch.int32)
        if commit is None:
            cache["pos"].copy_(pos_buf)
            cache["cursor"].add_(n_new)
        else:
            if ring:
                raise ValueError("non-committing bursts require ring=False")
            cache["pos"].copy_(torch.where(commit[:, None], pos_buf,
                                           cache["pos"]))
            cache["cursor"].add_(torch.where(commit, n_new, 0)
                                 .to(torch.int32))
        h = rmsnorm(params["ln_f"], h, cfg.norm_eps)
        return _p_click(params, cfg, h, yes_id, no_id), cache

    return decode


@dataclasses.dataclass
class CTRServer:
    """Batched pointwise CTR scorer over ``max_len``-padded sliding-window
    prompts (one prompt per candidate, the paper's procedure)."""
    params: Params
    cfg: ModelConfig
    max_len: int
    yes_id: int = 3
    no_id: int = 4
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._prefill = make_prefill_fn(self.cfg, yes_id=self.yes_id,
                                        no_id=self.no_id)

    def score(self, prompts) -> List[float]:
        batch = {k: np.stack([p[k] for p in prompts])
                 for k in ("tokens", "positions", "is_sum", "valid")}
        if batch["tokens"].shape[1] != self.max_len:
            raise ValueError(f"prompts of length {batch['tokens'].shape[1]} "
                             f"!= max_len {self.max_len}")
        tb = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
        p = self._prefill(self.params, tb).float().cpu().numpy()
        out = []
        for i in range(len(prompts)):
            sums = np.flatnonzero(batch["is_sum"][i])
            out.append(float(p[i, sums[-1]]) if len(sums) else 0.5)
        return out


__all__ = ["make_prefill_fn", "make_decode_fn", "CTRServer"]
