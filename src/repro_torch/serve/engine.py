"""Serving: prefill scoring and cached decode (counterpart of
``repro.serve.engine``).

* ``make_prefill_fn`` — full forward over sliding-window prompts (the
  paper's inference procedure). [SUM] rows keep NoPE+ALiBi and isolation,
  without the training-only hidden-state reset.
* ``make_decode_fn`` — incremental steps against the KV cache
  (contiguous or paged, bf16/fp32 or int8), with the scheduler's
  ``valid``/``commit``/``seg`` operands and ring caches. The cache holds
  unroped keys and their positions; RoPE is applied at read time, so a
  [SUM] query scores the same cache with NoPE+ALiBi. MLA models run in
  absorbed form against the latent cache (W_UK folded into the query,
  W_UV applied after aggregation), as MQA on the decode kernel.
* ``make_multi_target_prefill_fn`` — one prefill over a shared-context
  row (``repro_torch.core.dti.build_multi_target_request``: the user
  context as segment 0, then k [SUM]-terminated candidate segments), on
  the dense attention path.
* ``CTRServer.score`` — batched scoring of sliding-window prompts;
  ``CTRServer.score_multi_target`` — one multi-target row per request.

The cache is updated in place (see ``repro_torch.serve.cache``): the
caller's dict is mutated and returned.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.dti import (build_multi_target_request,
                                  candidate_sum_slots)
from repro_torch.core.losses import ctr_logits
from repro_torch.core.quant import quantize_q8
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.decode_attn import (decode_attention,
                                             decode_attention_mla,
                                             decode_attention_mla_plain,
                                             decode_attention_plain)
from repro_torch.models.attention import mla_query
from repro_torch.models.layers import (alibi_slopes, apply_rope, dense,
                                       rmsnorm)
from repro_torch.models.transformer import (ModelConfig, check_supported,
                                            ffn, forward)
from repro_torch.serve.cache import (Cache, is_paged, kv_keys,
                                     physical_slots, slot_indices)

Params = Dict[str, Any]


def _p_click(params: Params, cfg: ModelConfig, hidden, yes_id: int,
             no_id: int) -> torch.Tensor:
    logits2 = ctr_logits(params, cfg, hidden, yes_id, no_id)
    return torch.softmax(logits2.float(), dim=-1)[..., 0]


def make_prefill_fn(cfg: ModelConfig, *, yes_id: int = 3, no_id: int = 4,
                    window: Optional[int] = None,
                    multi_target: bool = False) -> Callable:
    """(params, batch of tensors) -> p_click (B, S); valid only at [SUM]
    positions.

    ``multi_target=True`` scores shared-context rows instead of
    one-prompt rows: the batch must carry ``segment_ids`` and segment 0 is
    a shared prefix (``seg_shared=0``); the dense attention path is
    forced."""
    icfg = dataclasses.replace(cfg, dti_reset=False)
    if multi_target:
        icfg = dataclasses.replace(icfg, attn_impl="dense")

    @torch.no_grad()
    def prefill(params: Params, batch: Dict[str, torch.Tensor]):
        kw: Dict[str, Any] = {}
        if multi_target:
            kw = dict(segment_ids=batch["segment_ids"], seg_shared=0)
        out = forward(params, icfg, batch["tokens"],
                      positions=batch["positions"], is_sum=batch["is_sum"],
                      valid=batch["valid"], dti_enabled=True, window=window,
                      **kw)
        p = _p_click(params, cfg, out["hidden"], yes_id, no_id)
        return torch.where(batch["is_sum"], p, torch.zeros_like(p))

    return prefill


def make_multi_target_prefill_fn(cfg: ModelConfig, *, yes_id: int = 3,
                                 no_id: int = 4,
                                 window: Optional[int] = None) -> Callable:
    """(params, batch) -> p_click (B, S) for multi-target serving rows
    (``build_multi_target_request``): one shared user context (segment 0)
    plus k [SUM]-terminated candidate segments whose positions continue
    after the context. One prefill scores all k candidates with the
    context encoded once, O(n^2 + k n) attention instead of the O(k n^2)
    of k independent sliding-window prefills, and each [SUM] probability
    equals the standalone prompt's score up to summation order.

    Dense attention path only: the banded kernel schedules assume that
    physical distance equals positional distance, which the interleaved
    candidate segments break."""
    return make_prefill_fn(cfg, yes_id=yes_id, no_id=no_id, window=window,
                           multi_target=True)


def _rope_read(k: torch.Tensor, pos: torch.Tensor, theta: float):
    """Rope cached (unroped) keys with their stored positions; slots with
    pos < 0 are masked later, rope them at 0."""
    return apply_rope(k, pos.clamp(min=0), theta)


def _write_plan(dest: torch.Tensor, keep: torch.Tensor):
    """Flat scatter indices for one step's KV writes, without a host sync.

    ``dest (B, s)`` is each token's flat slot (``row * cap + slot`` in a
    contiguous cache, the physical pool slot in a paged one) and ``keep``
    marks the tokens whose write lands: a chunk right-padded to its bucket
    may point past capacity, or at a page that is not mapped, and those
    writes must vanish (the reference's ``mode="drop"``). A dropped write
    must never be clamped or wrapped onto another slot: a negative index
    would wrap onto the pool's last slot, a live page under pool pressure.

    So a dropped token is sent to the slot of the first kept token and
    carries that token's value: duplicate indices then hold identical
    values, whichever write lands last. If no token of the step is kept,
    every write goes to flat slot 0 with the value slot 0 already holds.
    Returns (indices (N,), source token of each value (N,), any kept).
    """
    dest, keep = dest.reshape(-1).long(), keep.reshape(-1)
    first = torch.argmax(keep.to(torch.uint8)).reshape(1)
    any_kept = keep.any()
    src = torch.where(keep, torch.arange(dest.numel(), device=dest.device),
                      first)
    idx = torch.where(keep, dest,
                      torch.where(any_kept, dest.index_select(0, first), 0))
    return idx, src, any_kept


def _cache_write(buf: torch.Tensor, plan, new: torch.Tensor) -> None:
    """Scatter fresh KV (codes or scales) ``new (B, s, ...)`` into one
    layer's cache tensor in place: ``buf (B, cap, ...)`` contiguous or
    ``(n_slots, ...)`` paged, through ``_write_plan``'s indices."""
    idx, src, any_kept = plan
    flat = buf.flatten(0, 1) if buf.dim() == new.dim() else buf
    vals = new.reshape((-1,) + new.shape[2:]).to(buf.dtype)
    vals = vals.index_select(0, src)
    vals = torch.where(any_kept, vals, flat[:1])
    flat.index_put_((idx,), vals)


def _cache_view(buf: torch.Tensor, read_idx):
    """Row-major read view: the tensor itself for the contiguous layout,
    the page gather ``buf[read_idx]`` (B, cap, ...) for the paged one
    (``read_idx`` clamped: unmapped entries gather arbitrary pool slots,
    which ``pos = -1`` keeps unattendable)."""
    return buf if read_idx is None else buf[read_idx]


def _ffn(lp: Params, h, cfg: ModelConfig, kind: str):
    """The layer's FFN block, dense SwiGLU or MoE; a decode step drops the
    MoE balance loss, as the reference's serving path does."""
    return h + ffn(lp, rmsnorm(lp["ln_ffn"], h, cfg.norm_eps), cfg, kind)[0]


def _gqa_decode_layer(lp: Params, h, kv: Dict[str, torch.Tensor], *,
                      cfg: ModelConfig, kind: str, plan, read_idx, pos_buf,
                      positions, is_sum, window: int, seg_q=None,
                      seg_buf=None, impl="dense"):
    b, s, _ = h.shape
    hq, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    quant = "k_scale" in kv
    x = rmsnorm(lp["ln_attn"], h, cfg.norm_eps)
    q = dense(lp["attn"]["q"], x).reshape(b, s, hq, hd)
    k_new = dense(lp["attn"]["k"], x).reshape(b, s, hk, hd)
    v_new = dense(lp["attn"]["v"], x).reshape(b, s, hk, hd)
    if quant:
        # quantize on write: codes and their per-(slot, head) scales land
        # on the same slots in the same step, so pages stay self-describing
        k_new, k_sv = quantize_q8(k_new)
        v_new, v_sv = quantize_q8(v_new)
        _cache_write(kv["k_scale"], plan, k_sv)
        _cache_write(kv["v_scale"], plan, v_sv)
    _cache_write(kv["k"], plan, k_new)
    _cache_write(kv["v"], plan, v_new)
    k_raw = _cache_view(kv["k"], read_idx)
    v_raw = _cache_view(kv["v"], read_idx)

    q_rope = apply_rope(q, positions, cfg.rope_theta)
    nope = cfg.dti_sum_alibi
    attend = decode_attention if impl == "cuda" else decode_attention_plain
    kw = dict(window=window, is_sum_q=is_sum if nope else None,
              q_nope=q if nope else None,
              alibi=alibi_slopes(hq, h.device) if nope else None,
              seg_q=seg_q, seg_k=seg_buf, scale=hd ** -0.5)
    if quant:
        # the int8 contract: raw codes plus scale views go to the kernel,
        # which dequantizes and ropes them itself (no roped copy of K; the
        # NoPE stream is the same codes unrotated). The dense path's plain
        # version dequantizes the views first, as the reference's does.
        out = attend(q_rope, k_raw, v_raw, positions, pos_buf,
                     k_scale=_cache_view(kv["k_scale"], read_idx)[..., None],
                     v_scale=_cache_view(kv["v_scale"], read_idx),
                     rope_start=0, rope_theta=cfg.rope_theta, **kw)
    else:
        # two key views per layer, as in the reference: the roped copy for
        # ordinary rows and the raw cache for the NoPE stream of [SUM] rows
        # (the roped copy is a full-capacity pass per layer; PERF.md)
        out = attend(q_rope, _rope_read(k_raw, pos_buf, cfg.rope_theta),
                     v_raw, positions, pos_buf,
                     k_nope=k_raw if nope else None, **kw)
    h = h + dense(lp["attn"]["o"], out.to(h.dtype).reshape(b, s, hq * hd))
    return _ffn(lp, h, cfg, kind)


def _mla_decode_layer(lp: Params, h, kv: Dict[str, torch.Tensor], *,
                      cfg: ModelConfig, kind: str, plan, read_idx, pos_buf,
                      positions, is_sum, window: int, seg_q=None,
                      seg_buf=None, impl="dense"):
    """Absorbed-MLA decode: scores and values against the latent cache.

    W_UK folds into the query (q_abs = q_nope W_UK, r_kv wide) and the
    latent and rope streams concatenate, so one MQA product covers both
    terms: q_eff . k_eff = q_abs . ckv + q_pe_rope . kpe_rope, with
    q_eff = [q_abs | q_pe_rope], k_eff = [ckv | kpe_rope] and values the
    latent itself (Dv = r_kv); W_UV folds after. [SUM] rows score the
    unroped pair [q_abs | q_pe] . [ckv | kpe]. As in the reference, the
    absorbed weights are ``kv_up``'s ``w`` alone (its LoRA adapter, if
    any, takes no part). The MLA mode (``decode_attention_mla``) reads
    the cache's tensors in place: ``ckv``, the roped ``kpe`` view (bf16
    KV) and the raw ``kpe`` ([SUM] rows); on int8 KV the ``ckv`` and
    ``kpe`` codes with their scales (two groups split at r_kv), and it
    ropes the tail itself; values are the ``ckv`` codes with their
    scale."""
    b, s, _ = h.shape
    hq, r = cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    quant = "ckv_scale" in kv
    ap = lp["attn"]
    x = rmsnorm(lp["ln_attn"], h, cfg.norm_eps)
    q = mla_query(ap, x, hq, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    q_pe_rope = apply_rope(q_pe, positions, cfg.rope_theta)
    c_new = rmsnorm(ap["kv_norm"], dense(ap["kv_down"], x))        # (B,s,r)
    kpe_new = dense(ap["k_rope"], x)                               # (B,s,dr)
    if quant:
        # the latent and rope streams quantize separately: per-token
        # scales, written on the same slots as their codes
        c_new, c_sv = quantize_q8(c_new)
        kpe_new, p_sv = quantize_q8(kpe_new)
        _cache_write(kv["ckv_scale"], plan, c_sv)
        _cache_write(kv["kpe_scale"], plan, p_sv)
    _cache_write(kv["ckv"], plan, c_new)
    _cache_write(kv["kpe"], plan, kpe_new)
    ckv_v = _cache_view(kv["ckv"], read_idx)                       # (B,cap,r)
    kpe_v = _cache_view(kv["kpe"], read_idx)

    w_up = ap["kv_up"]["w"].reshape(r, hq, dn + dv)
    w_uk, w_uv = w_up[..., :dn], w_up[..., dn:]
    q_abs = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)            # (B,s,H,r)
    nope = cfg.dti_sum_alibi
    attend = (decode_attention_mla if impl == "cuda"
              else decode_attention_mla_plain)
    kw = dict(window=window, is_sum_q=is_sum if nope else None,
              q_nope=torch.cat([q_abs, q_pe], dim=-1) if nope else None,
              alibi=alibi_slopes(hq, h.device) if nope else None,
              seg_q=seg_q, seg_k=seg_buf, scale=(dn + dr) ** -0.5)
    q_eff = torch.cat([q_abs, q_pe_rope], dim=-1)
    if quant:
        o_lat = attend(q_eff, ckv_v, kpe_v, positions, pos_buf,
                       ckv_scale=_cache_view(kv["ckv_scale"], read_idx),
                       kpe_scale=_cache_view(kv["kpe_scale"], read_idx),
                       rope_theta=cfg.rope_theta, **kw)
    else:
        kpe_rope = _rope_read(kpe_v[:, :, None], pos_buf, cfg.rope_theta)
        o_lat = attend(q_eff, ckv_v, kpe_v, positions, pos_buf,
                       kpe_rope=kpe_rope[:, :, 0], **kw)
    out = torch.einsum("bshr,rhd->bshd", o_lat.to(h.dtype), w_uv)
    h = h + dense(ap["o"], out.reshape(b, s, hq * dv))
    return _ffn(lp, h, cfg, kind)


def make_decode_fn(cfg: ModelConfig, *, window: int, ring: bool,
                   yes_id: int = 3, no_id: int = 4,
                   attn_impl: Optional[str] = None) -> Callable:
    """(params, cache, tokens (B,s), positions (B,s), is_sum (B,s)[, valid
    (B,s), commit (B,), seg (B,s)]) -> (p_click (B, s), cache).

    ``attn_impl`` picks the attention: ``"cuda"`` (the decode kernel),
    ``"dense"`` (the plain oracle), or None: ``"cuda"`` when
    ``cfg.attn_impl`` is, else ``"dense"`` (a config that prefills on the
    blocked path decodes densely, as in the reference). MLA models decode
    in absorbed form (``_mla_decode_layer``).

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

    The layout comes from the cache. Paged caches read and write through
    ``physical_slots`` (``ring=False`` only); the kernel gets the gathered
    per-row view, so a paged step computes exactly what a contiguous one
    holding the same KV computes. int8 caches quantize on write and hand
    the kernel raw codes and scales (``decode_attention``'s int8 mode).

    Dispatching a step makes no host sync: dropped writes are resolved on
    the device (``_write_plan``), so a caller can keep a step in flight.
    """
    check_supported(cfg)
    if attn_impl is None:
        if cfg.attn_impl not in ("dense", "blocked", "cuda"):
            raise ValueError(f"unknown attention impl {cfg.attn_impl!r}")
        attn_impl = "cuda" if cfg.attn_impl == "cuda" else "dense"
    if attn_impl not in ("dense", "cuda"):
        raise ValueError(f"unknown decode attention impl {attn_impl!r}")
    layer_fn = _mla_decode_layer if cfg.attn_type == "mla" else \
        _gqa_decode_layer

    @torch.no_grad()
    def decode(params: Params, cache: Cache, tokens, positions, is_sum,
               valid=None, commit=None, seg=None):
        b, s = tokens.shape
        cap = cache["pos"].shape[1]
        slots = slot_indices(cache, s, ring=ring)
        inside = slots < cap
        read_idx = None
        if is_paged(cache):
            if ring:
                raise ValueError("paged caches are non-ring")
            flat = physical_slots(cache)
            dest = torch.gather(flat, 1, slots.clamp(max=cap - 1))
            keep = inside & (dest >= 0)
            read_idx = flat.clamp(min=0).long()
        else:
            dest = torch.arange(b, device=slots.device)[:, None] * cap + slots
            keep = inside
        plan = _write_plan(dest, keep)
        # bookkeeping writes past capacity land in a spare column that is
        # cut off again (no sync, nothing wraps)
        col = slots.clamp(max=cap)
        pos_write = (positions if valid is None
                     else torch.where(valid, positions, -1))
        pos_buf = torch.cat([cache["pos"], cache["pos"].new_full((b, 1), -1)],
                            dim=1)
        pos_buf.scatter_(1, col, pos_write.to(torch.int32))
        pos_buf = pos_buf[:, :cap].contiguous()
        seg_buf = None
        if seg is not None:
            seg_buf = torch.full((b, cap + 1), -1, dtype=torch.int32,
                                 device=tokens.device)
            seg_buf.scatter_(1, col, seg.to(torch.int32))
            seg_buf = seg_buf[:, :cap].contiguous()

        h = params["embed"][tokens].to(cfg.cdtype)
        for li, lp in enumerate(params["layers"]):
            kv = {nm: cache[nm][li] for nm in kv_keys(cache)}
            h = layer_fn(lp, h, kv, cfg=cfg, kind=cfg.layer_kind(li),
                         plan=plan, read_idx=read_idx,
                         pos_buf=pos_buf, positions=positions, is_sum=is_sum,
                         window=window, seg_q=seg, seg_buf=seg_buf,
                         impl=attn_impl)

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
    """Batched pointwise CTR scorer over ``max_len``-padded rows.

    * ``score`` — one sliding-window prompt per candidate (the paper's
      procedure: the context is encoded again for every candidate).
    * ``score_multi_target`` — one multi-target row per request (shared
      context + k isolated candidate segments): the context is encoded
      once per request, on the dense attention path."""
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
        self._mt_prefill = make_multi_target_prefill_fn(
            self.cfg, yes_id=self.yes_id, no_id=self.no_id)

    def _run(self, fn, rows, keys) -> np.ndarray:
        batch = {k: np.stack([r[k] for r in rows]) for k in keys}
        if batch["tokens"].shape[1] != self.max_len:
            raise ValueError(f"rows of length {batch['tokens'].shape[1]} "
                             f"!= max_len {self.max_len}")
        tb = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
        return fn(self.params, tb).float().cpu().numpy()

    def score(self, prompts) -> List[float]:
        p = self._run(self._prefill, prompts,
                      ("tokens", "positions", "is_sum", "valid"))
        out = []
        for i, prompt in enumerate(prompts):
            sums = np.flatnonzero(prompt["is_sum"])
            out.append(float(p[i, sums[-1]]) if len(sums) else 0.5)
        return out

    def score_multi_target(self, requests) -> List[List[float]]:
        """``requests``: (context_tokens, candidate_tokens) pairs, each a
        list of per-interaction / per-candidate token lists. Returns the k
        candidate scores of each request, in candidate order."""
        rows = [build_multi_target_request(ctx, cands, max_len=self.max_len)
                for ctx, cands in requests]
        p = self._run(self._mt_prefill, rows,
                      ("tokens", "positions", "segment_ids", "is_sum",
                       "valid"))
        return [[float(p[i, j]) for j in candidate_sum_slots(row)]
                for i, row in enumerate(rows)]


__all__ = ["make_prefill_fn", "make_multi_target_prefill_fn",
           "make_decode_fn", "CTRServer"]
