"""Decode/burst attention into the KV cache: CUDA kernel wrapper and its
plain version.

Replaces the Pallas TPU kernel ``repro.kernels.decode_attn.decode_attn``
(``_kernel``, launched by ``decode_attention_bshd``) in both its modes
with ``csrc/decode_attn.cu``. Operands stay in the serving cache layout:
queries ``(B, s, H, Dqk)``, cache-side tensors ``(B, cap, Hk, D)``; each
K/V tile the kernel stages serves a block of ``ROW_BLOCK`` of the
``n_rep`` heads x ``s`` queries of its kv head (GQA), and the other blocks
of that kv head read it from L2.

Attendable iff the slot is filled (``pos_k >= 0``), causal, within
``window`` when ``window > 0`` (0 = unlimited), and segment-compatible
(``seg_k < 0`` shared, else ``seg_k == seg_q``). Rows flagged ``is_sum_q``
score the NoPE stream minus ``alibi * distance``. Rows with no key give 0.

Head dims up to ``MAX_HEAD_DIM`` (128) take the GQA mode (launch keys
``"decode_attn"``, ``"decode_attn_q8"``). Wider ones, up to
``MLA_MAX_QK`` / ``MLA_MAX_V`` (288 / 256: absorbed MLA at minicpm3-4b,
Hk = 1, q = [q_abs | q_pe] against the latent cache), take the MLA mode
(``"decode_attn_mla"``, ``"decode_attn_mla_q8"``), the same kernel with
wider Q/K planes and the value columns split over CTAs in chunks of
``VALUE_CHUNK``. deepseek-v2's 576 / 512 is refused (ROADMAP queue B).

``k_scale`` switches to the int8 mode (the quantized-KV contract of
``repro_torch.core.quant``): ``k``/``v`` are raw int8 cache codes, unroped;
``k_scale (B, cap, Hk, G)`` (G in {1, 2}: two scale groups split at
``rope_start``) and ``v_scale (B, cap, Hk)`` are their fp32 scales. Keys
are dequantized and their span ``[rope_start:]`` roped from
``max(pos_k, 0)`` inside the kernel (launch key ``"decode_attn_q8"``); the
NoPE stream is the same codes dequantized without rotation, so ``k_nope``
must be None there.

The kernel's work is split by ``decode_split_plan``: blocks of
``ROW_BLOCK`` query rows, and, where those are too few to cover the card's
SMs, ranges of the cache whose fp32 partials go to a workspace this
wrapper allocates and the same C entry point combines in a fixed order
(one launch count per call; equal inputs give equal bits).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import as_i32, check_launch, load, ptr, sm_count
from repro_torch.core.windowed import NEG_INF, _repeat_kv
from repro_torch.models.layers import apply_rope, rope_freqs

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {"decode_attn_fwd": [_P] * 13 + [_I] * 14 + [_F, _P],
             "decode_attn_q8_fwd": [_P] * 15 + [_I] * 16 + [_F, _P],
             "decode_attn_mla_fwd": [_P] * 13 + [_I] * 15 + [_F, _P],
             "decode_attn_mla_q8_fwd": [_P] * 15 + [_I] * 17 + [_F, _P]}
MAX_HEAD_DIM = 128  # the GQA mode's head dims (DMAX in csrc/decode_attn.cu)
MLA_MAX_QK = 288    # the MLA mode's qk and value head dims (MLA_DQK,
MLA_MAX_V = 256     # MLA_DV there)
VALUE_CHUNK = 128   # value columns per CTA (DMAX there)
ROW_BLOCK = 64      # query rows per CTA (RB there)
KV_TILE = 32        # cache slots per staged tile (BK there)
MAX_TILES = 256     # tiles of one cache range (MAX_TILES there)


class SplitPlan(NamedTuple):
    """How one call's work is cut: ``n_rb`` blocks of ``ROW_BLOCK`` rows
    (n_rep heads x s queries of a kv head) times ``n_dv`` chunks of
    ``VALUE_CHUNK`` value columns (more than one only in the MLA mode)
    times ``n_split`` cache ranges of ``span`` slots, for each (kv head,
    batch row): ``grid`` CTAs. ``workspace`` fp32 values hold the ranges'
    partial rows (acc, then m, then l) when ``n_split > 1``, else 0."""
    n_rb: int
    n_dv: int
    n_split: int
    span: int
    grid: int
    workspace: int


def decode_split_plan(b: int, s: int, h: int, hk: int, cap: int, n_sm: int,
                      dv: int = MAX_HEAD_DIM) -> SplitPlan:
    """Row blocks (and value chunks) first: they re-read K/V tiles from
    L2 and need no workspace. Only when ``b * hk * n_rb * n_dv`` CTAs
    leave SMs idle (or a range would exceed ``MAX_TILES`` tiles, the
    kernel's list of live tiles) is the cache cut into the fewest equal
    ranges of whole tiles that cover ``n_sm``: each range costs
    ``b * s * h * (dv + 2)`` fp32 of partials, written once and read
    once. (Equal ranges of whole tiles can come out fewer than asked, 64
    tiles in 9 ranges being 8 of 8: then one more is asked for.)"""
    n_rb = -(-(h // hk) * s // ROW_BLOCK)
    n_dv = -(-dv // VALUE_CHUNK)
    base = b * hk * n_rb * n_dv
    n_tiles = max(1, -(-cap // KV_TILE))
    want = min(n_tiles, max(1, -(-n_sm // max(base, 1)),
                            -(-n_tiles // MAX_TILES)))
    per = -(-n_tiles // want)
    while per > 1 and base * -(-n_tiles // per) < n_sm:
        want += 1
        per = -(-n_tiles // want)
    n_split = -(-n_tiles // per)
    ws = n_split * b * s * h * (dv + 2) if n_split > 1 else 0
    return SplitPlan(n_rb, n_dv, n_split, per * KV_TILE, base * n_split, ws)


def split_workspace(plan: SplitPlan, device) -> Optional[torch.Tensor]:
    """The fp32 workspace a call with ``plan`` hands the kernel, or None
    when it has one cache range."""
    if not plan.workspace:
        return None
    return torch.empty(plan.workspace, dtype=torch.float32, device=device)


def _decode_mask(pos_k, pos_q, window: int, seg_q=None, seg_k=None):
    """(B, s, cap) attendability: filled slot, causal, the window term only
    when window > 0, and in-burst segment isolation."""
    m = (pos_k[:, None, :] >= 0) & (pos_q[:, :, None] >= pos_k[:, None, :])
    if window > 0:
        m = m & ((pos_q[:, :, None] - pos_k[:, None, :]) <= window)
    if seg_q is not None and seg_k is not None:
        m = m & ((seg_k[:, None, :] < 0)
                 | (seg_k[:, None, :] == seg_q[:, :, None]))
    return m


def _dequant_keys(k, k_scale, pos_k, rope_start: int, rope_theta: float):
    """int8 key codes -> (roped keys, unroped keys), fp32, as the reference's
    ``decode_attn/ref.py`` computes them: dequantize with the per-dim scale
    row, then rope the span ``[rope_start:]`` from ``max(pos_k, 0)``."""
    kf = k.float()
    if k_scale.shape[-1] == 1:
        sc = k_scale.float()
    else:                          # two groups split at rope_start
        idx = torch.arange(k.shape[-1], device=k.device)
        sc = torch.where(idx < rope_start, k_scale[..., 0:1].float(),
                         k_scale[..., 1:2].float())
    kd = kf * sc
    roped = apply_rope(kd[..., rope_start:], pos_k.clamp(min=0), rope_theta)
    if rope_start:
        roped = torch.cat([kd[..., :rope_start], roped], dim=-1)
    return roped, kd


def decode_attention_plain(q, k, v, pos_q, pos_k, *, window: int,
                           is_sum_q=None, q_nope=None, k_nope=None,
                           alibi=None, seg_q=None, seg_k=None,
                           scale: Optional[float] = None, k_scale=None,
                           v_scale=None, rope_start: int = 0,
                           rope_theta: float = 10000.0) -> torch.Tensor:
    """Plain PyTorch version (mirrors ``decode_attn/ref.py``): the engine's
    dense decode math on the kernel's operands -> (B, s, H, Dv), in q's
    dtype. With ``k_scale`` the int8 operands are dequantized and roped
    first (``_dequant_keys``)."""
    h, d = q.shape[2], q.shape[3]
    n_rep = h // k.shape[2]
    if scale is None:
        scale = d ** -0.5
    nope = q_nope is not None and is_sum_q is not None
    if k_scale is not None:
        if k_nope is not None:
            raise ValueError("the int8 mode derives the NoPE stream from the "
                             "codes: k_nope must be None")
        k, kd = _dequant_keys(k, k_scale, pos_k, rope_start, rope_theta)
        k_nope = kd if nope else None
        v = v.float() * v_scale.float()[..., None]
    sc = torch.einsum("bshd,bkhd->bhsk", q.float(),
                      _repeat_kv(k, n_rep).float()) * scale
    if nope:
        dist = (pos_q[:, None, :, None] - pos_k[:, None, None, :]).float()
        sn = torch.einsum("bshd,bkhd->bhsk", q_nope.float(),
                          _repeat_kv(k_nope, n_rep).float()) * scale
        sn = sn - alibi.float()[None, :, None, None] * dist
        sc = torch.where(is_sum_q[:, None, :, None], sn, sc)
    mask = _decode_mask(pos_k, pos_q, window, seg_q, seg_k)
    sc = sc.masked_fill(~mask[:, None], NEG_INF)
    probs = torch.softmax(sc, dim=-1) * mask.any(dim=-1)[:, None, :, None]
    probs = probs.to(q.dtype)
    if k_scale is not None:        # fp32 values: the product is fp32
        probs = probs.float()
    return torch.einsum("bhsk,bkhd->bshd", probs,
                        _repeat_kv(v, n_rep)).to(q.dtype)


def is_mla_mode(d: int, dv: int) -> bool:
    """Whether head dims ``d`` (qk) and ``dv`` take the MLA mode."""
    return d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM


def _check(q, k, v, use_nope, q_nope, k_nope, kv_dtype):
    b, s, h, d = q.shape
    cap, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unsupported dtype {q.dtype}")
    if k.shape != (b, cap, hk, d) or v.shape[:3] != (b, cap, hk) or h % hk:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not fit")
    if d > MLA_MAX_QK or dv > MLA_MAX_V:
        raise ValueError(
            f"head dims {d}/{dv} exceed the MLA mode's {MLA_MAX_QK}/"
            f"{MLA_MAX_V} (deepseek-v2's 576/512 is not ported: ROADMAP "
            "queue B)")
    for t in [q] + ([q_nope] if use_nope else []):
        if t.dtype != q.dtype or t.device != q.device or not t.is_contiguous():
            raise ValueError("q/q_nope must share q's dtype and device and "
                             "be contiguous")
    for t in [k, v] + ([k_nope] if k_nope is not None else []):
        if (t.dtype != kv_dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"k/v/k_nope must be {kv_dtype}, on q's device "
                             "and contiguous")
    if use_nope and q_nope.shape != q.shape:
        raise ValueError("q_nope must have the shape of q")
    if k_nope is not None and k_nope.shape != k.shape:
        raise ValueError("k_nope must have the shape of k")


def decode_attention(q, k, v, pos_q, pos_k, *, window: int, is_sum_q=None,
                     q_nope=None, k_nope=None, alibi=None, seg_q=None,
                     seg_k=None, scale: Optional[float] = None, k_scale=None,
                     v_scale=None, rope_start: int = 0,
                     rope_theta: float = 10000.0) -> torch.Tensor:
    """Fused burst attention into the cache -> (B, s, H, Dv)."""
    use_nope = q_nope is not None and is_sum_q is not None
    use_seg = seg_q is not None and seg_k is not None
    quant = k_scale is not None
    if quant and (v_scale is None or k_nope is not None):
        raise ValueError("the int8 mode needs k_scale and v_scale together "
                         "and derives the NoPE stream from the codes "
                         "(k_nope must be None)")
    kw = dict(window=window, is_sum_q=is_sum_q if use_nope else None,
              q_nope=q_nope if use_nope else None,
              k_nope=k_nope if use_nope else None,
              alibi=alibi if use_nope else None,
              seg_q=seg_q if use_seg else None,
              seg_k=seg_k if use_seg else None, scale=scale)
    if quant:
        kw.update(k_scale=k_scale, v_scale=v_scale, rope_start=rope_start,
                  rope_theta=rope_theta)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, pos_q, pos_k, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")

    b, s, h, d = q.shape
    cap, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    _check(q, k, v, use_nope, q_nope, kw["k_nope"],
           torch.int8 if quant else q.dtype)
    if scale is None:
        scale = d ** -0.5
    o = torch.empty((b, s, h, dv), dtype=q.dtype, device=q.device)
    alibi_f = (alibi.float().contiguous() if use_nope
               else torch.zeros(h, dtype=torch.float32, device=q.device))
    # int32 (the [SUM] flags: bool) copies of the index and flag operands,
    # held until the launch is enqueued (a freed copy's memory could be
    # handed to the next one); no copy where they already are
    on = lambda t, use: as_i32(t) if use else None
    ints = [as_i32(pos_q), as_i32(pos_k),
            is_sum_q.to(torch.bool).contiguous() if use_nope else None,
            on(seg_q, use_seg), on(seg_k, use_seg)]
    plan = decode_split_plan(b, s, h, hk, cap, sm_count(q.device), dv)
    ws = split_workspace(plan, q.device)
    # the MLA mode's entry points take the plan's value chunks too
    mla = is_mla_mode(d, dv)
    split = ((plan.n_rb, plan.n_split, plan.span, plan.n_dv) if mla
             else (plan.n_rb, plan.n_split, plan.span))
    name = "decode_attn_mla" if mla else "decode_attn"
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = load("decode_attn", _ARGTYPES)
    if not quant:
        rc = getattr(lib, f"{name}_fwd")(
            ptr(q), ptr(q_nope if use_nope else None), ptr(k),
            ptr(k_nope if use_nope else None), ptr(v), ptr(alibi_f),
            *map(ptr, ints), ptr(o), ptr(ws),
            b, s, h, hk, cap, d, dv, int(window), int(use_nope),
            int(use_seg), int(q.dtype == torch.bfloat16), *split,
            float(scale), stream)
        check_launch(name, rc)
        return o

    g = k_scale.shape[-1]
    if (k_scale.shape != (b, cap, hk, g) or g not in (1, 2)
            or v_scale.shape != (b, cap, hk)):
        raise ValueError(f"scales k {tuple(k_scale.shape)} v "
                         f"{tuple(v_scale.shape)} do not fit k "
                         f"{tuple(k.shape)}")
    if not 0 <= rope_start < d or (d - rope_start) % 2:
        raise ValueError(f"rope_start {rope_start} must leave an even span "
                         f"of the head dim {d}")
    ks = k_scale.float().contiguous()
    vs = v_scale.float().contiguous()
    rinv = rope_freqs(d - rope_start, rope_theta, q.device)
    rc = getattr(lib, f"{name}_q8_fwd")(
        ptr(q), ptr(q_nope if use_nope else None), ptr(k), ptr(v), ptr(ks),
        ptr(vs), ptr(rinv), ptr(alibi_f), *map(ptr, ints), ptr(o), ptr(ws),
        b, s, h, hk, cap, d, dv, g, int(rope_start), int(window),
        int(use_nope), int(use_seg), int(q.dtype == torch.bfloat16), *split,
        float(scale), stream)
    check_launch(f"{name}_q8", rc)
    return o


__all__ = ["SplitPlan", "decode_attention", "decode_attention_plain",
           "decode_split_plan", "is_mla_mode", "split_workspace"]
