"""Decode/burst attention into the KV cache: CUDA kernel wrapper and its
plain version.

Replaces the Pallas TPU kernel ``repro.kernels.decode_attn.decode_attn``
(``_kernel``, launched by ``decode_attention_bshd``) in both its modes
with ``csrc/decode_attn.cu``. Operands stay in the serving cache layout:
queries ``(B, s, H, Dqk)``, cache-side tensors ``(B, cap, Hk, D)``; the
kernel stages each K/V tile once for all ``n_rep`` query heads and all
``s`` queries of its kv head, so GQA reads the cache once.

Attendable iff the slot is filled (``pos_k >= 0``), causal, within
``window`` when ``window > 0`` (0 = unlimited), and segment-compatible
(``seg_k < 0`` shared, else ``seg_k == seg_q``). Rows flagged ``is_sum_q``
score the NoPE stream minus ``alibi * distance``. Rows with no key give 0.

``k_scale`` switches to the int8 mode (the quantized-KV contract of
``repro_torch.core.quant``): ``k``/``v`` are raw int8 cache codes, unroped;
``k_scale (B, cap, Hk, G)`` (G in {1, 2}: two scale groups split at
``rope_start``) and ``v_scale (B, cap, Hk)`` are their fp32 scales. Keys
are dequantized and their span ``[rope_start:]`` roped from
``max(pos_k, 0)`` inside the kernel (launch key ``"decode_attn_q8"``); the
NoPE stream is the same codes dequantized without rotation, so ``k_nope``
must be None there.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import as_i32, check_launch, load, ptr
from repro_torch.core.windowed import NEG_INF, _repeat_kv
from repro_torch.models.layers import apply_rope, rope_freqs

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {"decode_attn_fwd": [_P] * 12 + [_I] * 11 + [_F, _P],
             "decode_attn_q8_fwd": [_P] * 14 + [_I] * 13 + [_F, _P]}
MAX_HEAD_DIM = 128


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


def _check(q, k, v, use_nope, q_nope, k_nope, kv_dtype):
    b, s, h, d = q.shape
    cap, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unsupported dtype {q.dtype}")
    if k.shape != (b, cap, hk, d) or v.shape[:3] != (b, cap, hk) or h % hk:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not fit")
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"head dims {d}/{dv} exceed {MAX_HEAD_DIM}")
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
    # int32 copies of the index/flag operands, held until the launch is
    # enqueued (a freed copy's memory could be handed to the next one)
    on = lambda t, use: as_i32(t) if use else None
    ints = [as_i32(pos_q), as_i32(pos_k), on(is_sum_q, use_nope),
            on(seg_q, use_seg), on(seg_k, use_seg)]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = load("decode_attn", _ARGTYPES)
    if not quant:
        rc = lib.decode_attn_fwd(
            ptr(q), ptr(q_nope if use_nope else None), ptr(k),
            ptr(k_nope if use_nope else None), ptr(v), ptr(alibi_f),
            *map(ptr, ints), ptr(o),
            b, s, h, hk, cap, d, dv, int(window), int(use_nope),
            int(use_seg), int(q.dtype == torch.bfloat16), float(scale),
            stream)
        check_launch("decode_attn", rc)
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
    rc = lib.decode_attn_q8_fwd(
        ptr(q), ptr(q_nope if use_nope else None), ptr(k), ptr(v), ptr(ks),
        ptr(vs), ptr(rinv), ptr(alibi_f), *map(ptr, ints), ptr(o),
        b, s, h, hk, cap, d, dv, g, int(rope_start), int(window),
        int(use_nope), int(use_seg), int(q.dtype == torch.bfloat16),
        float(scale), stream)
    check_launch("decode_attn_q8", rc)
    return o


__all__ = ["decode_attention", "decode_attention_plain"]
