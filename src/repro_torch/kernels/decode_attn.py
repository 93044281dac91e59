"""Decode/burst attention into the KV cache: CUDA kernel wrapper and its
plain version.

Replaces the Pallas TPU kernel ``repro.kernels.decode_attn.decode_attn``
(``_kernel``, launched by ``decode_attention_bshd``) in its bf16/fp32 mode
with ``csrc/decode_attn.cu``. Operands stay in the serving cache layout:
queries ``(B, s, H, Dqk)``, cache-side tensors ``(B, cap, Hk, D)``; the
kernel stages each K/V tile once for all ``n_rep`` query heads and all
``s`` queries of its kv head, so GQA reads the cache once.

Attendable iff the slot is filled (``pos_k >= 0``), causal, within
``window`` when ``window > 0`` (0 = unlimited), and segment-compatible
(``seg_k < 0`` shared, else ``seg_k == seg_q``). Rows flagged ``is_sum_q``
score the NoPE stream minus ``alibi * distance``. Rows with no key give 0.
The int8 mode of the reference waits for the int8-cache slice.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import as_i32, check_launch, load, ptr
from repro_torch.core.windowed import NEG_INF, _repeat_kv

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {"decode_attn_fwd": [_P] * 12 + [_I] * 11 + [_F, _P]}
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


def decode_attention_plain(q, k, v, pos_q, pos_k, *, window: int,
                           is_sum_q=None, q_nope=None, k_nope=None,
                           alibi=None, seg_q=None, seg_k=None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version (mirrors ``decode_attn/ref.py``): the engine's
    dense decode math on the kernel's operands -> (B, s, H, Dv)."""
    h, d = q.shape[2], q.shape[3]
    n_rep = h // k.shape[2]
    if scale is None:
        scale = d ** -0.5
    sc = torch.einsum("bshd,bkhd->bhsk", q.float(),
                      _repeat_kv(k, n_rep).float()) * scale
    if q_nope is not None and is_sum_q is not None:
        dist = (pos_q[:, None, :, None] - pos_k[:, None, None, :]).float()
        sn = torch.einsum("bshd,bkhd->bhsk", q_nope.float(),
                          _repeat_kv(k_nope, n_rep).float()) * scale
        sn = sn - alibi.float()[None, :, None, None] * dist
        sc = torch.where(is_sum_q[:, None, :, None], sn, sc)
    mask = _decode_mask(pos_k, pos_q, window, seg_q, seg_k)
    sc = sc.masked_fill(~mask[:, None], NEG_INF)
    probs = torch.softmax(sc, dim=-1) * mask.any(dim=-1)[:, None, :, None]
    return torch.einsum("bhsk,bkhd->bshd", probs.to(q.dtype),
                        _repeat_kv(v, n_rep))


def decode_attention(q, k, v, pos_q, pos_k, *, window: int, is_sum_q=None,
                     q_nope=None, k_nope=None, alibi=None, seg_q=None,
                     seg_k=None, scale: Optional[float] = None) -> torch.Tensor:
    """Fused burst attention into the cache -> (B, s, H, Dv)."""
    use_nope = q_nope is not None and is_sum_q is not None
    use_seg = seg_q is not None and seg_k is not None
    kw = dict(window=window, is_sum_q=is_sum_q if use_nope else None,
              q_nope=q_nope if use_nope else None,
              k_nope=k_nope if use_nope else None,
              alibi=alibi if use_nope else None,
              seg_q=seg_q if use_seg else None,
              seg_k=seg_k if use_seg else None, scale=scale)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, pos_q, pos_k, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")

    b, s, h, d = q.shape
    cap, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unsupported dtype {q.dtype}")
    if k.shape != (b, cap, hk, d) or v.shape[:3] != (b, cap, hk) or h % hk:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not fit")
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"head dims {d}/{dv} exceed {MAX_HEAD_DIM}")
    for t in [q, k, v] + ([q_nope, k_nope] if use_nope else []):
        if t.dtype != q.dtype or t.device != q.device or not t.is_contiguous():
            raise ValueError("q/k/v/q_nope/k_nope must share q's dtype and "
                             "device and be contiguous")
    if use_nope and (q_nope.shape != q.shape or k_nope.shape != k.shape):
        raise ValueError("q_nope/k_nope must have the shapes of q/k")
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
    lib = load("decode_attn", _ARGTYPES)
    rc = lib.decode_attn_fwd(
        ptr(q), ptr(q_nope if use_nope else None), ptr(k),
        ptr(k_nope if use_nope else None), ptr(v), ptr(alibi_f),
        *map(ptr, ints), ptr(o),
        b, s, h, hk, cap, d, dv, int(window), int(use_nope), int(use_seg),
        int(q.dtype == torch.bfloat16), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("decode_attn", rc)
    return o


__all__ = ["decode_attention", "decode_attention_plain"]
