"""Windowed DTI attention forward: CUDA kernel wrapper and its plain version.

Replaces the Pallas TPU kernel ``repro.kernels.windowed_attn.windowed_attn``
(``_kernel``, launched by ``windowed_attention_fwd_bhsd``) with
``csrc/windowed_attn.cu``. Same public layout as
``repro.kernels.windowed_attn.ops.windowed_attention``: q ``(B, S, H, Dqk)``,
k ``(B, S, Hk, Dqk)``, v ``(B, S, Hk, Dv)`` -> o ``(B, S, H, Dv)`` in q's
dtype, plus the fp32 row logsumexp ``(B, H, S)`` (``+1e30`` on rows with no
key) when ``return_lse`` is set. The kernel reads this layout in place: no
transpose, and no copy of K/V per query head (GQA maps head h to kv head
h // n_rep).

Schedule contract (as the reference's): the band of kv blocks a q block
visits is physical (rows within ``window`` of the block), the mask is
positional. The two agree because physical distance equals positional
distance on every attendable pair, which is why shared-prefix rows stay on
the dense path (``repro_torch.core.windowed.attention``).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. Forward only: the backward kernels come with the training slice.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import as_i32, check_launch, load, ptr
from repro_torch.core.windowed import ResetConfig, attention_dense

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {"windowed_attn_fwd": [_P] * 16 + [_I] * 12 + [_F] * 4 + [_P]}
MAX_HEAD_DIM = 128


def windowed_attention_plain(q, k, v, *, pos_q, pos_k, window: int,
                             is_sum_q=None, is_sum_k=None, valid_k=None,
                             seg_q=None, seg_k=None, q_nope=None,
                             k_nope=None, alibi=None, v0=None,
                             reset: Optional[ResetConfig] = None,
                             sum_isolated: bool = True,
                             scale: Optional[float] = None):
    """Plain PyTorch version of the kernel: returns ``(o, lse)``."""
    use_nope = q_nope is not None and is_sum_q is not None
    use_reset = reset is not None and v0 is not None
    return attention_dense(
        q, k, v, pos_q=pos_q, pos_k=pos_k, window=window, is_sum_q=is_sum_q,
        is_sum_k=is_sum_k, valid_k=valid_k, seg_q=seg_q, seg_k=seg_k,
        q_nope=q_nope if use_nope else None,
        k_nope=k_nope if use_nope else None,
        alibi=alibi if use_nope else None,
        v0=v0 if use_reset else None, reset=reset if use_reset else None,
        sum_isolated=sum_isolated and is_sum_k is not None, scale=scale,
        return_lse=True)


def windowed_attention(q, k, v, *, pos_q, pos_k, window: int,
                       is_sum_q=None, is_sum_k=None, valid_k=None,
                       seg_q=None, seg_k=None, q_nope=None, k_nope=None,
                       alibi=None, v0=None,
                       reset: Optional[ResetConfig] = None,
                       sum_isolated: bool = True,
                       scale: Optional[float] = None,
                       return_lse: bool = False):
    """Windowed DTI attention; ``(o, lse)`` when ``return_lse``, else o."""
    if window <= 0:
        raise ValueError("the windowed kernel needs a window > 0")
    kw = dict(pos_q=pos_q, pos_k=pos_k, window=window, is_sum_q=is_sum_q,
              is_sum_k=is_sum_k, valid_k=valid_k, seg_q=seg_q, seg_k=seg_k,
              q_nope=q_nope, k_nope=k_nope, alibi=alibi, v0=v0, reset=reset,
              sum_isolated=sum_isolated, scale=scale)
    if q.device.type == "cpu":
        o, lse = windowed_attention_plain(q, k, v, **kw)
        return (o, lse) if return_lse else o
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    o, lse = _launch(q, k, v, **kw)
    return (o, lse) if return_lse else o


def _launch(q, k, v, *, pos_q, pos_k, window, is_sum_q, is_sum_k, valid_k,
            seg_q, seg_k, q_nope, k_nope, alibi, v0, reset, sum_isolated,
            scale):
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (q, k, v, q_nope, k_nope, v0)):
        raise NotImplementedError(
            "the windowed-attention kernel is forward only; its backward "
            "kernels come with the training slice")
    b, s, h, d = q.shape
    hk, dv = k.shape[2], v.shape[3]
    use_nope = q_nope is not None and is_sum_q is not None
    use_reset = reset is not None and v0 is not None
    use_seg = seg_q is not None and seg_k is not None
    sum_isolated = sum_isolated and is_sum_k is not None
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unsupported dtype {q.dtype}")
    if k.shape != (b, s, hk, d) or v.shape[:3] != (b, s, hk) or h % hk:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not fit (self-attention, "
                         "H a multiple of Hk)")
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"head dims {d}/{dv} exceed {MAX_HEAD_DIM}")
    ops = [q, k, v] + ([q_nope, k_nope] if use_nope else []) + (
        [v0] if use_reset else [])
    for t in ops:
        if t.dtype != q.dtype or t.device != q.device or not t.is_contiguous():
            raise ValueError("q/k/v/q_nope/k_nope/v0 must share q's dtype and "
                             "device and be contiguous")
    if use_nope and (q_nope.shape != q.shape or k_nope.shape != k.shape):
        raise ValueError("q_nope/k_nope must have the shapes of q/k")
    if use_reset and v0.shape != v.shape:
        raise ValueError("v0 must have the shape of v")
    if scale is None:
        scale = d ** -0.5
    y_min, y_max, mid = ((reset.y_min, reset.y_max, reset.midpoint)
                         if use_reset else (0.0, 0.0, 0.0))

    o = torch.empty((b, s, h, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    # int32 copies of the index/flag operands, held until the launch is
    # enqueued (a freed copy's memory could be handed to the next one)
    on = lambda t, use: as_i32(t) if use else None
    ints = [as_i32(pos_q), as_i32(pos_k), on(is_sum_q, use_nope or use_reset),
            on(is_sum_k, sum_isolated), as_i32(valid_k), on(seg_q, use_seg),
            on(seg_k, use_seg)]
    alibi_f = (alibi.float().contiguous() if use_nope and alibi is not None
               else torch.zeros(h, dtype=torch.float32, device=q.device))
    lib = load("windowed_attn", _ARGTYPES)
    rc = lib.windowed_attn_fwd(
        ptr(q), ptr(q_nope if use_nope else None), ptr(k),
        ptr(k_nope if use_nope else None), ptr(v),
        ptr(v0 if use_reset else None), ptr(alibi_f), *map(ptr, ints),
        ptr(o), ptr(lse),
        b, s, h, hk, d, dv, int(window), int(use_nope), int(use_reset),
        int(sum_isolated), int(use_seg), int(q.dtype == torch.bfloat16),
        float(scale), float(y_min), float(y_max), float(mid),
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("windowed_attn", rc)
    return o, lse


__all__ = ["windowed_attention", "windowed_attention_plain"]
