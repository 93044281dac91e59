"""Windowed causal attention with the DTI extensions (counterpart of
``repro.core.windowed``).

Two execution paths with the same semantics:

* ``attention_dense`` — materialises the (Sq, Sk) score matrix. The oracle,
  and the plain version behind the windowed-attention kernel.
* ``repro_torch.kernels.windowed_attn.windowed_attention`` — the
  hand-written CUDA kernel (``impl="cuda"``); on CPU tensors it runs the
  plain version.

DTI semantics (paper sections 3.3, 4.1, 4.2): window mask, [SUM]
isolation, NoPE+ALiBi scores on [SUM] rows, and the distance-based
hidden-state reset ``(1 - a(d)) V(h) + a(d) V(h_init)`` on [SUM] rows.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class ResetConfig:
    """Distance-based hidden-state forgetting (paper eq. in section 4.1)."""
    y_min: float = 0.0
    y_max: float = 0.3
    midpoint: float = 512.0   # N/2 in tokens


def reset_alpha(dist: torch.Tensor, cfg: ResetConfig) -> torch.Tensor:
    """Logistic interpolation ratio a(d); dist is query_pos - key_pos >= 0."""
    d = dist.float()
    return cfg.y_min + (cfg.y_max - cfg.y_min) * torch.sigmoid(d - cfg.midpoint)


def dti_mask(pos_q, pos_k, *, window: int, is_sum_k=None, valid_k=None,
             seg_q=None, seg_k=None,
             seg_shared: Optional[int] = None) -> torch.Tensor:
    """Boolean (..., Sq, Sk) mask: True = attendable.

    causal (pos_q >= pos_k); window (pos_q - pos_k <= window, 0 =
    unlimited); [SUM] keys attendable only by themselves; key padding;
    packed segments (queries attend their own segment, plus segment
    ``seg_shared`` when given).
    """
    d = pos_q[..., :, None] - pos_k[..., None, :]
    m = d >= 0
    if window > 0:
        m = m & (d <= window)
    if is_sum_k is not None:
        m = m & (~is_sum_k[..., None, :] | (d == 0))
    if valid_k is not None:
        m = m & valid_k[..., None, :]
    if seg_q is not None and seg_k is not None:
        same = seg_q[..., :, None] == seg_k[..., None, :]
        if seg_shared is not None:
            same = same | (seg_k[..., None, :] == seg_shared)
        m = m & same
    return m


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hk, D) -> (B, S, Hk * n_rep, D): query head h reads kv head
    h // n_rep."""
    return x if n_rep == 1 else x.repeat_interleave(n_rep, dim=2)


def _scores(q, k):
    """(B,Sq,H,D),(B,Sk,H,D) -> fp32 (B,H,Sq,Sk)."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())


def attention_dense(q, k, v, *, pos_q, pos_k, window: int = 0,
                    is_sum_q=None, is_sum_k=None, valid_k=None,
                    seg_q=None, seg_k=None, seg_shared: Optional[int] = None,
                    q_nope=None, k_nope=None, alibi=None, v0=None,
                    reset: Optional[ResetConfig] = None,
                    sum_isolated: bool = True, scale: Optional[float] = None,
                    return_lse: bool = False):
    """Reference DTI attention: q (B,Sq,H,Dqk), k (B,Sk,Hk,Dqk), v
    (B,Sk,Hk,Dv) -> (B,Sq,H,Dv).

    ``return_lse`` also returns the fp32 row logsumexp (B,H,Sq) of the
    masked scores, ``+1e30`` on rows with no attendable key — the
    residual contract of the windowed-attention kernel.
    """
    h, dqk = q.shape[2], q.shape[3]
    n_rep = h // k.shape[2]
    if scale is None:
        scale = dqk ** -0.5
    k_r, v_r = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)

    logits = _scores(q, k_r) * scale                       # (B,H,Sq,Sk)
    if is_sum_q is not None and q_nope is not None:
        logits2 = _scores(q_nope, _repeat_kv(k_nope, n_rep)) * scale
        if alibi is not None:
            d = (pos_q[:, None, :, None] - pos_k[:, None, None, :]).float()
            logits2 = logits2 - alibi.float()[None, :, None, None] * d
        logits = torch.where(is_sum_q[:, None, :, None], logits2, logits)
        del logits2

    mask = dti_mask(pos_q, pos_k, window=window,
                    is_sum_k=is_sum_k if sum_isolated else None,
                    valid_k=valid_k, seg_q=seg_q, seg_k=seg_k,
                    seg_shared=seg_shared)                  # (B,Sq,Sk)
    logits.masked_fill_(~mask[:, None], NEG_INF)
    any_ok = mask.any(dim=-1)[:, None, :]                  # (B,1,Sq)
    lse = None
    if return_lse:
        lse = torch.where(any_ok, torch.logsumexp(logits, dim=-1),
                          torch.full((), -NEG_INF, device=logits.device))
    probs = torch.softmax(logits, dim=-1)
    del logits
    # rows with no attendable key (padding) -> zero output (out of place:
    # softmax's backward needs its output)
    probs = probs * any_ok[..., None]

    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v_r.dtype), v_r)
    if reset is not None and v0 is not None and is_sum_q is not None:
        dist = (pos_q[:, :, None] - pos_k[:, None, :]).clamp(min=0)
        a = reset_alpha(dist, reset)[:, None]                # (B,1,Sq,Sk)
        probs_a = probs * a * is_sum_q[:, None, :, None]
        out = out + torch.einsum("bhqk,bkhd->bqhd", probs_a.to(v_r.dtype),
                                 _repeat_kv(v0, n_rep) - v_r)
    return (out, lse) if return_lse else out


def attention(impl: str, *args, **kwargs):
    if impl != "dense" and kwargs.pop("seg_shared", None) is not None:
        # Multi-target serving rows interleave candidate segments whose
        # positions all continue from the context, so physical distance !=
        # positional distance — the banded kernel schedule does not hold.
        raise NotImplementedError(
            "shared-prefix segments (multi-target serving) require the "
            "dense attention path")
    if impl == "dense":
        return attention_dense(*args, **kwargs)
    if impl == "cuda":
        from repro_torch.kernels.windowed_attn import windowed_attention
        return windowed_attention(*args, **kwargs)
    if impl == "blocked":
        raise NotImplementedError(
            "blocked attention is not ported (ROADMAP queue A); use "
            "'dense' or 'cuda'")
    raise ValueError(f"unknown attention impl {impl!r}")


__all__ = ["NEG_INF", "ResetConfig", "reset_alpha", "dti_mask",
           "attention_dense", "attention"]
