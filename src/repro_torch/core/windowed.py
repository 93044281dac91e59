"""Windowed causal attention with the DTI extensions (counterpart of
``repro.core.windowed``).

Three execution paths with the same semantics:

* ``attention_dense`` — materialises the (Sq, Sk) score matrix. The oracle,
  and the plain version behind the windowed-attention kernel.
* ``attention_blocked`` — block-local: query block i attends key blocks
  i - 1 and i of the window's size, O(S * 2W) instead of O(S^2). Plain
  PyTorch, as the reference computes it outside any Pallas kernel; the
  configs that set ``attn_impl="blocked"`` run on it.
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


def _to_blocks(x: torch.Tensor, blk: int) -> torch.Tensor:
    """(B, S, ...) -> (B, nb, blk, ...). S must be divisible by blk."""
    return x.reshape(x.shape[0], x.shape[1] // blk, blk, *x.shape[2:])


def _with_prev(xb: torch.Tensor) -> torch.Tensor:
    """(B, nb, blk, ...) -> (B, nb, 2 blk, ...): (previous block, own
    block); block 0's previous block is zeros."""
    prev = torch.cat([torch.zeros_like(xb[:, :1]), xb[:, :-1]], dim=1)
    return torch.cat([prev, xb], dim=2)


def attention_blocked(q, k, v, *, pos_q, pos_k, window: int, is_sum_q=None,
                      is_sum_k=None, valid_k=None, seg_q=None, seg_k=None,
                      q_nope=None, k_nope=None, alibi=None, v0=None,
                      reset: Optional[ResetConfig] = None,
                      sum_isolated: bool = True,
                      scale: Optional[float] = None, q_chunk: int = 4):
    """Block-local windowed attention; semantics == ``attention_dense``.

    Requires Sq == Sk == S, window > 0 and S % window == 0. Query block i
    attends key blocks {i - 1, i}; the (pos_q - pos_k <= window) mask
    inside the pair keeps the semantics exact. Packed rows keep the
    invariant: segments are contiguous with positions restarting, and the
    seg_q == seg_k term kills cross-segment aliases inside the pair.

    With more than ``q_chunk`` blocks (and a multiple of it), chunks of
    ``q_chunk`` query blocks are computed in turn, so the live fp32 logits
    stay O(q_chunk * H * W * 2W), as the reference's ``lax.map`` keeps
    them."""
    if window <= 0:
        raise ValueError("the blocked path needs a window")
    b, s, h, dqk = q.shape
    n_rep = h // k.shape[2]
    if scale is None:
        scale = dqk ** -0.5
    blk = window
    if s % blk:
        raise ValueError(f"seq {s} not divisible by window {blk}")
    nb = s // blk
    pad_valid = _with_prev(_to_blocks(
        torch.ones_like(pos_k, dtype=torch.bool) if valid_k is None
        else valid_k, blk)).clone()
    pad_valid[:, 0, :blk] = False          # block 0 has no previous block
    use_nope = is_sum_q is not None and q_nope is not None
    use_reset = reset is not None and v0 is not None and is_sum_q is not None
    xs = {"qb": _to_blocks(q, blk),
          "kb": _with_prev(_to_blocks(_repeat_kv(k, n_rep), blk)),
          "vb": _with_prev(_to_blocks(_repeat_kv(v, n_rep), blk)),
          "pq": _to_blocks(pos_q, blk), "pk": _with_prev(_to_blocks(pos_k, blk)),
          "pad_valid": pad_valid}
    if use_nope:
        xs["qnb"] = _to_blocks(q_nope, blk)
        xs["knb"] = _with_prev(_to_blocks(_repeat_kv(k_nope, n_rep), blk))
    if is_sum_q is not None:
        xs["sq_b"] = _to_blocks(is_sum_q, blk)
    if sum_isolated and is_sum_k is not None:
        xs["sk_b"] = _with_prev(_to_blocks(is_sum_k, blk))
    if seg_q is not None and seg_k is not None:
        xs["sgq_b"] = _to_blocks(seg_q, blk)
        xs["sgk_b"] = _with_prev(_to_blocks(seg_k, blk))
    if use_reset:
        xs["v0b"] = _with_prev(_to_blocks(_repeat_kv(v0, n_rep), blk))

    def compute(c):
        logits = torch.einsum("bnqhd,bnkhd->bnhqk", c["qb"].float(),
                              c["kb"].float()) * scale
        d = c["pq"][:, :, :, None] - c["pk"][:, :, None, :]
        if use_nope:
            logits2 = torch.einsum("bnqhd,bnkhd->bnhqk", c["qnb"].float(),
                                   c["knb"].float()) * scale
            if alibi is not None:
                logits2 = logits2 - (alibi.float()[None, None, :, None, None]
                                     * d[:, :, None].float())
            logits = torch.where(c["sq_b"][:, :, None, :, None], logits2,
                                 logits)
        mask = (d >= 0) & (d <= window) & c["pad_valid"][:, :, None, :]
        if "sk_b" in c:
            mask = mask & (~c["sk_b"][:, :, None, :] | (d == 0))
        if "sgq_b" in c:
            mask = mask & (c["sgq_b"][:, :, :, None]
                           == c["sgk_b"][:, :, None, :])
        logits = logits.masked_fill(~mask[:, :, None], NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        probs = probs * mask.any(dim=-1)[:, :, None, :, None]
        out = torch.einsum("bnhqk,bnkhd->bnqhd", probs.to(c["vb"].dtype),
                           c["vb"])
        if use_reset:
            a = reset_alpha(d.clamp(min=0), reset)[:, :, None]
            probs_a = probs * a * c["sq_b"][:, :, None, :, None]
            out = out + torch.einsum("bnhqk,bnkhd->bnqhd",
                                     probs_a.to(c["vb"].dtype),
                                     c["v0b"] - c["vb"])
        return out

    if q_chunk and nb > q_chunk and nb % q_chunk == 0:
        out = torch.cat([compute({n: t[:, i:i + q_chunk]
                                  for n, t in xs.items()})
                         for i in range(0, nb, q_chunk)], dim=1)
    else:
        out = compute(xs)
    return out.reshape(b, s, h, v.shape[-1])


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
        return attention_blocked(*args, **kwargs)
    raise ValueError(f"unknown attention impl {impl!r}")


__all__ = ["NEG_INF", "ResetConfig", "reset_alpha", "dti_mask",
           "attention_dense", "attention_blocked", "attention"]
