"""GQA attention module (counterpart of ``repro.models.attention``).

Owns the projection layout and RoPE, and delegates the score/value math to
``repro_torch.core.windowed.attention`` so every DTI semantic lives in one
place. MLA and the decode ``cache=`` path of the reference are not on the
serving path of this slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.core.windowed import ResetConfig, attention
from repro_torch.models.layers import (Params, alibi_slopes, apply_rope,
                                       dense, init_linear)


@dataclasses.dataclass(frozen=True)
class DTIAttnOpts:
    """Per-call DTI context threaded through the transformer."""
    is_sum: Optional[torch.Tensor] = None     # (B, S) bool
    h0: Optional[torch.Tensor] = None         # (B, S, d) initial hidden states
    reset: Optional[ResetConfig] = None
    sum_alibi: bool = True                    # NoPE + ALiBi on SUM rows
    sum_isolated: bool = True
    segment_ids: Optional[torch.Tensor] = None  # (B, S) int32 packed segments


def init_gqa(gen: torch.Generator, d_model: int, n_heads: int,
             n_kv_heads: int, head_dim: int, *, qkv_bias: bool = False,
             dtype=torch.float32, device="cpu", lora_rank: int = 0) -> Params:
    kw = dict(dtype=dtype, device=device, lora_rank=lora_rank)
    return {
        "q": init_linear(gen, d_model, n_heads * head_dim, bias=qkv_bias, **kw),
        "k": init_linear(gen, d_model, n_kv_heads * head_dim, bias=qkv_bias,
                         **kw),
        "v": init_linear(gen, d_model, n_kv_heads * head_dim, bias=qkv_bias,
                         **kw),
        "o": init_linear(gen, n_heads * head_dim, d_model, **kw),
    }


def gqa_attention(p: Params, x: torch.Tensor, *, n_heads: int,
                  n_kv_heads: int, head_dim: int, positions: torch.Tensor,
                  window: int, rope_theta: float, impl: str,
                  dti: Optional[DTIAttnOpts] = None,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d)."""
    b, s, _ = x.shape
    q = dense(p["q"], x).reshape(b, s, n_heads, head_dim)
    k = dense(p["k"], x).reshape(b, s, n_kv_heads, head_dim)
    v = dense(p["v"], x).reshape(b, s, n_kv_heads, head_dim)
    q_rot = apply_rope(q, positions, rope_theta)
    k_rot = apply_rope(k, positions, rope_theta)

    kw: Dict[str, Any] = {}
    if dti is not None and dti.is_sum is not None:
        kw["is_sum_q"] = dti.is_sum
        kw["is_sum_k"] = dti.is_sum
        kw["sum_isolated"] = dti.sum_isolated
        if dti.sum_alibi:
            kw["q_nope"], kw["k_nope"] = q, k
            kw["alibi"] = alibi_slopes(n_heads, x.device)
        if dti.reset is not None and dti.h0 is not None:
            kw["v0"] = dense(p["v"], dti.h0).reshape(b, s, n_kv_heads,
                                                     head_dim)
            kw["reset"] = dti.reset
    if dti is not None and dti.segment_ids is not None:
        kw["seg_q"] = kw["seg_k"] = dti.segment_ids

    out = attention(impl, q_rot, k_rot, v, pos_q=positions, pos_k=positions,
                    window=window, valid_k=valid, **kw)
    return dense(p["o"], out.reshape(b, s, n_heads * head_dim))


__all__ = ["DTIAttnOpts", "init_gqa", "gqa_attention"]
