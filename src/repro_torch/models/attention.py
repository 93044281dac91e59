"""Attention modules, GQA and MLA (counterparts of
``repro.models.attention``).

Each owns its projection layout and RoPE, and delegates the score/value
math to ``repro_torch.core.windowed.attention`` so every DTI semantic
lives in one place. The reference's decode ``cache=`` path is
``repro_torch.serve.engine``'s decode step here (for MLA, in absorbed
form against the latent cache).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.core.windowed import ResetConfig, attention
from repro_torch.models.layers import (Params, alibi_slopes, apply_rope,
                                       dense, init_linear, init_rmsnorm,
                                       rmsnorm)


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


def _dti_kwargs(dti: Optional[DTIAttnOpts], q_nope, k_nope, n_heads: int,
                device, v0) -> Dict[str, Any]:
    """The attention operands of the DTI context: [SUM] flags, the NoPE
    stream with ALiBi, the reset's v0 (``v0()`` computes it on demand),
    packed segments."""
    kw: Dict[str, Any] = {}
    if dti is not None and dti.is_sum is not None:
        kw["is_sum_q"] = dti.is_sum
        kw["is_sum_k"] = dti.is_sum
        kw["sum_isolated"] = dti.sum_isolated
        if dti.sum_alibi:
            kw["q_nope"], kw["k_nope"] = q_nope, k_nope
            kw["alibi"] = alibi_slopes(n_heads, device)
        if dti.reset is not None and dti.h0 is not None:
            kw["v0"] = v0()
            kw["reset"] = dti.reset
    if dti is not None and dti.segment_ids is not None:
        kw["seg_q"] = kw["seg_k"] = dti.segment_ids
    return kw


def _attend(impl: str, q, k, v, positions, window: int, valid, q_chunk: int,
            kw: Dict[str, Any]) -> torch.Tensor:
    if impl == "blocked":
        kw = dict(kw, q_chunk=q_chunk)
    return attention(impl, q, k, v, pos_q=positions, pos_k=positions,
                     window=window, valid_k=valid, **kw)


def gqa_attention(p: Params, x: torch.Tensor, *, n_heads: int,
                  n_kv_heads: int, head_dim: int, positions: torch.Tensor,
                  window: int, rope_theta: float, impl: str,
                  q_chunk: int = 4, dti: Optional[DTIAttnOpts] = None,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d)."""
    b, s, _ = x.shape
    q = dense(p["q"], x).reshape(b, s, n_heads, head_dim)
    k = dense(p["k"], x).reshape(b, s, n_kv_heads, head_dim)
    v = dense(p["v"], x).reshape(b, s, n_kv_heads, head_dim)
    q_rot = apply_rope(q, positions, rope_theta)
    k_rot = apply_rope(k, positions, rope_theta)
    kw = _dti_kwargs(dti, q, k, n_heads, x.device,
                     lambda: dense(p["v"], dti.h0).reshape(b, s, n_kv_heads,
                                                           head_dim))
    out = _attend(impl, q_rot, k_rot, v, positions, window, valid, q_chunk,
                  kw)
    return dense(p["o"], out.reshape(b, s, n_heads * head_dim))


# ---------------------------------------------------------------------------
# MLA (Multi-head Latent Attention, arXiv:2405.04434)
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, d_model: int, n_heads: int, *,
             q_lora_rank: int, kv_lora_rank: int, qk_nope_dim: int,
             qk_rope_dim: int, v_head_dim: int, dtype=torch.float32,
             device="cpu", lora_rank: int = 0) -> Params:
    """The reference's MLA layout: a latent ``kv_down`` (d -> r_kv) with
    its norm and ``kv_up`` (r_kv -> H (nope + v)), one shared roped key
    head ``k_rope`` (d -> rope), ``o``; queries through ``q_down``,
    ``q_norm``, ``q_up`` when ``q_lora_rank > 0``, else one ``q``. LoRA
    adapters on ``kv_up``, ``o`` and the query's up projection, as there."""
    kw = dict(dtype=dtype, device=device)
    lo = dict(kw, lora_rank=lora_rank)
    qk_head = qk_nope_dim + qk_rope_dim
    p: Params = {
        "kv_down": init_linear(gen, d_model, kv_lora_rank, **kw),
        "kv_norm": init_rmsnorm(kv_lora_rank, dtype, device),
        "kv_up": init_linear(gen, kv_lora_rank,
                             n_heads * (qk_nope_dim + v_head_dim), **lo),
        "k_rope": init_linear(gen, d_model, qk_rope_dim, **kw),
        "o": init_linear(gen, n_heads * v_head_dim, d_model, **lo),
    }
    if q_lora_rank > 0:
        p["q_down"] = init_linear(gen, d_model, q_lora_rank, **kw)
        p["q_norm"] = init_rmsnorm(q_lora_rank, dtype, device)
        p["q_up"] = init_linear(gen, q_lora_rank, n_heads * qk_head, **lo)
    else:
        p["q"] = init_linear(gen, d_model, n_heads * qk_head, **lo)
    return p


def mla_query(p: Params, x: torch.Tensor, n_heads: int,
              qk_head: int) -> torch.Tensor:
    """x (B, S, d) -> the heads' queries (B, S, H, nope + rope), unroped."""
    b, s, _ = x.shape
    if "q_down" in p:
        q = dense(p["q_up"], rmsnorm(p["q_norm"], dense(p["q_down"], x)))
    else:
        q = dense(p["q"], x)
    return q.reshape(b, s, n_heads, qk_head)


def _mla_qkv(p: Params, x: torch.Tensor, *, n_heads: int, qk_nope_dim: int,
             qk_rope_dim: int, v_head_dim: int, positions: torch.Tensor,
             rope_theta: float):
    """Project x -> (q, k, v, q_nope_full, k_nope_full, c_kv): q and k
    roped on their rope slice, the NoPE variants (for [SUM] rows)
    unrotated there, the shared rope head broadcast over the heads."""
    b, s, _ = x.shape
    q = mla_query(p, x, n_heads, qk_nope_dim + qk_rope_dim)
    q_nope, q_pe = q[..., :qk_nope_dim], q[..., qk_nope_dim:]
    q_pe_rot = apply_rope(q_pe, positions, rope_theta)

    c_kv = rmsnorm(p["kv_norm"], dense(p["kv_down"], x))       # (B,S,r_kv)
    kv = dense(p["kv_up"], c_kv).reshape(b, s, n_heads,
                                         qk_nope_dim + v_head_dim)
    # v contiguous: the windowed kernel takes contiguous operands
    k_nope, v = kv[..., :qk_nope_dim], kv[..., qk_nope_dim:].contiguous()
    k_pe = dense(p["k_rope"], x).reshape(b, s, 1, qk_rope_dim)
    k_pe_rot = apply_rope(k_pe, positions, rope_theta)
    shape = (b, s, n_heads, qk_rope_dim)
    q_full = torch.cat([q_nope, q_pe_rot], dim=-1)
    k_full = torch.cat([k_nope, k_pe_rot.expand(shape)], dim=-1)
    q_nope_full = torch.cat([q_nope, q_pe], dim=-1)
    k_nope_full = torch.cat([k_nope, k_pe.expand(shape)], dim=-1)
    return q_full, k_full, v, q_nope_full, k_nope_full, c_kv


def mla_attention(p: Params, x: torch.Tensor, *, n_heads: int,
                  qk_nope_dim: int, qk_rope_dim: int, v_head_dim: int,
                  positions: torch.Tensor, window: int, rope_theta: float,
                  impl: str, q_chunk: int = 4,
                  dti: Optional[DTIAttnOpts] = None,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d): MHA over the expanded heads (Dqk = nope
    + rope, Dv = v_head_dim), scaled by Dqk ** -0.5."""
    b, s, _ = x.shape
    dims = dict(n_heads=n_heads, qk_nope_dim=qk_nope_dim,
                qk_rope_dim=qk_rope_dim, v_head_dim=v_head_dim,
                positions=positions, rope_theta=rope_theta)
    q, k, v, q_np, k_np, _ = _mla_qkv(p, x, **dims)
    kw = _dti_kwargs(dti, q_np, k_np, n_heads, x.device,
                     lambda: _mla_qkv(p, dti.h0, **dims)[2])
    kw["scale"] = (qk_nope_dim + qk_rope_dim) ** -0.5
    out = _attend(impl, q, k, v, positions, window, valid, q_chunk, kw)
    return dense(p["o"], out.reshape(b, s, n_heads * v_head_dim))


__all__ = ["DTIAttnOpts", "init_gqa", "gqa_attention", "init_mla",
           "mla_query", "mla_attention"]
