"""Decoder-only transformer over a param dict (counterpart of
``repro.models.transformer``).

The reference's ``lax.scan`` over stacked layers is a Python loop over
``params["layers"]`` here: PyTorch runs eagerly, so there is no HLO size to
keep O(1) in depth. Remat wraps each layer in
``torch.utils.checkpoint`` instead of ``jax.checkpoint`` around the scan
body. One model covers the LM archs the port has: GQA (dti-llama, the
model the paper trains and serves; minicpm-2b, qwen2-1.5b), MLA
(minicpm3-4b) and MoE FFN layers (qwen2-moe-a2.7b), whose leading
``first_dense_layers`` keep a dense SwiGLU (the reference's ``prefix``
group).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.windowed import ResetConfig, shared_prefix_plan
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.attention import (DTIAttnOpts, gqa_attention,
                                          init_gqa, init_mla, mla_attention)
from repro_torch.models.layers import (Params, init_linear, init_rmsnorm,
                                       init_swiglu, normal_init, rmsnorm,
                                       swiglu)
from repro_torch.models.moe import init_moe, moe_ffn


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 32000
    head_dim: Optional[int] = None
    attn_type: str = "gqa"              # "gqa" | "mla"
    qkv_bias: bool = False
    # MLA
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # MoE
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    shared_d_ff: Optional[int] = None
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    norm_topk: bool = True
    # positional / attention
    rope_theta: float = 10000.0
    window: int = 0                     # 0 = full causal
    attn_impl: str = "dense"            # "dense" | "blocked" | "cuda"
    attn_q_chunk: int = 4               # q-block chunking (blocked impl)
    # DTI
    dti_sum_token: bool = False
    dti_sum_alibi: bool = True
    dti_sum_isolated: bool = True
    dti_reset: bool = True
    reset_y_min: float = 0.0
    reset_y_max: float = 0.3
    # weights
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    lora_rank: int = 0
    logits_chunk: int = 0               # 0 = unchunked LM loss
    remat: bool = True
    remat_policy: str = "nothing"       # "nothing" | "none" ("dots": later)
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def layer_kind(self, i: int) -> str:
        if self.moe and i >= self.first_dense_layers:
            return "moe"
        return "dense"

    def reset_config(self, window_tokens: int) -> Optional[ResetConfig]:
        if not self.dti_reset:
            return None
        return ResetConfig(self.reset_y_min, self.reset_y_max,
                           midpoint=window_tokens / 2.0)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for model features that later slices of the port bring."""
    if cfg.attn_type not in ("gqa", "mla"):
        raise ValueError(f"unknown attn_type {cfg.attn_type!r}")
    if cfg.remat_policy == "dots":
        raise NotImplementedError(
            "remat_policy='dots' (save the weight matmuls, recompute only "
            "attention) is not ported yet; it waits for the PR that tunes "
            "the training step (ROADMAP queue A10)")
    if cfg.remat_policy not in ("nothing", "none"):
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")


def _init_layer(gen: torch.Generator, cfg: ModelConfig, device,
                kind: str) -> Params:
    kw = dict(dtype=cfg.pdtype, device=device, lora_rank=cfg.lora_rank)
    if cfg.attn_type == "mla":
        attn = init_mla(gen, cfg.d_model, cfg.n_heads,
                        q_lora_rank=cfg.q_lora_rank,
                        kv_lora_rank=cfg.kv_lora_rank,
                        qk_nope_dim=cfg.qk_nope_dim,
                        qk_rope_dim=cfg.qk_rope_dim,
                        v_head_dim=cfg.v_head_dim, **kw)
    else:
        attn = init_gqa(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.hd, qkv_bias=cfg.qkv_bias, **kw)
    if kind == "moe":
        mlp = init_moe(gen, cfg.d_model, n_experts=cfg.n_experts,
                       moe_d_ff=cfg.moe_d_ff, top_k=cfg.top_k,
                       n_shared=cfg.n_shared_experts,
                       shared_d_ff=cfg.shared_d_ff, **kw)
    else:
        mlp = init_swiglu(gen, cfg.d_model, cfg.d_ff, **kw)
    return {"attn": attn, "ffn": mlp,
            "ln_attn": init_rmsnorm(cfg.d_model, cfg.pdtype, device),
            "ln_ffn": init_rmsnorm(cfg.d_model, cfg.pdtype, device)}


@torch.no_grad()
def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: DeviceLike = None) -> Params:
    """Random weights from a seeded ``torch.Generator`` on ``device``.

    Layout: ``embed (V, d)``, ``ln_f``, ``lm_head.w (d, V)`` and
    ``layers``, a list of per-layer dicts (the reference stacks them on a
    leading axis, MoE models' dense ``first_dense_layers`` in a ``prefix``
    group of their own; ``repro_torch.bridge`` converts between the two).
    """
    check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    p: Params = {"embed": normal_init(gen, (cfg.vocab_size, cfg.d_model),
                                      0.02, cfg.pdtype, device),
                 "ln_f": init_rmsnorm(cfg.d_model, cfg.pdtype, device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab_size,
                                   scale=0.02, dtype=cfg.pdtype,
                                   device=device)
    p["layers"] = [_init_layer(gen, cfg, device, cfg.layer_kind(i))
                   for i in range(cfg.n_layers)]
    return p


def ffn(lp: Params, x: torch.Tensor, cfg: ModelConfig, kind: str):
    """The layer's FFN on its normed input: ``(out, aux_loss)``, the MoE
    balance loss (an fp32 scalar), or None for a dense SwiGLU."""
    if kind == "moe":
        return moe_ffn(lp["ffn"], x, n_experts=cfg.n_experts,
                       top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                       norm_topk=cfg.norm_topk)
    return swiglu(lp["ffn"], x), None


def _layer_fwd(lp: Params, h: torch.Tensor, cfg: ModelConfig, kind: str, *,
               positions, window: int, dti: Optional[DTIAttnOpts], valid):
    x = rmsnorm(lp["ln_attn"], h, cfg.norm_eps)
    kw = dict(positions=positions, window=window, rope_theta=cfg.rope_theta,
              impl=cfg.attn_impl, q_chunk=cfg.attn_q_chunk, dti=dti,
              valid=valid)
    if cfg.attn_type == "mla":
        h = h + mla_attention(lp["attn"], x, n_heads=cfg.n_heads,
                              qk_nope_dim=cfg.qk_nope_dim,
                              qk_rope_dim=cfg.qk_rope_dim,
                              v_head_dim=cfg.v_head_dim, **kw)
    else:
        h = h + gqa_attention(lp["attn"], x, n_heads=cfg.n_heads,
                              n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                              **kw)
    f, aux = ffn(lp, rmsnorm(lp["ln_ffn"], h, cfg.norm_eps), cfg, kind)
    return h + f, aux


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            is_sum: Optional[torch.Tensor] = None,
            valid: Optional[torch.Tensor] = None,
            segment_ids: Optional[torch.Tensor] = None,
            seg_shared: Optional[int] = None,
            dti_enabled: bool = False,
            window: Optional[int] = None) -> Dict[str, Any]:
    """Run the decoder; returns ``{"hidden": (B, S, d)}`` after the final
    norm and ``"aux_loss"``, the fp32 sum of the MoE layers' balance
    losses (zero for a dense model). Logits are not materialised here (see
    ``lm_logits`` and ``repro_torch.core.losses.ctr_logits``).

    ``segment_ids`` (packed rows, -1 on padding) isolate segments in every
    attention layer. ``seg_shared`` marks one segment id (the user context
    of a multi-target serving row) as a shared prefix every other segment
    may attend; candidate segments keep positions continuing after the
    context. Dense attention path only: the other paths raise.

    With ``cfg.remat`` and policy ``"nothing"``, and while autograd
    records, each layer runs under ``torch.utils.checkpoint``: only its
    input is kept, and the backward recomputes the layer (so the attention
    forward runs twice per layer and step)."""
    check_supported(cfg)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
    win = cfg.window if window is None else window
    # F.embedding, not indexing: its backward sums repeated tokens in a
    # fixed order (indexing's index_put is nondeterministic on the CPU)
    h = F.embedding(tokens, params["embed"]).to(cfg.cdtype)

    plan = None      # the shared-prefix form's plan, once per call
    if (seg_shared is not None and segment_ids is not None
            and cfg.attn_impl == "dense"):
        plan = shared_prefix_plan(segment_ids, valid, seg_shared)
    dti: Optional[DTIAttnOpts] = None
    if ((dti_enabled and is_sum is not None) or segment_ids is not None
            or seg_shared is not None):
        use_sum = dti_enabled and is_sum is not None
        dti = DTIAttnOpts(is_sum=is_sum if use_sum else None, h0=h,
                          reset=(cfg.reset_config(win)
                                 if use_sum and cfg.dti_reset else None),
                          sum_alibi=cfg.dti_sum_alibi,
                          sum_isolated=cfg.dti_sum_isolated,
                          segment_ids=segment_ids, seg_shared=seg_shared,
                          shared_plan=plan)
    remat = (cfg.remat and cfg.remat_policy == "nothing"
             and torch.is_grad_enabled())
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i, lp in enumerate(params["layers"]):
        kw = dict(positions=positions, window=win, dti=dti, valid=valid)
        kind = cfg.layer_kind(i)
        if remat:
            h, aux = checkpoint(_layer_fwd, lp, h, cfg, kind,
                                use_reentrant=False,
                                preserve_rng_state=False, **kw)
        else:
            h, aux = _layer_fwd(lp, h, cfg, kind, **kw)
        if aux is not None:
            aux_total = aux_total + aux
    return {"hidden": rmsnorm(params["ln_f"], h, cfg.norm_eps),
            "aux_loss": aux_total}


def named_leaves(params: Params, prefix=()) -> Iterator:
    """``(path, tensor)`` for every leaf, in a fixed order; a path is a
    tuple of dict keys and layer indices, e.g. ``("layers", 0, "attn",
    "q", "lora_a")``."""
    items = (params.items() if isinstance(params, dict)
             else enumerate(params))
    for k, v in items:
        if isinstance(v, (dict, list)):
            yield from named_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def map_leaves(fn, tree, *rest, path=()):
    """``fn(path, leaf, *rest_leaves)`` over a params-shaped tree of dicts
    and lists (``rest`` are trees of the same structure); paths as in
    ``named_leaves``."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_leaves(fn, v, *(r[i] for r in rest), path=path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree, *rest)


@contextlib.contextmanager
def differentiable(params: Params) -> Iterator[List[torch.Tensor]]:
    """Turn gradient tracking on for every floating leaf of ``params`` (the
    leaves ``init_params`` made without it) for the body, and off again,
    with their ``.grad`` cleared, on the way out. Yields the leaves."""
    leaves = [t for _, t in named_leaves(params) if t.is_floating_point()]
    for t in leaves:
        t.requires_grad_(True)
    try:
        yield leaves
    finally:
        for t in leaves:
            t.grad = None
            t.requires_grad_(False)


def count_params(params: Params) -> int:
    """Elements over every leaf (LoRA scalars included), as the
    reference counts them."""
    return sum(t.numel() for _, t in named_leaves(params))


def lm_logits(params: Params, cfg: ModelConfig, hidden: torch.Tensor,
              rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """hidden @ vocab. ``rows`` selects a subset of vocab rows (e.g. yes/no)."""
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]["w"].T
    if rows is not None:
        w = w[rows]
    return torch.einsum("...d,vd->...v", hidden, w.to(hidden.dtype))


__all__ = ["ModelConfig", "check_supported", "init_params", "forward",
           "ffn", "named_leaves", "map_leaves", "differentiable",
           "lm_logits", "count_params"]
