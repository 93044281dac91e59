"""RecSys CTR models: MIND, xDeepFM, DIN, SASRec (counterpart of
``repro.models.recsys``).

All four share sparse embedding tables (gathered with
``repro_torch.sparse.embedding``, plain row gathers, as the reference's
models gather with ``jnp.take``), a feature-interaction op (the family
signature) and a small MLP head producing one logit. Pointwise
sigmoid-BCE training.

DTI applicability: SASRec natively trains all positions in parallel (the
k=m limit of DTI); DIN gets a multi-target train step
(``din_forward_multi``); MIND and xDeepFM are non-sequential.

Params are nested dicts with the reference's leaf shapes (a linear ``w``
is ``(d_in, d_out)``, CIN ``w{i}`` is ``(h, h_prev, m)``, the scalar
``bias`` is ``()``), so ``repro_torch.bridge`` copies them as they are.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import (Params, dense, init_layernorm,
                                       init_linear, init_mlp, layernorm, mlp,
                                       normal_init)
from repro_torch.sparse.embedding import (embedding_lookup, field_lookup,
                                          init_field_tables, init_table)


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str = "recsys"
    kind: str = "din"                     # mind | xdeepfm | din | sasrec
    embed_dim: int = 18
    n_items: int = 1_000_000
    seq_len: int = 100
    # xDeepFM
    field_vocabs: Tuple[int, ...] = ()
    cin_layers: Tuple[int, ...] = (200, 200, 200)
    dnn_dims: Tuple[int, ...] = (400, 400)
    # DIN
    attn_mlp: Tuple[int, ...] = (80, 40)
    head_mlp: Tuple[int, ...] = (200, 80)
    # SASRec
    n_blocks: int = 2
    n_heads: int = 1
    window: int = 0                       # 0 = full causal (DTI option: >0)
    # MIND
    n_interests: int = 4
    capsule_iters: int = 3
    param_dtype: str = "float32"

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)


# ===========================================================================
# xDeepFM (arXiv:1803.05170) — CIN + DNN + linear
# ===========================================================================

def init_xdeepfm(gen: torch.Generator, cfg: RecsysConfig, device) -> Params:
    m, d = len(cfg.field_vocabs), cfg.embed_dim
    kw = dict(dtype=cfg.pdtype, device=device)
    p: Params = {
        "tables": init_field_tables(gen, cfg.field_vocabs, d, **kw),
        "linear": init_field_tables(gen, cfg.field_vocabs, 1, **kw),
        "dnn": init_mlp(gen, [m * d, *cfg.dnn_dims, 1], **kw),
    }
    h_prev = m
    cin = {}
    for i, h in enumerate(cfg.cin_layers):
        cin[f"w{i}"] = normal_init(gen, (h, h_prev, m), (h_prev * m) ** -0.5,
                                   cfg.pdtype, device)
        h_prev = h
    p["cin"] = cin
    p["cin_out"] = init_linear(gen, sum(cfg.cin_layers), 1, bias=True, **kw)
    p["bias"] = torch.zeros((), **kw)
    return p


def xdeepfm_forward(p: Params, cfg: RecsysConfig,
                    ids: torch.Tensor) -> torch.Tensor:
    """ids (B, F) -> logit (B,). CIN = outer-product + per-layer compress."""
    x0 = field_lookup(p["tables"], ids)                       # (B, m, D)
    b, m, d = x0.shape
    lin = field_lookup(p["linear"], ids).sum(dim=(1, 2))      # (B,)
    xk = x0
    pooled = []
    for i in range(len(cfg.cin_layers)):
        z = torch.einsum("bhd,bmd->bhmd", xk, x0)             # (B,Hk,m,D)
        xk = torch.einsum("bhmd,ohm->bod", z, p["cin"][f"w{i}"])
        pooled.append(xk.sum(dim=-1))                         # (B,Hi)
    cin_logit = dense(p["cin_out"], torch.cat(pooled, dim=-1))[:, 0]
    dnn_logit = mlp(p["dnn"], x0.reshape(b, m * d))[:, 0]
    return lin + cin_logit + dnn_logit + p["bias"]


# ===========================================================================
# DIN (arXiv:1706.06978) — target attention over user history
# ===========================================================================

def init_din(gen: torch.Generator, cfg: RecsysConfig, device) -> Params:
    d = cfg.embed_dim
    kw = dict(dtype=cfg.pdtype, device=device)
    return {
        "items": init_table(gen, cfg.n_items, d, **kw),
        "attn": init_mlp(gen, [4 * d, *cfg.attn_mlp, 1], **kw),
        "head": init_mlp(gen, [3 * d, *cfg.head_mlp, 1], **kw),
    }


def din_attend(p: Params, h: torch.Tensor, t: torch.Tensor,
               valid: Optional[torch.Tensor]) -> torch.Tensor:
    """h (B,L,D) history embeds, t (B,K,D) targets -> (B,K,D) pooled."""
    b, l, d = h.shape
    k = t.shape[1]
    hh = h[:, None].expand(b, k, l, d)
    tt = t[:, :, None].expand(b, k, l, d)
    feats = torch.cat([hh, tt, hh - tt, hh * tt], dim=-1)
    w = mlp(p["attn"], feats, act=torch.sigmoid)[..., 0]      # (B,K,L)
    if valid is not None:
        w = torch.where(valid[:, None, :], w, 0.0)
    return torch.einsum("bkl,bld->bkd", w, h)                 # DIN: no softmax


def din_head(p: Params, user: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Pooled user (…, D) and target (…, D) embeds -> logits (…)."""
    return mlp(p["head"], torch.cat([user, t, user * t], dim=-1))[..., 0]


def din_forward(p: Params, cfg: RecsysConfig, hist: torch.Tensor,
                target: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """hist (B, L), target (B,) -> logit (B,)."""
    return din_forward_multi(p, cfg, hist, target[:, None], valid)[:, 0]


def din_forward_multi(p: Params, cfg: RecsysConfig, hist: torch.Tensor,
                      targets: torch.Tensor,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DTI transplant: k targets share one history embedding pass.
    hist (B, L), targets (B, K) -> logits (B, K)."""
    h = embedding_lookup(p["items"], hist)                    # (B,L,D)
    t = embedding_lookup(p["items"], targets)                 # (B,K,D)
    return din_head(p, din_attend(p, h, t, valid), t)


# ===========================================================================
# SASRec (arXiv:1808.09781) — causal self-attention sequence model
# ===========================================================================

def init_sasrec(gen: torch.Generator, cfg: RecsysConfig, device) -> Params:
    d = cfg.embed_dim
    kw = dict(dtype=cfg.pdtype, device=device)
    p: Params = {
        "items": init_table(gen, cfg.n_items, d, **kw),
        "pos": init_table(gen, cfg.seq_len, d, scale=0.02, **kw),
        "ln_f": init_layernorm(d, **kw),
    }
    for i in range(cfg.n_blocks):
        p[f"blk{i}"] = {
            "ln1": init_layernorm(d, **kw),
            "ln2": init_layernorm(d, **kw),
            "q": init_linear(gen, d, d, **kw),
            "k": init_linear(gen, d, d, **kw),
            "v": init_linear(gen, d, d, **kw),
            "ffn": init_mlp(gen, [d, d, d], **kw),
        }
    return p


def sasrec_encode(p: Params, cfg: RecsysConfig, hist: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """hist (B, L) -> hidden (B, L, D). Causal (optionally windowed)
    attention; ``cfg.window > 0`` bounds each query's look-back. A masked
    score is -1e30, so a row whose keys are all masked attends uniformly,
    as the reference's does."""
    b, l = hist.shape
    d = cfg.embed_dim
    h = embedding_lookup(p["items"], hist) + p["pos"][None, :l]
    pos = torch.arange(l, device=hist.device)
    mask = pos[:, None] >= pos[None, :]
    if cfg.window > 0:
        mask = mask & ((pos[:, None] - pos[None, :]) <= cfg.window)
    mask = mask[None]
    if valid is not None:
        mask = mask & valid[:, None, :]
    nh = cfg.n_heads
    hd = d // nh
    for i in range(cfg.n_blocks):
        blk = p[f"blk{i}"]
        x = layernorm(blk["ln1"], h)
        q = dense(blk["q"], x).reshape(b, l, nh, hd)
        k = dense(blk["k"], x).reshape(b, l, nh, hd)
        v = dense(blk["v"], x).reshape(b, l, nh, hd)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / (hd ** 0.5)
        s = torch.where(mask[:, None], s, -1e30)
        a = torch.softmax(s, dim=-1)
        h = h + torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(b, l, d)
        h = h + mlp(blk["ffn"], layernorm(blk["ln2"], h), final_act=False)
    return layernorm(p["ln_f"], h)


def sasrec_forward(p: Params, cfg: RecsysConfig, hist: torch.Tensor,
                   target: torch.Tensor,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pointwise CTR logit: dot(last hidden state, target embedding)."""
    h = sasrec_encode(p, cfg, hist, valid)[:, -1]             # (B,D)
    t = embedding_lookup(p["items"], target)                  # (B,D)
    return (h * t).sum(dim=-1)


def sasrec_forward_all(p: Params, cfg: RecsysConfig, hist: torch.Tensor,
                       targets: torch.Tensor,
                       valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All-position training (native DTI): targets (B, L) aligned next
    items -> logits (B, L)."""
    h = sasrec_encode(p, cfg, hist, valid)                    # (B,L,D)
    t = embedding_lookup(p["items"], targets)
    return (h * t).sum(dim=-1)


# ===========================================================================
# MIND (arXiv:1904.08030) — multi-interest dynamic routing capsules
# ===========================================================================

def init_mind(gen: torch.Generator, cfg: RecsysConfig, device) -> Params:
    d = cfg.embed_dim
    kw = dict(dtype=cfg.pdtype, device=device)
    return {
        "items": init_table(gen, cfg.n_items, d, **kw),
        "s_matrix": normal_init(gen, (d, d), d ** -0.5, cfg.pdtype, device),
        "head": init_mlp(gen, [2 * d, 64, 1], **kw),
    }


def _squash(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    n2 = x.square().sum(dim=dim, keepdim=True)
    return (n2 / (1 + n2)) * x / torch.sqrt(n2 + 1e-9)


def mind_interests(p: Params, cfg: RecsysConfig, hist: torch.Tensor,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B2I dynamic routing: hist (B, L) -> interests (B, K, D). The
    routing softmax runs over the interest axis (1)."""
    h = embedding_lookup(p["items"], hist)                    # (B,L,D)
    u = h @ p["s_matrix"]                                     # shared bilinear
    b, l, d = u.shape
    k = cfg.n_interests
    blogit = torch.zeros((b, k, l), dtype=u.dtype, device=u.device)
    interests = torch.zeros((b, k, d), dtype=u.dtype, device=u.device)
    vmask = None if valid is None else valid[:, None, :]
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(blogit, dim=1)                      # over interests
        if vmask is not None:
            w = torch.where(vmask, w, 0.0)
        interests = _squash(torch.einsum("bkl,bld->bkd", w, u))
        blogit = blogit + torch.einsum("bkd,bld->bkl", interests, u)
    return interests


def mind_forward(p: Params, cfg: RecsysConfig, hist: torch.Tensor,
                 target: torch.Tensor,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Label-aware attention over interests -> MLP head -> logit (B,)."""
    interests = mind_interests(p, cfg, hist, valid)           # (B,K,D)
    t = embedding_lookup(p["items"], target)                  # (B,D)
    score = torch.einsum("bkd,bd->bk", interests, t)
    att = torch.softmax(score * 2.0, dim=-1)                  # pow ~2
    user = torch.einsum("bk,bkd->bd", att, interests)
    return mlp(p["head"], torch.cat([user, t], dim=-1))[..., 0]


def mind_retrieval(p: Params, cfg: RecsysConfig, hist: torch.Tensor,
                   cand_ids: torch.Tensor,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One user against C candidates: hist (1, L), cand_ids (C,) ->
    scores (C,), the max over interests of one (K, D) x (D, C) product."""
    interests = mind_interests(p, cfg, hist, valid)[0]        # (K,D)
    cand = embedding_lookup(p["items"], cand_ids)             # (C,D)
    return (interests @ cand.T).amax(dim=0)


# ---------------------------------------------------------------------------
# dispatch helpers
# ---------------------------------------------------------------------------

INIT = {"mind": init_mind, "xdeepfm": init_xdeepfm, "din": init_din,
        "sasrec": init_sasrec}


def init_recsys(cfg: RecsysConfig, *, seed: int = 0,
                device: DeviceLike = None) -> Params:
    """Random weights from a seeded ``torch.Generator`` on ``device`` (the
    card unless the caller says otherwise)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return INIT[cfg.kind](gen, cfg, device)


def recsys_logits(p: Params, cfg: RecsysConfig,
                  batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    if cfg.kind == "xdeepfm":
        return xdeepfm_forward(p, cfg, batch["ids"])
    fwd = {"din": din_forward, "sasrec": sasrec_forward,
           "mind": mind_forward}.get(cfg.kind)
    if fwd is None:
        raise ValueError(cfg.kind)
    return fwd(p, cfg, batch["hist"], batch["target"], batch.get("valid"))


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    z = logits.float()
    y = labels.float()
    return torch.mean(torch.clamp(z, min=0) - z * y
                      + torch.log1p(torch.exp(-z.abs())))


__all__ = ["RecsysConfig", "init_recsys", "recsys_logits", "bce_loss",
           "xdeepfm_forward", "din_attend", "din_head", "din_forward",
           "din_forward_multi", "sasrec_forward", "sasrec_forward_all",
           "sasrec_encode", "mind_forward", "mind_interests",
           "mind_retrieval"]
