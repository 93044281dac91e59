"""Losses: the DTI CTR readout and objective (yes/no at [SUM] rows) and
the next-token LM loss, chunked over the vocabulary (counterpart of
``repro.core.losses``)."""
from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, Optional, Tuple

import torch

if TYPE_CHECKING:  # avoid a core <-> models import cycle
    from repro_torch.models.transformer import ModelConfig


def ctr_logits(params: Dict[str, Any], cfg: "ModelConfig",
               hidden: torch.Tensor, yes_id: int, no_id: int) -> torch.Tensor:
    """Bi-dimensional (yes, no) logits at every position: (B, S, 2).

    Touches only two rows of the vocab matrix, never (B, S, V) logits.
    """
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]["w"].T
    rows = torch.stack([w[yes_id], w[no_id]]).to(hidden.dtype)   # (2, d)
    return torch.einsum("bsd,vd->bsv", hidden, rows)


def ctr_loss(params: Dict[str, Any], cfg: "ModelConfig",
             hidden: torch.Tensor, sum_mask: torch.Tensor,
             labels: torch.Tensor, *, yes_id: int,
             no_id: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """DTI objective: cross-entropy of yes/no at each [SUM] position.

    sum_mask (B, S) bool marks the [SUM] positions carrying a label; labels
    (B, S) are 1 = 'yes' (click). Returns (mean loss, {"p_click", "mask"}),
    p_click being p(yes) at every position.
    """
    logits2 = ctr_logits(params, cfg, hidden, yes_id, no_id).float()
    logp = torch.log_softmax(logits2, dim=-1)                 # (B,S,2)
    nll = -torch.where(labels.to(torch.int32) == 1, logp[..., 0],
                       logp[..., 1])
    w = sum_mask.float()
    loss = torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)
    return loss, {"p_click": torch.exp(logp[..., 0]), "mask": sum_mask}


def lm_loss(params: Dict[str, Any], cfg: "ModelConfig",
            hidden: torch.Tensor, targets: torch.Tensor,
            valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross entropy, the mean over ``valid`` positions (all
    when None). With ``cfg.logits_chunk > 0`` dividing the vocabulary, an
    online logsumexp runs over vocabulary chunks, so (B, S, V) fp32
    logits never exist whole; otherwise one pass."""
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]["w"].T
    v, d = w.shape
    h = hidden.float()
    wmask = (torch.ones(targets.shape, dtype=torch.float32,
                        device=hidden.device)
             if valid is None else valid.float())
    tgt_ids = targets.long()

    def mean(nll):
        return torch.sum(nll * wmask) / torch.clamp(torch.sum(wmask), min=1.0)

    if cfg.logits_chunk <= 0 or v % cfg.logits_chunk != 0:
        logits = torch.einsum("bsd,vd->bsv", h, w.float())
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, tgt_ids[..., None])[..., 0]
        return mean(lse - tgt)

    c = cfg.logits_chunk
    m = torch.full(targets.shape, float("-inf"), device=hidden.device)
    s = torch.zeros(targets.shape, device=hidden.device)
    tgt = torch.zeros(targets.shape, device=hidden.device)
    for base in range(0, v, c):
        logits = torch.einsum("bsd,cd->bsc", h, w[base:base + c].float())
        m_new = torch.maximum(m, logits.amax(dim=-1))
        s = s * torch.exp(m - m_new) + torch.sum(
            torch.exp(logits - m_new[..., None]), dim=-1)
        in_chunk = (tgt_ids >= base) & (tgt_ids < base + c)
        local = (tgt_ids - base).clamp(0, c - 1)
        t_val = torch.gather(logits, -1, local[..., None])[..., 0]
        tgt = torch.where(in_chunk, t_val, tgt)
        m = m_new
    return mean(m + torch.log(s) - tgt)


__all__ = ["ctr_logits", "ctr_loss", "lm_loss"]
