"""The DTI CTR readout and objective (counterpart of
``repro.core.losses``; the chunked ``lm_loss`` is not on the DTI path and
waits)."""
from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, Tuple

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


__all__ = ["ctr_logits", "ctr_loss"]
