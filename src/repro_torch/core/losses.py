"""The DTI CTR readout (counterpart of ``repro.core.losses.ctr_logits``)."""
from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict

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


__all__ = ["ctr_logits"]
