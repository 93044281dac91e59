"""Symmetric int8 quantization (counterpart of ``repro.core.quant``): the
one contract the int8 KV cache and the decode kernel's int8 mode share.

Scheme: per-group symmetric absmax. For a group ``x`` (one reduction axis):

    scale = max(|x|) / 127
    q     = clip(round(x / scale), -127, 127)   int8
    x'    = q * scale                           fp32

* **error bound** — ``|x - x'| <= scale / 2`` per element; zero groups
  quantize to exact zeros.
* **scale locality** — dequantization needs only the group's own (q,
  scale), so a KV page carries its own scales and moves between rows
  without requantization.
* **linearity** — RoPE (a per-(token, head) rotation) commutes with the
  per-(token, head) scale: ``rope(q * scale) == rope(q) * scale``, which
  lets the decode kernel rope raw int8 keys and scale afterwards.

``torch.round`` rounds half to even, as ``jnp.round`` does, so codes and
scales are bit-identical to the reference's on the same fp32 inputs.
"""
from __future__ import annotations

from typing import Tuple

import torch

#: Largest representable magnitude of the symmetric int8 grid.
Q8_MAX = 127.0


def quantize_q8(x: torch.Tensor, axis: int = -1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``x`` to (int8 codes, fp32 scales) with one scale per
    group along ``axis`` (the reduced axis disappears from ``scale``)."""
    xf = x.float()
    scale = xf.abs().amax(dim=axis) / Q8_MAX
    safe = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    q = torch.round(xf / safe.unsqueeze(axis))
    q = q.clamp(-Q8_MAX, Q8_MAX).to(torch.int8)
    return q, scale


def dequantize_q8(q: torch.Tensor, scale: torch.Tensor,
                  axis: int = -1) -> torch.Tensor:
    """Reconstruct fp32 values: ``q * scale`` broadcast along ``axis``."""
    return q.float() * scale.float().unsqueeze(axis)


__all__ = ["Q8_MAX", "quantize_q8", "dequantize_q8"]
