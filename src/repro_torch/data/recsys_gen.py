"""Synthetic recsys batches with latent-factor labels (learnable signal);
a numpy copy of ``repro.data.recsys_gen`` (``repro/data/__init__.py``
imports JAX). The same seed gives byte-identical batches."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


class RecsysGenerator:
    """Latent-factor CTR world: label = Bernoulli(sigmoid(z_t . mean(z_hist)))."""

    def __init__(self, n_items: int, latent_dim: int = 8, *, seed: int = 0,
                 scale: float = 4.0):
        rng = np.random.default_rng(seed)
        # only materialise latents for a small active slice of the huge vocab
        self.active = min(n_items, 50_000)
        self.z = rng.normal(size=(self.active, latent_dim)) / np.sqrt(latent_dim)
        self.n_items = n_items
        self.scale = scale

    def seq_batch(self, batch: int, seq_len: int, *, rng: np.random.Generator
                  ) -> Dict[str, np.ndarray]:
        hist = rng.integers(0, self.active, size=(batch, seq_len))
        target = rng.integers(0, self.active, size=(batch,))
        user = self.z[hist].mean(axis=1)
        aff = np.einsum("bd,bd->b", self.z[target], user) * self.scale
        labels = (rng.random(batch) < 1 / (1 + np.exp(-aff))).astype(np.int32)
        return {"hist": hist.astype(np.int32), "target": target.astype(np.int32),
                "labels": labels}

    def field_batch(self, batch: int, vocab_sizes: Sequence[int], *,
                    rng: np.random.Generator) -> Dict[str, np.ndarray]:
        """xDeepFM-style multi-field batch; label from a random bilinear rule."""
        f = len(vocab_sizes)
        ids = np.stack([rng.integers(0, v, size=batch) for v in vocab_sizes],
                       axis=1)
        # learnable rule: parity of a fixed hash of the first few fields
        key = (ids[:, 0] * 2654435761 + ids[:, 1 % f] * 40503) % 97
        p = 1 / (1 + np.exp(-(key.astype(np.float64) - 48.5) / 12.0))
        labels = (rng.random(batch) < p).astype(np.int32)
        return {"ids": ids.astype(np.int32), "labels": labels}


__all__ = ["RecsysGenerator"]
