"""Synthetic MovieLens-like CTR corpus and its user split (copy of
``repro.data.synthetic``).

Items carry a latent factor that their words encode; users carry a latent
preference; labels are Bernoulli(sigmoid(scale * p_u . z_i)). The same
seed gives byte-identical output to the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.data.tokenizer import HashTokenizer

_ADJ = ["dark", "silent", "lost", "golden", "broken", "electric", "crimson",
        "frozen", "hidden", "iron", "lucky", "midnight", "neon", "paper",
        "quiet", "raging", "secret", "turbo", "velvet", "wild"]
_NOUN = ["river", "empire", "garden", "signal", "harbor", "mirror", "engine",
         "forest", "galaxy", "anthem", "circus", "desert", "echo", "fortune",
         "horizon", "island", "jungle", "kingdom", "lantern", "meadow"]
_GENRE = ["action", "comedy", "drama", "horror", "romance", "scifi",
          "thriller", "western"]


@dataclasses.dataclass
class CTRDataset:
    item_tokens: List[List[int]]          # token seq per item id
    item_latent: np.ndarray               # (I, f)
    sequences: List[Dict[str, np.ndarray]]  # per user: items, ratings, labels
    tokenizer: HashTokenizer
    avg_item_tokens: float

    def user_prompt_material(self, u: int) -> Tuple[List[List[int]], np.ndarray]:
        """-> (per-interaction token lists incl. rating token, labels)."""
        seq = self.sequences[u]
        toks = []
        for item, rating in zip(seq["items"], seq["ratings"]):
            t = list(self.item_tokens[item])
            t.append(self.tokenizer.token_id(f"rating={rating}"))
            toks.append(t)
        return toks, seq["labels"]


def make_ctr_dataset(*, n_users: int = 64, n_items: int = 400,
                     seq_len: int = 80, min_seq_len: int | None = None,
                     latent_dim: int = 4,
                     vocab_size: int = 2048, label_scale: float = 3.0,
                     seed: int = 0) -> CTRDataset:
    """``min_seq_len``: when set, per-user history lengths are drawn
    uniformly from [min_seq_len, seq_len] instead of all-equal."""
    rng = np.random.default_rng(seed)
    tok = HashTokenizer(vocab_size)

    z = rng.normal(size=(n_items, latent_dim)) / np.sqrt(latent_dim)
    item_tokens: List[List[int]] = []
    for i in range(n_items):
        # words deterministically encode the latent's sign pattern + id hash
        buckets = (z[i] > 0).astype(int)
        adj = _ADJ[(i * 7 + buckets[0] * 10) % len(_ADJ)]
        noun = _NOUN[(i * 13 + buckets[1 % latent_dim] * 10) % len(_NOUN)]
        genre = _GENRE[int(buckets @ (2 ** np.arange(len(buckets)))) % len(_GENRE)]
        toks = [tok.sp.sep] + tok.encode(f"{adj} {noun} v{i}")
        toks.append(tok.token_id(f"genre={genre}"))
        item_tokens.append(toks)

    sequences = []
    for u in range(n_users):
        p = rng.normal(size=(latent_dim,)) / np.sqrt(latent_dim)
        m = (seq_len if min_seq_len is None
             else int(rng.integers(min_seq_len, seq_len + 1)))
        items = rng.integers(0, n_items, size=m)
        aff = z[items] @ p * label_scale
        probs = 1.0 / (1.0 + np.exp(-aff))
        labels = (rng.random(m) < probs).astype(np.int64)
        ratings = np.clip(np.round(2.5 + 1.5 * np.tanh(aff)), 1, 5).astype(int)
        sequences.append({"items": items, "ratings": ratings, "labels": labels})

    avg = float(np.mean([len(t) + 1 for t in item_tokens]))  # + rating token
    return CTRDataset(item_tokens, z, sequences, tok, avg)


def split_users(ds: CTRDataset, ratios=(0.8, 0.1, 0.1), seed: int = 1):
    """8:1:1 split along each user's timeline (paper's protocol):
    train ``(toks, labels)``, val and test ``(toks, labels, start)`` whose
    context may reach back before ``start``."""
    train, val, test = [], [], []
    for u in range(len(ds.sequences)):
        toks, labels = ds.user_prompt_material(u)
        m = len(toks)
        a, b = int(m * ratios[0]), int(m * (ratios[0] + ratios[1]))
        train.append((toks[:a], labels[:a]))
        val.append((toks[:b], labels[:b], a))
        test.append((toks, labels, b))
    return train, val, test


__all__ = ["CTRDataset", "make_ctr_dataset", "split_users"]
