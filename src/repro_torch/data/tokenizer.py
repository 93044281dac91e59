"""Deterministic hash word-piece tokenizer (copy of ``repro.data.tokenizer``).

Words map to stable ids in [n_reserved, vocab) via FNV-1a; special tokens
live below n_reserved and match ``repro_torch.core.dti.SpecialTokens``.
"""
from __future__ import annotations

from typing import List

from repro_torch.core.dti import SpecialTokens


def _fnv1a(s: str) -> int:
    h = 0x811C9DC5
    for ch in s.encode():
        h = ((h ^ ch) * 0x01000193) & 0xFFFFFFFF
    return h


class HashTokenizer:
    def __init__(self, vocab_size: int = 8192,
                 sp: SpecialTokens = SpecialTokens()):
        if vocab_size <= sp.n_reserved:
            raise ValueError(f"vocab_size {vocab_size} leaves no word ids")
        self.vocab_size = vocab_size
        self.sp = sp

    def token_id(self, word: str) -> int:
        span = self.vocab_size - self.sp.n_reserved
        return self.sp.n_reserved + _fnv1a(word.lower()) % span

    def encode(self, text: str) -> List[int]:
        return [self.token_id(w) for w in text.split()]


__all__ = ["HashTokenizer"]
