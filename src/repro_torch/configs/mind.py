"""mind [arXiv:1904.08030] — multi-interest capsule retrieval/ranking.

Counterpart of ``repro.configs.mind``, same widths and sources.
embed_dim=64 n_interests=4 capsule_iters=3. Item table sized 2^24 rows
(huge-embedding regime, 4.3 GB in fp32).
"""
from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES
from repro_torch.models.recsys import RecsysConfig

FULL = RecsysConfig(name="mind", kind="mind", embed_dim=64,
                    n_items=16_777_216, seq_len=100, n_interests=4,
                    capsule_iters=3)

SMOKE = RecsysConfig(name="mind-smoke", kind="mind", embed_dim=16,
                     n_items=1000, seq_len=20, n_interests=2,
                     capsule_iters=2)


def spec() -> ArchSpec:
    return ArchSpec(
        name="mind", family="recsys", config=FULL, smoke=SMOKE,
        shapes=RECSYS_SHAPES, profile="tp",
        source="arXiv:1904.08030; unverified",
        notes="DTI inapplicable (pointwise scorer over capsule summaries); "
              "retrieval_cand = one (K,D)x(D,C) matmul over 1M candidates.",
    )
