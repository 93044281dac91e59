"""sasrec [arXiv:1808.09781] — causal self-attention sequential recommender.

Counterpart of ``repro.configs.sasrec``, same widths and sources.
embed_dim=50 n_blocks=2 n_heads=1 seq_len=50. Item table 2^22 rows. SASRec
natively trains all positions in parallel — it is the k=m limiting case of
DTI; cfg.window>0 adds the paper's windowed alignment.
"""
from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES
from repro_torch.models.recsys import RecsysConfig

FULL = RecsysConfig(name="sasrec", kind="sasrec", embed_dim=50,
                    n_items=4_194_304, seq_len=50, n_blocks=2, n_heads=1)

SMOKE = RecsysConfig(name="sasrec-smoke", kind="sasrec", embed_dim=16,
                     n_items=1000, seq_len=20, n_blocks=1, n_heads=1)


def spec() -> ArchSpec:
    return ArchSpec(
        name="sasrec", family="recsys", config=FULL, smoke=SMOKE,
        shapes=RECSYS_SHAPES, profile="tp",
        source="arXiv:1808.09781; paper",
        notes="Native DTI (k=m limit): all-position parallel training; "
              "retrieval_cand = last hidden state dot 1M item embeddings.",
    )
