"""din [arXiv:1706.06978] — Deep Interest Network (target attention).

Counterpart of ``repro.configs.din``, same widths and sources.
embed_dim=18 seq_len=100 attn_mlp=80-40 mlp=200-80. Item table 2^26 rows
(4.83 GB in fp32). The multi-target train step (`din_forward_multi`) is the DTI
transplant: k targets share one history-embedding pass.
"""
from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES
from repro_torch.models.recsys import RecsysConfig

FULL = RecsysConfig(name="din", kind="din", embed_dim=18,
                    n_items=67_108_864, seq_len=100,
                    attn_mlp=(80, 40), head_mlp=(200, 80))

SMOKE = RecsysConfig(name="din-smoke", kind="din", embed_dim=8,
                     n_items=1000, seq_len=20, attn_mlp=(16,),
                     head_mlp=(32,))


def spec() -> ArchSpec:
    return ArchSpec(
        name="din", family="recsys", config=FULL, smoke=SMOKE,
        shapes=RECSYS_SHAPES, profile="tp",
        source="arXiv:1706.06978; paper",
        notes="DTI partially applies: multi-target DIN shares the history "
              "pass across k targets (DESIGN.md §Arch-applicability); "
              "retrieval_cand chunks 1M candidates through target attention.",
    )
