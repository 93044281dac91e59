"""xdeepfm [arXiv:1803.05170] — CIN + DNN + linear over 39 sparse fields.

n_sparse=39 embed_dim=10 cin_layers=200-200-200 mlp=400-400. Field vocab
sizes follow a criteo/avazu-like power-law mixture (~17.5M total rows).
Counterpart of ``repro.configs.xdeepfm``, same widths and sources.
"""
from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES
from repro_torch.models.recsys import RecsysConfig

FIELD_VOCABS = tuple([4_194_304] * 3 + [1_048_576] * 4 + [65_536] * 8
                     + [4_096] * 12 + [256] * 12)
assert len(FIELD_VOCABS) == 39

FULL = RecsysConfig(name="xdeepfm", kind="xdeepfm", embed_dim=10,
                    field_vocabs=FIELD_VOCABS,
                    cin_layers=(200, 200, 200), dnn_dims=(400, 400))

SMOKE = RecsysConfig(name="xdeepfm-smoke", kind="xdeepfm", embed_dim=8,
                     field_vocabs=(64,) * 6, cin_layers=(16, 16),
                     dnn_dims=(32,))


def spec() -> ArchSpec:
    return ArchSpec(
        name="xdeepfm", family="recsys", config=FULL, smoke=SMOKE,
        shapes=RECSYS_SHAPES, profile="tp",
        source="arXiv:1803.05170; paper",
        notes="DTI inapplicable (non-sequential feature interaction); "
              "retrieval_cand varies the item field over 1M ids in chunks.",
    )
