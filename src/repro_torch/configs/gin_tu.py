"""gin-tu [arXiv:1810.00826] — Graph Isomorphism Network.

Counterpart of ``repro.configs.gin_tu``, same widths and source.
n_layers=5 d_hidden=64 aggregator=sum eps=learnable. d_feat / n_classes
are shape-dependent (each GNN shape cell is its own dataset scale), so
``config_for_shape`` overrides them per shape; FULL carries the
full_graph_sm values.
"""
import dataclasses

from repro_torch.configs.base import ArchSpec, GNN_SHAPES
from repro_torch.models.gnn import GNNConfig

FULL = GNNConfig(name="gin-tu", n_layers=5, d_hidden=64, d_feat=1433,
                 n_classes=7, aggregator="sum", learnable_eps=True)

SMOKE = GNNConfig(name="gin-tu-smoke", n_layers=2, d_hidden=16, d_feat=8,
                  n_classes=3, aggregator="sum", learnable_eps=True)


def config_for_shape(shape_params: dict) -> GNNConfig:
    return dataclasses.replace(FULL, d_feat=shape_params["d_feat"],
                               n_classes=shape_params["n_classes"])


def spec() -> ArchSpec:
    return ArchSpec(
        name="gin-tu", family="gnn", config=FULL, smoke=SMOKE,
        shapes=GNN_SHAPES, profile="tp",
        source="arXiv:1810.00826; paper",
        notes="DTI inapplicable (no autoregressive shared-context stream); "
              "message passing = gather + segment_sum, edges sharded over "
              "the data axis (DESIGN.md §Arch-applicability).",
    )
