"""Config substrate: ArchSpec (one per architecture) + ShapeSpec; a copy of
``repro.configs.base`` (which imports no JAX, but is reached through
``repro/configs/__init__.py``, which imports the reference's models).

Every architecture ships its public-literature FULL config, a reduced
SMOKE config of the same family and its own shape table.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell. ``kind`` selects the step fn lowered for it:

    lm:      train | prefill | decode | decode_ring
    gnn:     graph_full | graph_sampled | graph_batched
    recsys:  train | serve | retrieval
    """
    name: str
    kind: str
    params: Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str                     # "lm" | "gnn" | "recsys"
    config: Any                     # full-size model config
    smoke: Any                      # reduced same-family config
    shapes: Dict[str, ShapeSpec]
    profile: str = "tp"             # sharding profile ("tp" | "fsdp_tp")
    trainable: Optional[str] = None  # None = full fine-tune, "lora" = PEFT
    source: str = ""                # public citation
    notes: str = ""

    def shape(self, name: str) -> ShapeSpec:
        return self.shapes[name]


# The four LM shapes are shared verbatim by all five LM archs.
def lm_shapes(*, window: int = 1024, k_targets: int = 50,
              ring_capacity: int = 2048,
              grad_accum: int = 4,
              prefill_chunks: int = 1) -> Dict[str, ShapeSpec]:
    return {
        "train_4k": ShapeSpec("train_4k", "train",
                              dict(seq_len=4096, global_batch=256,
                                   window=window, k_targets=k_targets,
                                   grad_accum=grad_accum)),
        "prefill_32k": ShapeSpec("prefill_32k", "prefill",
                                 dict(seq_len=32768, global_batch=32,
                                      window=window,
                                      prefill_chunks=prefill_chunks)),
        "decode_32k": ShapeSpec("decode_32k", "decode",
                                dict(cache_len=32768, global_batch=128,
                                     window=window)),
        # Sub-quadratic 500k decode is a corollary of the paper's windowed
        # causal attention: the KV cache is a ring buffer of `ring_capacity`
        # slots regardless of the 524288 logical position (DESIGN.md §4).
        "long_500k": ShapeSpec("long_500k", "decode_ring",
                               dict(cache_len=524288, global_batch=1,
                                    window=window,
                                    ring_capacity=ring_capacity)),
    }


RECSYS_SHAPES: Dict[str, ShapeSpec] = {
    "train_batch": ShapeSpec("train_batch", "train", dict(batch=65536)),
    "serve_p99": ShapeSpec("serve_p99", "serve", dict(batch=512)),
    "serve_bulk": ShapeSpec("serve_bulk", "serve", dict(batch=262144)),
    "retrieval_cand": ShapeSpec("retrieval_cand", "retrieval",
                                dict(batch=1, n_candidates=1_000_000)),
}


def _pad(n: int, mult: int = 512) -> int:
    return ((n + mult - 1) // mult) * mult


GNN_SHAPES: Dict[str, ShapeSpec] = {
    # counts padded to multiples of 512 so edge/node arrays shard evenly;
    # `*_raw` keeps the literature value, valid-masks cover the padding.
    "full_graph_sm": ShapeSpec("full_graph_sm", "graph_full",
                               dict(n_nodes=_pad(2708), n_edges=_pad(10556),
                                    n_nodes_raw=2708, n_edges_raw=10556,
                                    d_feat=1433, n_classes=7)),
    "minibatch_lg": ShapeSpec("minibatch_lg", "graph_sampled",
                              dict(n_nodes=232_965, n_edges=114_615_892,
                                   batch_nodes=1024, fanouts=(15, 10),
                                   d_feat=602, n_classes=41)),
    "ogb_products": ShapeSpec("ogb_products", "graph_full",
                              dict(n_nodes=_pad(2_449_029),
                                   n_edges=_pad(61_859_140),
                                   n_nodes_raw=2_449_029,
                                   n_edges_raw=61_859_140,
                                   d_feat=100, n_classes=47)),
    "molecule": ShapeSpec("molecule", "graph_batched",
                          dict(n_nodes=30, n_edges=64, batch=128,
                               d_feat=16, n_classes=2)),
}


__all__ = ["ArchSpec", "ShapeSpec", "lm_shapes", "RECSYS_SHAPES",
           "GNN_SHAPES"]
