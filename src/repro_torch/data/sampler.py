"""Graph data: generators and a CSR neighbour sampler (copy of
``repro.data.sampler``, which is reached through ``repro/data/__init__.py``,
which imports jax).

The sampler implements GraphSAGE-style layered fanout sampling
(arXiv:1706.02216): given seed nodes and fanouts [f1, f2], it samples f1
neighbours per seed, then f2 per frontier node, emitting a fixed-shape
padded subgraph. The same seed gives byte-identical output to the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Graph:
    """CSR adjacency + features + labels."""
    indptr: np.ndarray      # (N+1,)
    indices: np.ndarray     # (E,)
    x: np.ndarray           # (N, d)
    y: np.ndarray           # (N,)

    @property
    def n_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def n_edges(self) -> int:
        return self.indices.shape[0]

    def edge_list(self) -> Tuple[np.ndarray, np.ndarray]:
        dst = np.repeat(np.arange(self.n_nodes), np.diff(self.indptr))
        return self.indices.astype(np.int32), dst.astype(np.int32)


def make_community_graph(n_nodes: int, avg_degree: int, d_feat: int,
                         n_classes: int, *, seed: int = 0,
                         homophily: float = 0.8) -> Graph:
    """Random graph with community structure: labels = community, features =
    noisy one-hot community signal (so GIN can actually learn)."""
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, n_classes, size=n_nodes)
    n_edges = n_nodes * avg_degree
    src = rng.integers(0, n_nodes, size=n_edges)
    same = rng.random(n_edges) < homophily
    # homophilous edges: destination from same community (approx via resample)
    dst = rng.integers(0, n_nodes, size=n_edges)
    pool = {}
    for c in range(n_classes):
        pool[c] = np.flatnonzero(comm == c)
    for c in range(n_classes):
        sel = same & (comm[src] == c)
        if sel.any() and len(pool[c]):
            dst[sel] = rng.choice(pool[c], size=int(sel.sum()))
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.add.at(indptr, dst + 1, 1)
    indptr = np.cumsum(indptr)
    x = rng.normal(scale=1.0, size=(n_nodes, d_feat)).astype(np.float32)
    sig = min(d_feat, n_classes)
    x[np.arange(n_nodes), comm % sig] += 2.0
    return Graph(indptr.astype(np.int64), src.astype(np.int32), x,
                 comm.astype(np.int32))


@dataclasses.dataclass
class SampledSubgraph:
    """Fixed-shape padded subgraph from layered neighbor sampling."""
    node_ids: np.ndarray    # (max_nodes,) original ids, -1 pad
    node_valid: np.ndarray  # (max_nodes,) bool
    edge_src: np.ndarray    # (max_edges,) local ids, pad points at 0
    edge_dst: np.ndarray
    edge_valid: np.ndarray  # (max_edges,) bool
    seed_local: np.ndarray  # (n_seeds,) local ids of the seeds


def sample_neighbors(g: Graph, seeds: np.ndarray, fanouts: Sequence[int],
                     *, rng: np.random.Generator) -> SampledSubgraph:
    """Layered uniform sampling. Local node 0..n_seeds-1 are the seeds."""
    local = {int(s): i for i, s in enumerate(seeds)}
    nodes: List[int] = list(map(int, seeds))
    e_src: List[int] = []
    e_dst: List[int] = []
    frontier = list(map(int, seeds))
    for f in fanouts:
        nxt: List[int] = []
        for u in frontier:
            lo, hi = g.indptr[u], g.indptr[u + 1]
            deg = hi - lo
            if deg == 0:
                continue
            take = min(f, deg)
            picks = rng.choice(g.indices[lo:hi], size=take,
                               replace=deg < f)
            for v in picks:
                v = int(v)
                if v not in local:
                    local[v] = len(nodes)
                    nodes.append(v)
                    nxt.append(v)
                e_src.append(local[v])
                e_dst.append(local[u])
        frontier = nxt

    max_nodes = len(seeds) * int(np.prod([f + 1 for f in fanouts]))
    max_edges = len(seeds) * int(np.sum(np.cumprod(fanouts)))
    node_ids = np.full((max_nodes,), -1, np.int64)
    node_ids[: len(nodes)] = nodes
    node_valid = node_ids >= 0
    es = np.zeros((max_edges,), np.int32)
    ed = np.zeros((max_edges,), np.int32)
    ev = np.zeros((max_edges,), bool)
    es[: len(e_src)] = e_src
    ed[: len(e_dst)] = e_dst
    ev[: len(e_src)] = True
    return SampledSubgraph(node_ids, node_valid, es, ed, ev,
                           np.arange(len(seeds), dtype=np.int32))


def make_molecule_batch(batch: int, n_nodes: int, n_edges: int, d_feat: int,
                        n_classes: int, *, seed: int = 0):
    """Batched small graphs packed into one disjoint union (molecule shape)."""
    rng = np.random.default_rng(seed)
    xs, srcs, dsts, gids, ys = [], [], [], [], []
    for b in range(batch):
        base = b * n_nodes
        x = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
        src = rng.integers(0, n_nodes, size=n_edges) + base
        dst = rng.integers(0, n_nodes, size=n_edges) + base
        y = int(rng.integers(0, n_classes))
        x[:, y % d_feat] += 1.5      # learnable signal
        xs.append(x)
        srcs.append(src)
        dsts.append(dst)
        gids.append(np.full(n_nodes, b, np.int32))
        ys.append(y)
    return (np.concatenate(xs), np.concatenate(srcs).astype(np.int32),
            np.concatenate(dsts).astype(np.int32), np.concatenate(gids),
            np.asarray(ys, np.int32))


__all__ = ["Graph", "make_community_graph", "SampledSubgraph",
           "sample_neighbors", "make_molecule_batch"]
