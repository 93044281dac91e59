"""GIN (arXiv:1810.00826) with segment-sum message passing (counterpart of
``repro.models.gnn``).

The reference gathers source features (``jnp.take``) and scatters them
into destinations (``jax.ops.segment_sum``). On the card a scatter-add
(``index_add_``) adds in an order that varies from run to run, and so
does the scatter-add that is the gather's gradient. Here both directions
run over edges sorted once per graph (``EdgePlan``): the forward reduces
each destination's run of edges, the backward each source's run, each
run summed in one fixed order (``torch.segment_reduce``), so equal inputs
give equal bits. The (E, d) message tensor is never whole: edges go
through in chunks of destination runs, at most ``chunk_edges`` rows of
messages at a time.

Supports full-graph, sampled-minibatch (``repro_torch.data.sampler``) and
batched small molecules (``graph_ids`` readout).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import Params, dense, init_linear, init_mlp, mlp


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str = "gin-tu"
    n_layers: int = 5
    d_hidden: int = 64
    d_feat: int = 1433
    n_classes: int = 7
    aggregator: str = "sum"
    learnable_eps: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "float32"   # "bfloat16" halves message bytes
    remat: bool = True               # recompute each layer in the backward

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


@torch.no_grad()
def init_gin(cfg: GNNConfig, *, seed: int = 0,
             generator: Optional[torch.Generator] = None,
             device: DeviceLike = None) -> Params:
    """Random weights from a seeded ``torch.Generator`` (``generator``, or
    a new one seeded with ``seed``) on ``device``; the reference's layout:
    ``proj``, ``layer{i}`` = {``mlp`` (fc0, fc1), scalar ``eps``}, ``head``."""
    device = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    d, kw = cfg.d_hidden, dict(dtype=cfg.pdtype, device=device)
    p: Params = {"proj": init_linear(gen, cfg.d_feat, d, bias=True, **kw)}
    for i in range(cfg.n_layers):
        p[f"layer{i}"] = {"mlp": init_mlp(gen, [d, d, d], **kw),
                          "eps": torch.zeros((), **kw)}
    p["head"] = init_linear(gen, d, cfg.n_classes, bias=True, **kw)
    return p


# ---------------------------------------------------------------------------
# the edge plan: sorted runs in both directions
# ---------------------------------------------------------------------------

#: messages (rows of d values) materialised at once by the segment sum
CHUNK_EDGES = 1 << 22


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """``out[j] = sum of w[e] * x[idx[e]]`` over the run ``offsets[j] <= e
    < offsets[j + 1]``: one direction of a sparse operator, its edges
    sorted by output row. ``chunks`` are ``(j0, j1, e0, e1, offsets of the
    rows j0..j1 from e0)``, whole runs of at most ``CHUNK_EDGES`` edges
    (a longer run is a chunk of its own)."""
    idx: torch.Tensor                 # (E,) int64 input row of each edge
    w: Optional[torch.Tensor]         # (E, 1) fp32 edge weight, or None
    offsets: torch.Tensor             # (n_out + 1,) int64
    chunks: Tuple[tuple, ...]
    n_out: int

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """(n_in, d) -> (n_out, d), each run summed in edge order."""
        out = x.new_empty((self.n_out,) + tuple(x.shape[1:]))
        for j0, j1, e0, e1, off in self.chunks:
            if e0 == e1:
                out[j0:j1] = 0
                continue
            m = x.index_select(0, self.idx[e0:e1])
            if self.w is not None:
                m.mul_(self.w[e0:e1].to(m.dtype))
            out[j0:j1] = torch.segment_reduce(m, "sum", offsets=off,
                                              unsafe=True)
        return out


def _segment_plan(keys: torch.Tensor, idx: torch.Tensor,
                  w: Optional[torch.Tensor], n_out: int,
                  chunk_edges: int) -> Tuple[SegmentPlan, torch.Tensor]:
    """Sort edges by ``keys`` (stable) into runs, one per output row;
    returns the plan and the sorting permutation."""
    order = torch.argsort(keys, stable=True)
    keys = keys[order]
    offsets = torch.searchsorted(
        keys, torch.arange(n_out + 1, device=keys.device, dtype=keys.dtype))
    off_h = offsets.cpu().numpy()
    chunks, j0 = [], 0
    while j0 < n_out:
        j1 = int(np.searchsorted(off_h, off_h[j0] + chunk_edges,
                                 side="right")) - 1
        j1 = min(max(j1, j0 + 1), n_out)
        e0, e1 = int(off_h[j0]), int(off_h[j1])
        chunks.append((j0, j1, e0, e1, offsets[j0:j1 + 1] - e0))
        j0 = j1
    return SegmentPlan(idx[order].long(), None if w is None else w[order],
                       offsets, tuple(chunks), n_out), order


@dataclasses.dataclass(frozen=True)
class EdgePlan:
    """One graph's edges sorted once, reused by every layer and step.

    ``fwd`` sums sources into destinations (the reference's
    ``segment_sum(take(h, src) * valid, dst)``), ``bwd`` is its transpose
    (the gather's gradient, destinations into sources). ``gather_bwd``
    sums per-edge gradients (in ``fwd``'s edge order) into sources, for
    the ``"max"`` aggregator, which keeps its messages. ``deg`` (n, 1)
    counts every in-range edge, valid or not, as the reference's mean
    does."""
    fwd: SegmentPlan
    bwd: SegmentPlan
    gather_bwd: SegmentPlan
    deg: torch.Tensor
    n_nodes: int


def make_edge_plan(edge_src, edge_dst, n_nodes: int,
                   edge_valid=None, *, n_src: Optional[int] = None,
                   chunk_edges: int = CHUNK_EDGES,
                   device: DeviceLike = None) -> EdgePlan:
    """Plan for ``edge_src``/``edge_dst`` (numpy or tensors) on
    ``device`` (default: the tensors' device, else the card).

    As ``segment_sum`` does, destinations outside ``[0, n_nodes)`` are
    dropped; a source outside ``[0, n_src)`` (default ``n_nodes``) is an
    error. ``edge_valid`` (bool) weighs each edge's message by 0 or 1, as
    the reference multiplies it in. ``n_src`` differs from ``n_nodes``
    for a readout (nodes into graphs)."""
    if device is None and torch.is_tensor(edge_src):
        device = edge_src.device
    device = resolve_device(device)
    n_src = n_nodes if n_src is None else n_src
    src = torch.as_tensor(edge_src, device=device).long()
    dst = torch.as_tensor(edge_dst, device=device).long()
    if bool(((src < 0) | (src >= n_src)).any()):
        raise ValueError(f"edge source ids outside [0, {n_src})")
    keep = (dst >= 0) & (dst < n_nodes)
    w = None
    if edge_valid is not None:
        w = torch.as_tensor(edge_valid, device=device)[keep]
        w = w.to(torch.float32)[:, None]
    src, dst = src[keep], dst[keep]
    fwd, order = _segment_plan(dst, src, w, n_nodes, chunk_edges)
    bwd, _ = _segment_plan(src, dst, w, n_src, chunk_edges)
    # each edge's position in fwd's order, gathered back in bwd's order
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.numel(), device=device)
    gather_bwd, _ = _segment_plan(src, pos, None, n_src, chunk_edges)
    deg = (fwd.offsets[1:] - fwd.offsets[:-1])[:, None]
    return EdgePlan(fwd, bwd, gather_bwd, deg, n_nodes)


class _SegmentSum(torch.autograd.Function):
    """``plan.fwd.apply(x)``; its gradient is ``plan.bwd.apply(g)``."""

    @staticmethod
    def forward(ctx, x, plan: EdgePlan):
        ctx.plan = plan
        return plan.fwd.apply(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.plan.bwd.apply(g.contiguous()), None


class _Gather(torch.autograd.Function):
    """Source rows in ``fwd``'s edge order (the messages, unweighted); the
    gradient sums each source's edges in a fixed order."""

    @staticmethod
    def forward(ctx, x, plan: EdgePlan):
        ctx.plan = plan
        return x.index_select(0, plan.fwd.idx)

    @staticmethod
    def backward(ctx, g):
        return ctx.plan.gather_bwd.apply(g.contiguous()), None


class _SegmentMax(torch.autograd.Function):
    """Max over each destination's run of messages (``fwd``'s order;
    ``-inf`` for an empty run). The gradient is shared evenly among the
    messages equal to the max, as jax's ``segment_max`` shares it."""

    @staticmethod
    def forward(ctx, msgs, plan: EdgePlan):
        out = torch.segment_reduce(msgs, "max", offsets=plan.fwd.offsets,
                                   unsafe=True)
        ctx.plan = plan
        ctx.save_for_backward(msgs, out)
        return out

    @staticmethod
    def backward(ctx, g):
        msgs, out = ctx.saved_tensors
        plan = ctx.plan
        seg = torch.repeat_interleave(
            torch.arange(plan.n_nodes, device=msgs.device), plan.deg[:, 0],
            output_size=msgs.shape[0])
        hit = (msgs == out.index_select(0, seg)).to(g.dtype)
        ties = torch.segment_reduce(hit, "sum", offsets=plan.fwd.offsets,
                                    unsafe=True)
        share = g / torch.clamp(ties, min=1.0)
        return hit * share.index_select(0, seg), None


def gin_aggregate(h: torch.Tensor, edge_src=None, edge_dst=None,
                  n_nodes: Optional[int] = None, aggregator: str = "sum",
                  edge_valid=None, *,
                  plan: Optional[EdgePlan] = None) -> torch.Tensor:
    """Message passing: for each node, sum (max, mean) of its in-edges'
    source features, pad edges weighted by 0 (``edge_valid``: padded
    subgraphs point their pad edges at node 0). The graph is ``plan``, or
    else the edge arrays, planned anew.

    ``"max"`` gives ``-inf`` to a node with no in-edges, and a pad edge's
    zero message takes part in its destination's max, as in the
    reference; ``"mean"`` divides by the count of in-edges, pad edges
    included, at least 1."""
    if plan is None:
        plan = make_edge_plan(edge_src, edge_dst, n_nodes, edge_valid,
                              device=h.device)
    if aggregator == "sum":
        return _SegmentSum.apply(h, plan)
    if aggregator == "mean":
        s = _SegmentSum.apply(h, plan)
        return s / torch.clamp(plan.deg.to(h.dtype), min=1.0)
    if aggregator == "max":
        msgs = _Gather.apply(h, plan)
        if plan.fwd.w is not None:
            msgs = msgs * plan.fwd.w.to(msgs.dtype)
        return _SegmentMax.apply(msgs, plan)
    raise ValueError(aggregator)


def _eps(lp: Params, cfg: GNNConfig) -> torch.Tensor:
    # without learnable eps the leaf still enters the graph, times 0, so
    # it gets the zero gradient jax gives an unused leaf
    return lp["eps"] if cfg.learnable_eps else lp["eps"] * 0.0


def _layer(lp: Params, h: torch.Tensor, cfg: GNNConfig, plan: EdgePlan,
           node_valid: Optional[torch.Tensor]) -> torch.Tensor:
    agg = gin_aggregate(h, aggregator=cfg.aggregator, plan=plan)
    h = mlp(lp["mlp"], (1.0 + _eps(lp, cfg)) * h + agg, final_act=True)
    if node_valid is not None:
        h = h * node_valid[:, None].to(h.dtype)
    return h


def _plan(plan: Optional[EdgePlan], edge_src, edge_dst, n_nodes: int,
          edge_valid, device) -> EdgePlan:
    if plan is not None:
        return plan
    return make_edge_plan(edge_src, edge_dst, n_nodes, edge_valid,
                          device=device)


def gin_forward(p: Params, cfg: GNNConfig, x: torch.Tensor, edge_src=None,
                edge_dst=None, *, node_valid: Optional[torch.Tensor] = None,
                edge_valid=None, plan: Optional[EdgePlan] = None
                ) -> torch.Tensor:
    """Node classification: x (N, d_feat) -> logits (N, n_classes).

    The graph is ``plan`` (``make_edge_plan``, made once and reused by
    every call), or else the reference's ``edge_src``, ``edge_dst`` and
    ``edge_valid``, planned anew. With ``cfg.remat`` and autograd
    recording, each layer runs under ``torch.utils.checkpoint``: only its
    input is kept."""
    plan = _plan(plan, edge_src, edge_dst, x.shape[0], edge_valid, x.device)
    h = F.relu(dense(p["proj"], x)).to(cfg.cdtype)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        lp = p[f"layer{i}"]
        if remat:
            h = checkpoint(_layer, lp, h, cfg, plan, node_valid,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            h = _layer(lp, h, cfg, plan, node_valid)
    return dense(p["head"], h)


def make_readout_plan(graph_ids, n_graphs: int, *,
                      device: DeviceLike = None) -> EdgePlan:
    """The sum readout as a plan: node i into graph ``graph_ids[i]``."""
    if device is None and torch.is_tensor(graph_ids):
        device = graph_ids.device
    device = resolve_device(device)
    gid = torch.as_tensor(graph_ids, device=device)
    nodes = torch.arange(gid.numel(), device=device)
    return make_edge_plan(nodes, gid, n_graphs, n_src=gid.numel(),
                          device=device)


def gin_graph_forward(p: Params, cfg: GNNConfig, x: torch.Tensor,
                      edge_src=None, edge_dst=None, graph_ids=None,
                      n_graphs: Optional[int] = None, edge_valid=None, *,
                      plan: Optional[EdgePlan] = None,
                      readout: Optional[EdgePlan] = None) -> torch.Tensor:
    """Graph classification (molecule shape): the sum over each graph's
    nodes after every layer, then the head. ``plan`` and ``readout``
    (``make_readout_plan``) stand for the edge arrays and for
    ``graph_ids``/``n_graphs``, as in ``gin_forward``. No remat, as in
    the reference."""
    plan = _plan(plan, edge_src, edge_dst, x.shape[0], edge_valid, x.device)
    if readout is None:
        readout = make_readout_plan(graph_ids, n_graphs, device=x.device)
    h = F.relu(dense(p["proj"], x))
    acc = torch.zeros((readout.n_nodes, cfg.d_hidden), dtype=h.dtype,
                      device=h.device)
    for i in range(cfg.n_layers):
        h = _layer(p[f"layer{i}"], h, cfg, plan, None)
        acc = acc + _SegmentSum.apply(h, readout)
    return dense(p["head"], acc)


__all__ = ["GNNConfig", "init_gin", "CHUNK_EDGES", "SegmentPlan", "EdgePlan",
           "make_edge_plan", "make_readout_plan", "gin_aggregate",
           "gin_forward", "gin_graph_forward"]
