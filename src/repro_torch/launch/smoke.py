"""Reduced-config smoke training (counterpart of ``repro.launch.smoke``).

``train_smoke(arch)`` instantiates the arch's SMOKE config, generates
matching synthetic data, runs real AdamW steps and returns the loss
trajectory. ``repro_torch.launch.train`` calls it for the recsys archs
and the GNN. All three of the reference's branches (``lm``, ``recsys``,
``gnn``) are ported.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.dti import (SpecialTokens, batch_prompts,
                                  build_streaming_prompts)
from repro_torch.core.losses import ctr_loss
from repro_torch.data.recsys_gen import RecsysGenerator
from repro_torch.data.sampler import make_community_graph
from repro_torch.data.synthetic import make_ctr_dataset
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.gnn import gin_forward, init_gin, make_edge_plan
from repro_torch.models.recsys import bce_loss, init_recsys, recsys_logits
from repro_torch.models.transformer import forward, init_params
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import init_train_state, make_train_step


SP = SpecialTokens()


def _ce(logits, labels, mask=None):
    """Mean cross entropy of ``labels`` under ``logits`` (fp32), over the
    rows ``mask`` keeps when given."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[:, None].long())[:, 0]
    if mask is None:
        return nll.mean()
    w = mask.float()
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)


def _run(loss_fn, params, batches, steps, lr) -> Dict:
    ocfg = OptimizerConfig(lr=lr, schedule="const", warmup_steps=1,
                           total_steps=steps)
    state = init_train_state(params, ocfg)
    step_fn = make_train_step(loss_fn, ocfg)
    losses = []
    for _ in range(steps):
        state, m = step_fn(state, next(batches))
        losses.append(float(m["loss"]))
    if not all(np.isfinite(losses)):
        raise FloatingPointError(f"non-finite loss: {losses}")
    return {"losses": losses, "first": losses[0], "last": losses[-1],
            "state": state}


def train_smoke(arch: str, *, steps: int = 20, batch: int = 8,
                seed: int = 0, lr: float = 1e-2,
                device: DeviceLike = None) -> Dict:
    spec = get_arch(arch)
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    cfg = spec.smoke
    if spec.family == "lm":
        return {"arch": arch, "device": str(device),
                **_train_lm(cfg, rng, steps, batch, seed, lr, device)}
    if spec.family == "gnn":
        return {"arch": arch, "device": str(device),
                **_train_gnn(cfg, steps, seed, lr, device)}
    if spec.family != "recsys":
        raise ValueError(spec.family)
    gen = RecsysGenerator(cfg.n_items, seed=seed)

    def batches():
        while True:
            if cfg.kind == "xdeepfm":
                yield gen.field_batch(batch, cfg.field_vocabs, rng=rng)
            else:
                yield gen.seq_batch(batch, cfg.seq_len, rng=rng)

    params = init_recsys(cfg, seed=seed, device=device)

    def loss_fn(p, b, _gen):
        return bce_loss(recsys_logits(p, cfg, b), b["labels"]), {}

    return {"arch": arch, "device": str(device),
            **_run(loss_fn, params, batches(), steps, lr)}


def _train_lm(cfg, rng, steps, batch, seed, lr, device) -> Dict:
    """The reference's ``lm`` branch: streaming DTI prompts of 8 users
    (n_ctx 4, k 4), the [SUM] loss plus the MoE balance loss."""
    ds = make_ctr_dataset(n_users=8, n_items=64, seq_len=30,
                          vocab_size=cfg.vocab_size, seed=seed)
    prompts = []
    for u in range(8):
        toks, labels = ds.user_prompt_material(u)
        prompts += build_streaming_prompts(toks, labels, n_ctx=4, k=4,
                                           max_len=4 * max(cfg.window, 32))
    params = init_params(cfg, seed=seed, device=device)
    win = cfg.window or 0

    def loss_fn(p, b, _gen):
        out = forward(p, cfg, b["tokens"], positions=b["positions"],
                      is_sum=b["is_sum"], valid=b["valid"],
                      dti_enabled=True, window=win)
        loss, _ = ctr_loss(p, cfg, out["hidden"], b["is_sum"], b["labels"],
                           yes_id=SP.yes, no_id=SP.no)
        return loss + out["aux_loss"], {}

    def batches():
        while True:
            yield from batch_prompts(prompts, batch, rng=rng)

    return _run(loss_fn, params, batches(), steps, lr)


def _train_gnn(cfg, steps, seed, lr, device) -> Dict:
    """The reference's ``gnn`` branch: full-graph node classification on a
    200-node community graph (average degree 6), every node labelled."""
    g = make_community_graph(200, 6, cfg.d_feat, cfg.n_classes, seed=seed)
    es, ed = g.edge_list()
    plan = make_edge_plan(es, ed, g.n_nodes, np.ones(len(es), bool),
                          device=device)
    params = init_gin(cfg, seed=seed, device=device)
    full = {"x": g.x, "labels": g.y, "label_mask": np.ones(len(g.y), bool)}

    def loss_fn(p, b, _gen):
        logits = gin_forward(p, cfg, b["x"], plan=plan)
        return _ce(logits, b["labels"], b["label_mask"]), {}

    def batches():
        while True:
            yield full

    return _run(loss_fn, params, batches(), steps, lr)


__all__ = ["train_smoke"]
