"""Reduced-config smoke training (counterpart of ``repro.launch.smoke``).

``train_smoke(arch)`` instantiates the arch's SMOKE config, generates
matching synthetic data, runs real AdamW steps and returns the loss
trajectory. ``repro_torch.launch.train`` calls it for the recsys archs.
Only the recsys branch is ported: the reference's ``lm`` branch waits for
ROADMAP A9 (the LM configs) and its ``gnn`` branch for A9
(``models/gnn.py``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.data.recsys_gen import RecsysGenerator
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.recsys import bce_loss, init_recsys, recsys_logits
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import init_train_state, make_train_step


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
    if arch == "minicpm3-4b":
        raise NotImplementedError(
            "smoke training of minicpm3-4b waits for the MLA training slice "
            "(ROADMAP A5); it serves through repro_torch.serve")
    if spec.family == "lm":
        raise NotImplementedError(
            "smoke training of the LM archs waits for ROADMAP A9 (the LM "
            "configs); dti-llama trains through repro_torch.launch.train")
    if spec.family != "recsys":
        raise NotImplementedError(f"the {spec.family} family waits for "
                                  "ROADMAP A9 (models/gnn.py)")
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    cfg = spec.smoke
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


__all__ = ["train_smoke"]
