"""AdamW + LR schedules (cosine, WSD, const) + gradient clipping, by hand
over the param dict (counterpart of ``repro.train.optimizer``).

The order of operations follows the reference's ``adamw_update`` leaf for
leaf, so one step from one state agrees to fp32 rounding: fp32 master
weights over bf16 params (``master_fp32``), a trainable subset (``"lora"``
trains every leaf with "lora" in its path, ``lora_scale`` included), no
weight decay on norms, biases and scalars, and a clip factor from the
global norm of the gradients of *every* leaf, frozen ones included.

State mirrors the params: per leaf, fp32 ``mu``/``nu`` (and master) for a
trainable leaf and a fp32 zero scalar for a frozen one, as the reference
keeps them. Int8 gradient compression and sharded state wait for the
scale-out slice (ROADMAP queue A8).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.transformer import map_leaves as _map
from repro_torch.models.transformer import named_leaves

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 1e-3
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.001
    grad_clip: float = 1.0
    schedule: str = "cosine"        # "cosine" | "wsd" | "const"
    warmup_steps: int = 100
    total_steps: int = 1000
    decay_frac: float = 0.1         # WSD: fraction of steps in decay phase
    min_lr_frac: float = 0.1
    master_fp32: bool = True
    trainable: Optional[str] = None  # None = all, "lora" = lora_* leaves only


class OptState(NamedTuple):
    step: torch.Tensor              # int32 scalar, on the CPU
    mu: Params
    nu: Params
    master: Optional[Params]


def schedule_lr(cfg: OptimizerConfig, step: int) -> float:
    """Learning rate at ``step``, in fp32 arithmetic as the reference's."""
    f = np.float32
    s = f(step)
    warm = np.minimum(f(1.0), s / f(max(cfg.warmup_steps, 1)))
    if cfg.schedule == "const":
        return float(f(cfg.lr) * warm)
    if cfg.schedule == "cosine":
        t = np.clip((s - f(cfg.warmup_steps))
                    / f(max(cfg.total_steps - cfg.warmup_steps, 1)),
                    f(0), f(1))
        cos = f(0.5) * (f(1) + np.cos(f(math.pi) * t))
        return float(f(cfg.lr) * warm * (f(cfg.min_lr_frac)
                                         + f(1 - cfg.min_lr_frac) * cos))
    if cfg.schedule == "wsd":
        # Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395)
        decay_start = f(cfg.total_steps * (1 - cfg.decay_frac))
        t = np.clip((s - decay_start)
                    / np.maximum(f(cfg.total_steps) - decay_start, f(1)),
                    f(0), f(1))
        stable = f(1.0) - f(1 - cfg.min_lr_frac) * t
        return float(f(cfg.lr) * warm * stable)
    raise ValueError(cfg.schedule)


def is_trainable(cfg: OptimizerConfig, path) -> bool:
    if cfg.trainable is None:
        return True
    if cfg.trainable != "lora":
        raise ValueError(f"unknown trainable subset {cfg.trainable!r}")
    return any("lora" in str(k) for k in path)


def _trainable_mask(cfg: OptimizerConfig, params: Params) -> Params:
    return _map(lambda path, _: is_trainable(cfg, path), params)


def _decays(path, leaf) -> bool:
    """Weight decay on matrices only. The reference decides on its stacked
    layout, where every per-layer leaf has one more dimension."""
    ndim = leaf.dim() + (1 if path[0] == "layers" else 0)
    name = str(path[-1])
    return ndim >= 2 and "scale" not in name and "bias" not in name


def _decay_mask(params: Params) -> Params:
    return _map(_decays, params)


def init_opt_state(cfg: OptimizerConfig, params: Params) -> OptState:
    def zeros(path, p):
        if is_trainable(cfg, path):
            return torch.zeros_like(p, dtype=torch.float32)
        return torch.zeros((), dtype=torch.float32, device=p.device)

    def master(path, p):
        if is_trainable(cfg, path):
            return p.detach().to(torch.float32, copy=True)
        return torch.zeros((), dtype=torch.float32, device=p.device)

    mu = _map(zeros, params)
    return OptState(step=torch.zeros((), dtype=torch.int32),
                    mu=mu, nu=_map(lambda _, t: t.clone(), mu),
                    master=_map(master, params) if cfg.master_fp32 else None)


def global_norm(tree: Params, extra_sq: Optional[torch.Tensor] = None):
    """sqrt of the sum of squares of every leaf in fp32 (leaves that are
    None skipped), plus ``extra_sq``, squared norms already summed."""
    sq = [torch.sum(torch.square(g.float())) for _, g in named_leaves(tree)
          if g is not None]
    if extra_sq is not None:
        sq.append(extra_sq)
    return torch.sqrt(torch.stack(sq).sum())


def adamw_update(cfg: OptimizerConfig, grads: Params, state: OptState,
                 params: Params, *,
                 extra_sq_norm: Optional[torch.Tensor] = None
                 ) -> Tuple[Params, OptState, Dict[str, Any]]:
    """Returns ``(new_params, new_state, stats)``; nothing is updated in
    place. A frozen leaf keeps its tensor object. ``grads`` mirrors
    ``params``; a frozen leaf's gradient may be None when its squared norm
    is in ``extra_sq_norm`` instead (the train step frees frozen gradients
    as they are produced)."""
    gnorm = global_norm(grads, extra_sq_norm)
    clip = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
            if cfg.grad_clip > 0 else 1.0)
    step = int(state.step) + 1
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.betas
    f = np.float32
    c1 = float(f(1) - f(b1) ** f(step))
    c2 = float(f(1) - f(b2) ** f(step))
    masters = state.master if state.master is not None else params

    def upd(path, g, mu, nu, p, master, m, dm):
        if not m:
            return p, mu, nu, master
        if g is None:
            raise ValueError(f"no gradient for trainable leaf {path}")
        g = g.float() * clip
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * torch.square(g)
        u = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
        base = master if cfg.master_fp32 else p.float()
        if dm:
            u = u + cfg.weight_decay * base
        new_master = base - lr * u
        return new_master.to(p.dtype), mu, nu, new_master

    out = _map(upd, grads, state.mu, state.nu, params, masters,
               _trainable_mask(cfg, params), _decay_mask(params))
    pick = lambda i: _map(lambda _, t: t[i], out)
    new_state = OptState(torch.tensor(step, dtype=torch.int32), pick(1),
                         pick(2), pick(3) if cfg.master_fp32 else None)
    return pick(0), new_state, {"grad_norm": gnorm, "lr": lr}


__all__ = ["OptimizerConfig", "OptState", "schedule_lr", "is_trainable",
           "init_opt_state", "global_norm", "adamw_update"]
