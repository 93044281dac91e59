"""Carry weights and configs between ``repro`` and the port as numpy.

JAX and torch random generators differ, so parity tests do not re-seed:
they build the reference's params, hand them over as numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)`` on the caller's side) and
convert them here. This module imports neither jax nor ``repro``.

Layouts: the reference stacks per-layer params on a leading axis
(``params["stack"]``, plus ``params["prefix"]`` for MoE models' leading
dense layers); the port keeps a list ``params["layers"]`` in layer order.
Every leaf keeps its shape otherwise: a linear ``w`` is ``(d_in, d_out)``,
LoRA ``lora_a``/``lora_b``/``lora_scale`` and rmsnorm ``scale`` as they
are, ``embed (V, d)`` and ``lm_head.w (d, V)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from repro_torch.models.transformer import ModelConfig

Tree = Dict[str, Any]

#: reference attention-impl name -> the port's
ATTN_IMPL = {"pallas": "cuda", "dense": "dense", "blocked": "blocked"}


def config_from_jax(fields: Mapping[str, Any], **overrides) -> ModelConfig:
    """Port config from a reference ``ModelConfig``'s fields
    (``dataclasses.asdict(cfg)``). Fields the port has no use for (remat,
    kernel tile sizes, chunked LM loss) are dropped; ``"pallas"`` maps to
    ``"cuda"``."""
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in fields.items() if k in names}
    kw["attn_impl"] = ATTN_IMPL[kw.get("attn_impl", "dense")]
    kw.update(overrides)
    return ModelConfig(**kw)


def _to_tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":      # ml_dtypes bf16: carry the bits
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes                # numpy's bf16 dtype, as jax uses
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _map(tree, fn):
    if isinstance(tree, Mapping):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _unstack(tree, n: int) -> List[Tree]:
    return [_map(tree, lambda x, i=i: np.asarray(x)[i]) for i in range(n)]


def _n_layers(stacked) -> int:
    leaf = stacked
    while isinstance(leaf, Mapping):
        leaf = next(iter(leaf.values()))
    return np.asarray(leaf).shape[0]


def from_jax_params(tree: Tree, cfg: ModelConfig, device) -> Tree:
    """Reference ``init_params`` tree (numpy leaves) -> port params."""
    layers: List[Tree] = []
    for group in ("prefix", "stack"):
        if group in tree:
            layers += _unstack(tree[group], _n_layers(tree[group]))
    if len(layers) != cfg.n_layers:
        raise ValueError(f"tree has {len(layers)} layers, config "
                         f"{cfg.n_layers}")
    conv = lambda x: _to_tensor(x, device)
    out = {k: _map(v, conv) for k, v in tree.items()
           if k not in ("prefix", "stack")}
    out["layers"] = [_map(lp, conv) for lp in layers]
    return out


def to_numpy_tree(params: Tree, cfg: ModelConfig) -> Tree:
    """Port params -> the reference's tree layout, numpy leaves."""
    out = {k: _map(v, _to_numpy) for k, v in params.items() if k != "layers"}
    layers = [_map(lp, _to_numpy) for lp in params["layers"]]
    n_pre = cfg.first_dense_layers if cfg.moe else 0
    if n_pre:
        out["prefix"] = _stack(layers[:n_pre])
    out["stack"] = _stack(layers[n_pre:])
    return out


def _stack(layers: List[Tree]) -> Tree:
    first = layers[0]
    if isinstance(first, Mapping):
        return {k: _stack([lp[k] for lp in layers]) for k in first}
    return np.stack(layers)


__all__ = ["ATTN_IMPL", "config_from_jax", "from_jax_params", "to_numpy_tree"]
