"""Carry weights and configs between ``repro`` and the port as numpy.

JAX and torch random generators differ, so parity tests do not re-seed:
they build the reference's params, hand them over as numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)`` on the caller's side) and
convert them here. This module imports neither jax nor ``repro``.

Layouts: the reference stacks per-layer params on a leading axis
(``params["stack"]``, plus ``params["prefix"]`` for MoE models' leading
dense layers); the port keeps a list ``params["layers"]`` in layer order.
Every leaf (GQA's ``q``/``k``/``v``/``o``, MLA's ``kv_down``, ``kv_norm``,
``kv_up``, ``k_rope``, ``q_down``, ``q_norm``, ``q_up`` or ``q``, ``o``,
their LoRA leaves) keeps its shape otherwise: a linear ``w`` is ``(d_in, d_out)``,
LoRA ``lora_a``/``lora_b``/``lora_scale`` and rmsnorm ``scale`` as they
are, ``embed (V, d)`` and ``lm_head.w (d, V)``.

Optimizer state (``step``, ``mu``, ``nu``, ``master``) converts the same
way, with one difference: the reference keeps a single fp32 zero scalar
for each frozen stacked leaf, the port one per layer. Decode caches carry
across key for key (``cache_from_jax``, ``cache_to_numpy``), and so do the
recsys models' params (``recsys_from_jax``, ``recsys_to_numpy``), nested
dicts with the same leaf shapes in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.models.transformer import ModelConfig, map_leaves
from repro_torch.train.optimizer import (OptimizerConfig, OptState,
                                         is_trainable)

Tree = Dict[str, Any]

#: reference attention-impl name -> the port's
ATTN_IMPL = {"pallas": "cuda", "dense": "dense", "blocked": "blocked"}


def config_from_jax(fields: Mapping[str, Any], **overrides) -> ModelConfig:
    """Port config from a reference ``ModelConfig``'s fields
    (``dataclasses.asdict(cfg)``). ``remat``, ``remat_policy``, the MLA
    widths and the blocked path's q chunk carry over; fields the port has
    no use for (kernel tile sizes, chunked LM loss, MoE widths) are
    dropped; ``"pallas"`` maps to ``"cuda"``."""
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


def _reference_leaf(tree: Tree, path):
    """The reference tree's leaf for a port path, and the layer index to
    take from it (None outside the layers)."""
    node, layer = tree, None
    if path[0] == "layers":
        node, layer, path = tree["stack"], path[1], path[2:]
    for k in path:
        node = node[k]
    return np.asarray(node), layer


def opt_state_from_jax(state: Mapping[str, Any], params: Tree,
                       opt_cfg: OptimizerConfig, device) -> OptState:
    """Reference ``OptState`` (as a mapping of numpy leaves:
    ``state._asdict()`` after ``tree_map(np.asarray, ...)``) -> the port's,
    laid out like the port ``params``."""
    def conv(sub):
        def leaf(path, _):
            a, layer = _reference_leaf(sub, path)
            if layer is not None and is_trainable(opt_cfg, path):
                a = a[layer]
            return _to_tensor(a, device)
        return map_leaves(leaf, params)
    master: Optional[Tree] = state.get("master")
    return OptState(torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32),
                    conv(state["mu"]), conv(state["nu"]),
                    None if master is None else conv(master))


def opt_state_to_numpy(state: OptState,
                       opt_cfg: OptimizerConfig) -> Dict[str, Any]:
    """Port ``OptState`` -> the reference's layout (a dict of ``step``,
    ``mu``, ``nu``, ``master``), numpy leaves."""
    def conv(sub):
        out = {k: _map(v, _to_numpy) for k, v in sub.items()
               if k != "layers"}
        layers = sub["layers"]

        def stacked(path, first):
            if not is_trainable(opt_cfg, ("layers", 0) + path):
                return _to_numpy(first)
            node = list(layers)
            for k in path:
                node = [n[k] for n in node]
            return np.stack([_to_numpy(t) for t in node])
        out["stack"] = map_leaves(stacked, layers[0])
        return out
    return {"step": np.asarray(int(state.step), np.int32),
            "mu": conv(state.mu), "nu": conv(state.nu),
            "master": None if state.master is None else conv(state.master)}


def cache_from_jax(cache: Mapping[str, Any], device) -> Dict[str, Any]:
    """Reference decode cache (``init_lm_cache``'s dict, numpy leaves) ->
    the port's, key for key: KV codes or values, scale sidecars, ``pos``,
    ``cursor``, ``ref`` and ``page_table`` keep their shapes and dtypes
    (both packages lay the cache out the same way)."""
    return {k: _to_tensor(v, device) for k, v in cache.items()}


def cache_to_numpy(cache: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Port decode cache -> numpy leaves, key for key (the inverse of
    ``cache_from_jax``; also takes a reference cache, as numpy)."""
    return {k: _to_numpy(v) if torch.is_tensor(v) else np.asarray(v)
            for k, v in cache.items()}


def recsys_from_jax(tree: Tree, device) -> Tree:
    """Reference ``init_recsys`` tree (numpy leaves) -> port params, leaf
    for leaf (a linear ``w`` is ``(d_in, d_out)``, CIN ``w{i}`` is ``(h,
    h_prev, m)``, the scalar ``bias`` is ``()`` in both)."""
    return _map(tree, lambda x: _to_tensor(x, device))


def recsys_to_numpy(tree: Tree) -> Tree:
    """Port recsys params -> numpy leaves (the inverse of
    ``recsys_from_jax``)."""
    return _map(tree, _to_numpy)


__all__ = ["ATTN_IMPL", "config_from_jax", "from_jax_params", "to_numpy_tree",
           "opt_state_from_jax", "opt_state_to_numpy", "cache_from_jax",
           "cache_to_numpy", "recsys_from_jax", "recsys_to_numpy"]
