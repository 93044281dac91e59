"""Embedding bag (sum / mean, masked, weighted, fp32/bf16 or int8 table):
CUDA kernel wrapper and its plain version.

Replaces the Pallas TPU kernel ``repro.kernels.embedding_bag``
(``_kernel``, launched by ``embedding_bag_pallas``) and is the
counterpart of its op, ``repro.kernels.embedding_bag.ops.embedding_bag``,
with ``csrc/embedding_bag.cu``. The op folds ``valid`` into the weights,
divides them by ``max(n_valid, 1)`` for ``mean`` and clamps ids into
range (masked slots may hold anything). An fp32 or bf16 table launches
``"embedding_bag"``; int8 codes with one fp32 scale per row
(``table_scale (V,)``, ``repro_torch.core.quant.quantize_q8`` over the
row axis) launch ``"embedding_bag_q8"``, which folds ``table_scale[id]``
into each slot's weight and widens the codes itself: no dequantized table
is made. The kernel sums in fp32; the result is cast to the table's dtype
(fp32 for int8), as the reference's op casts it. Forward only: the
reference's kernel has no gradient.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import as_i32, check_launch, load, ptr

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"embedding_bag_fwd": [_P] * 4 + [_I] * 5 + [_P],
             "embedding_bag_q8_fwd": [_P] * 5 + [_I] * 4 + [_P]}


def bag_weights(ids: torch.Tensor, valid: Optional[torch.Tensor] = None, *,
                mode: str = "sum",
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (B, H) fp32 slot weights the op sums with: ``weights`` (or 1),
    times ``valid``, over ``max(n_valid, 1)`` for ``mean``."""
    b, h = ids.shape
    w = (torch.ones((b, h), dtype=torch.float32, device=ids.device)
         if weights is None else weights.float())
    if valid is not None:
        w = w * valid.float()
    if mode == "mean":
        n = (valid.sum(dim=-1, keepdim=True).float() if valid is not None
             else torch.full((b, 1), float(h), device=ids.device))
        w = w / torch.clamp(n, min=1.0)
    elif mode != "sum":
        raise ValueError(f"kernel supports sum/mean, got {mode!r}")
    return w


def embedding_bag_plain(table: torch.Tensor, ids: torch.Tensor,
                        w: torch.Tensor,
                        table_scale: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain PyTorch version of the kernel -> (B, D) fp32: ids clamped
    into range, ``table_scale[ids]`` folded into ``w`` for int8 codes,
    ``sum_j table[ids[b, j]] * w[b, j]`` in fp32."""
    ids = ids.long().clamp(0, table.shape[0] - 1)
    w = w.float()
    if table_scale is not None:
        w = w * table_scale.float()[ids]
    return (table[ids].float() * w[..., None]).sum(dim=-2)


def _launch(table, ids, w, table_scale) -> torch.Tensor:
    v, d = table.shape
    b, h = ids.shape
    quant = table_scale is not None
    if v >= 2 ** 31:
        raise ValueError(f"{v} rows: ids are int32")
    if not table.is_contiguous():
        raise ValueError("the table must be contiguous")
    if quant and (table_scale.shape != (v,)
                  or table_scale.device != table.device):
        raise ValueError(f"table_scale {tuple(table_scale.shape)} must be "
                         f"({v},) on the table's device")
    if w.shape != (b, h) or ids.device != table.device \
            or w.device != table.device:
        raise ValueError("ids and weights must be (B, H) on the table's "
                         "device")
    # int32/fp32 contiguous copies, held until the launch is enqueued
    ids32, w32 = as_i32(ids), w.float().contiguous()
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    lib = load("embedding_bag", _ARGTYPES)
    if quant:
        scale = table_scale.float().contiguous()
        rc = lib.embedding_bag_q8_fwd(ptr(table), ptr(scale), ptr(ids32),
                                      ptr(w32), ptr(out), b, h, v, d, stream)
        check_launch("embedding_bag_q8", rc)
    else:
        rc = lib.embedding_bag_fwd(ptr(table), ptr(ids32), ptr(w32),
                                   ptr(out), b, h, v, d,
                                   int(table.dtype == torch.bfloat16), stream)
        check_launch("embedding_bag", rc)
    return out


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  valid: Optional[torch.Tensor] = None, *,
                  mode: str = "sum",
                  weights: Optional[torch.Tensor] = None,
                  table_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ids (B, H) -> (B, D); masked, optionally weighted, sum or mean.

    ``table_scale (V,)`` marks ``table`` as int8 codes that dequantize as
    ``codes * table_scale[row]``; the result is then fp32."""
    if table_scale is None:
        if table.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"unsupported table dtype {table.dtype} (int8 "
                            "codes need table_scale)")
        out_dtype = table.dtype
    else:
        if table.dtype != torch.int8:
            raise TypeError("table_scale goes with an int8 table")
        out_dtype = torch.float32
    w = bag_weights(ids, valid, mode=mode, weights=weights)
    if table.device.type == "cpu":
        out = embedding_bag_plain(table, ids, w, table_scale)
    elif table.device.type == "cuda":
        out = _launch(table, ids, w, table_scale)
    else:
        raise ValueError(f"unsupported device {table.device}")
    return out.to(out_dtype)


__all__ = ["bag_weights", "embedding_bag", "embedding_bag_plain"]
