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

The kernel's work is cut by ``bag_plan``: a warp owns a bag (with few
bags, a block of warps shares each); ``vec``-byte loads, ``lanes_per_row``
lanes a row, several rows a warp step, ``steps`` steps of rows in flight,
warps per block chosen to fill the card. The C entry points derive the
same plan and refuse one that differs.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import as_i32, check_launch, load, ptr, sm_count

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"embedding_bag_fwd": [_P] * 4 + [_I] * 11 + [_P],
             "embedding_bag_q8_fwd": [_P] * 5 + [_I] * 10 + [_P]}
MAX_VEC = 16        # bytes a lane loads at once, at most
STEPS = 8           # most warp steps of rows in flight (STEPS in the .cu)
MAX_WARPS = 8       # warps (bags) per block (MAX_WARPS there)
BLOCKS_PER_SM = 2   # the grid's aim where the bags allow it
SPLIT_WARPS_PER_SM = 16  # with fewer bags than this, split each over warps


class BagPlan(NamedTuple):
    """How one call's work is cut. A lane loads ``vec`` bytes of a row;
    ``lanes_per_row`` lanes (a group) cover ``col_chunks`` equal column
    chunks of it, one per grid row; a warp step loads ``rows_per_step``
    slots' rows, one per group; a round holds ``steps`` steps, whose rows
    are all in flight before any is summed. With ``split`` 1 a warp owns a
    bag, ``warps`` bags a block; else a block of ``warps = split`` warps
    owns a bag, warp k taking rounds k, k + split, ... and the warps' sums
    added in order. ``blocks`` blocks a column chunk. ``align`` is the
    table pointer's alignment in bytes (up to 16)."""
    vec: int
    lanes_per_row: int
    rows_per_step: int
    steps: int
    col_chunks: int
    split: int
    warps: int
    blocks: int
    align: int


def bag_plan(b: int, h: int, d: int, esize: int, addr: int,
             n_sm: int) -> BagPlan:
    """The plan for ``b`` bags of ``h`` slots over a (V, ``d``) table of
    ``esize``-byte values at device address ``addr``, as
    ``csrc/embedding_bag.cu`` makes it: the widest vector that divides
    both the row's bytes and the pointer's alignment; the fewest column
    chunks of at most 32 lanes, balanced; up to ``STEPS`` steps a round
    and at most 32 slots; each bag split over the most warps (up to
    ``MAX_WARPS``, at most one a round) that keep the warps under
    ``SPLIT_WARPS_PER_SM * n_sm``; unsplit, the most warps a block that
    still leave ``BLOCKS_PER_SM * n_sm`` blocks."""
    align = MAX_VEC
    while align > 1 and addr % align:
        align //= 2
    row = d * esize
    vec = MAX_VEC
    while vec > 1 and (row % vec or align % vec):
        vec //= 2
    lanes = row // vec
    col_chunks = -(-lanes // 32)
    lanes_per_row = -(-lanes // col_chunks)
    rows_per_step = 32 // lanes_per_row
    steps = min(STEPS, 32 // rows_per_step)
    rounds = -(-h // (rows_per_step * steps))
    split = 1
    while (2 * split <= min(MAX_WARPS, rounds)
           and b * col_chunks * 2 * split <= SPLIT_WARPS_PER_SM * n_sm):
        split *= 2
    if split > 1:
        return BagPlan(vec, lanes_per_row, rows_per_step, steps, col_chunks,
                       split, split, b, align)
    warps = MAX_WARPS
    while warps > 1 and -(-b // warps) * col_chunks < BLOCKS_PER_SM * n_sm:
        warps //= 2
    return BagPlan(vec, lanes_per_row, rows_per_step, steps, col_chunks, 1,
                   warps, -(-b // warps), align)


def lane_columns(plan: BagPlan, d: int, esize: int, chunk: int,
                 lane: int) -> Tuple[int, range]:
    """The group (slot of a step) of ``lane`` in column chunk ``chunk`` and
    the columns it loads and sums, as the kernel computes them; groups
    past ``rows_per_step`` and lanes past the row's end load nothing."""
    per = plan.vec // esize
    g = lane // plan.lanes_per_row
    col = (chunk * plan.lanes_per_row + lane - g * plan.lanes_per_row) * per
    if g >= plan.rows_per_step or col >= d:
        return g, range(0)
    return g, range(col, col + per)


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
    plan = bag_plan(b, h, d, table.element_size(), table.data_ptr(),
                    sm_count(table.device))
    args = (plan.vec, plan.lanes_per_row, plan.steps, plan.split, plan.warps,
            plan.align)
    lib = load("embedding_bag", _ARGTYPES)
    if quant:
        scale = table_scale.float().contiguous()
        rc = lib.embedding_bag_q8_fwd(ptr(table), ptr(scale), ptr(ids32),
                                      ptr(w32), ptr(out), b, h, v, d, *args,
                                      stream)
        check_launch("embedding_bag_q8", rc)
    else:
        rc = lib.embedding_bag_fwd(ptr(table), ptr(ids32), ptr(w32),
                                   ptr(out), b, h, v, d,
                                   int(table.dtype == torch.bfloat16), *args,
                                   stream)
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


__all__ = ["BagPlan", "bag_plan", "bag_weights", "embedding_bag",
           "embedding_bag_plain", "lane_columns"]
