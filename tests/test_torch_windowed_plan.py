"""The host side of kernel 1's design, ``windowed_tile_plan`` and
``kv_band`` (pure Python, as ``csrc/windowed_attn.cu`` computes them): the
band of kv tiles each q tile walks holds every pair the DTI mask lets
attend, the grid covers every (batch row, head, query) once, and the
shared memory fits the card. Fixed inputs only."""
import numpy as np
import pytest
import torch

from repro_torch.core.windowed import dti_mask
from repro_torch.kernels.windowed_attn import (BLOCK_K, MAX_HEAD_DIM,
                                               SMEM_LIMIT, WARPS, kv_band,
                                               tile_of_block,
                                               windowed_tile_plan)

SM_SMEM = 233472         # bytes of shared memory an H100 SM holds (228 KB)
CTA_RESERVED = 1024      # bytes the card reserves for each resident CTA
# (bf16, use_reset): the kernel's q tiles are 128 rows in bf16 without the
# reset stream, 64 otherwise
KINDS = [(True, False), (True, True), (False, False)]


def _rows(S, packed):
    """Positions, segments and valid flags of one row of S slots: one
    prompt and a padded tail, or three packed prompts (positions restart
    at each) and a padded tail."""
    pad = 7
    cuts = [S - pad] if not packed else [S // 5, S // 2, S - pad]
    pos = np.zeros(S, np.int64)
    seg = np.full(S, -1, np.int64)
    lo = 0
    for i, hi in enumerate(cuts):
        pos[lo:hi] = np.arange(hi - lo)
        seg[lo:hi] = i
        lo = hi
    valid = seg >= 0
    is_sum = np.zeros(S, bool)
    is_sum[np.arange(S) % 37 == 36] = True
    return pos, seg, valid, is_sum & valid


@pytest.mark.parametrize("bf16,use_reset", KINDS)
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("window", [40, 64, 100, 1024])
@pytest.mark.parametrize("S", [150, 190, 2048])
def test_every_attendable_pair_lies_in_its_q_tiles_band(S, window, packed,
                                                        bf16, use_reset):
    plan = windowed_tile_plan(1, S, 1, bf16=bf16, use_nope=True,
                              use_reset=use_reset)
    pos, seg, valid, is_sum = (torch.from_numpy(x) for x in
                               _rows(S, packed))
    mask = dti_mask(pos, pos, window=window, is_sum_k=is_sum,
                    valid_k=valid, seg_q=seg, seg_k=seg).numpy()
    assert mask.any()
    lo = np.empty(S, np.int64)
    hi = np.empty(S, np.int64)
    for q0 in range(0, S, plan.block_q):
        band = kv_band(q0, S, window, plan.block_q)
        assert band[0] % BLOCK_K == 0 and band[0] < band[1] <= S
        lo[q0:q0 + plan.block_q], hi[q0:q0 + plan.block_q] = band
    keys = np.arange(S)[None, :]
    outside = (keys < lo[:, None]) | (keys >= hi[:, None])
    assert not (mask & outside).any()


@pytest.mark.parametrize("bf16,use_reset", KINDS)
@pytest.mark.parametrize("B,S,H", [(2, 150, 4), (3, 190, 8), (1, 2048, 2),
                                   (2, 1, 3), (1, 129, 1)])
def test_grid_covers_every_row_head_and_query_once(B, S, H, bf16,
                                                   use_reset):
    plan = windowed_tile_plan(B, S, H, bf16=bf16, use_nope=False,
                              use_reset=use_reset)
    assert plan.grid[0] == H and plan.grid[2] == B
    hits = np.zeros((B, H, S), np.int64)
    for x in range(plan.grid[0]):
        for y in range(plan.grid[1]):
            for z in range(plan.grid[2]):
                b, h, q0 = tile_of_block(plan, x, y, z)
                assert 0 <= q0 < S
                hits[b, h, q0:q0 + plan.block_q] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("use_nope,use_reset", [(False, False),
                                                (True, False),
                                                (False, True),
                                                (True, True)])
@pytest.mark.parametrize("D,Dv", [(64, 64), (96, 64), (128, 96),
                                  (64, 128), (128, 128), (96, 96)])
def test_shared_memory_fits_the_card(D, Dv, use_nope, use_reset, bf16):
    """Planes are padded to MAX_HEAD_DIM, so the plan does not depend on
    the head dims up to it: every flag fits one CTA's 227 KB, and bf16
    leaves room for two CTAs (8 warps) on an SM."""
    assert max(D, Dv) <= MAX_HEAD_DIM
    plan = windowed_tile_plan(8, 2048, 32, bf16=bf16, use_nope=use_nope,
                              use_reset=use_reset)
    assert plan.warps == WARPS and plan.block_k == BLOCK_K
    assert plan.block_q % (16 * plan.warps) == 0
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.stages * plan.stage_bytes < plan.smem_bytes
    if bf16:
        assert 2 * (plan.smem_bytes + CTA_RESERVED) <= SM_SMEM
        assert plan.stages >= 2 and plan.terms == (1, 1, 2, 1)
    else:
        assert plan.stages == 1 and plan.terms == (3, 3, 3, 3)


def test_plan_at_the_prefill_shape():
    """dti-llama prefill (B=8, S=2048, H=32, NoPE, no reset, bf16): q tiles
    of 128 rows, 16 per (row, head), two stages of K, K_nope and V."""
    plan = windowed_tile_plan(8, 2048, 32, bf16=True, use_nope=True,
                              use_reset=False)
    assert plan.block_q == 128 and plan.grid == (32, 16, 8)
    assert plan.stages == 2 and plan.stage_bytes == 3 * 32 * 136 * 2
    assert kv_band(1024, 2048, 1024, 128) == (0, 1152)
    assert kv_band(1920, 2048, 1024, 128) == (896, 2048)
