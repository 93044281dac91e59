"""The host side of kernel 1's design, ``windowed_tile_plan`` and
``kv_band`` (pure Python, as ``csrc/windowed_attn.cu`` computes them): the
band of kv tiles each q tile walks holds every pair the DTI mask lets
attend, the grid covers every (batch row, head, query) once, and the
shared memory fits the card; for the bf16 Dqk-192 class on ``wgmma``
also the registers, and every attendable pair lies in exactly one kv
tile that its warpgroup does not skip. Fixed inputs only."""
import numpy as np
import pytest
import torch

from repro_torch.core.windowed import dti_mask
from repro_torch.kernels.windowed_attn import (BLOCK_K, FWD_BLOCK_K,
                                               FWD_MAX_STAGES, MAX_HEAD_DIM,
                                               MAX_QK_DIM, SMEM_LIMIT, WARPS,
                                               WG_CONSUMER_REGS,
                                               WG_LAUNCH_REGS,
                                               WG_PRODUCER_REGS, kv_band,
                                               tile_of_block,
                                               windowed_tile_plan)

SM_SMEM = 233472         # bytes of shared memory an H100 SM holds (228 KB)
CTA_RESERVED = 1024      # bytes the card reserves for each resident CTA
SM_REGS = 65536          # 32-bit registers of an SM
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


# the bf16 Dqk-192 class (``WgCfg`` in the source): its flag sets
FLAGS = [(False, False), (True, False), (False, True), (True, True)]


def _wide(B, S, H, use_nope=True, use_reset=False):
    return windowed_tile_plan(B, S, H, bf16=True, use_nope=use_nope,
                              use_reset=use_reset, d=MAX_QK_DIM)


def _warpgroup_live(pos, seg, valid, is_sum, rows, keys, window):
    """Whether a consumer warpgroup of the wgmma class computes a kv tile,
    as its warps decide it from the staged metadata: some key of ``keys``
    is valid, within [least row position - window, greatest row
    position], an isolated [SUM] key no earlier than the least row
    position, and of a segment between the rows' least and greatest."""
    lo, hi = pos[rows].min(), pos[rows].max()
    slo, shi = seg[rows].min(), seg[rows].max()
    pk, sk = pos[keys], seg[keys]
    live = valid[keys] & (pk <= hi) & (pk >= lo - window)
    live &= ~is_sum[keys] | (pk >= lo)
    live &= (sk >= slo) & (sk <= shi)
    return bool(live.any())


@pytest.mark.parametrize("use_nope,use_reset", FLAGS)
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("window", [40, 64, 100, 1024])
@pytest.mark.parametrize("S", [150, 200, 2048])
def test_wide_plan_visits_every_attendable_pair_once(S, window, packed,
                                                     use_nope, use_reset):
    """The wgmma class's q tiles of 128 rows walk kv tiles of 64 keys:
    the tiles of a q tile's band partition it, every attendable pair lies
    in the band, so in exactly one of its tiles, and the warpgroup of 64
    rows that holds the query does not skip that tile."""
    plan = _wide(1, S, 1, use_nope, use_reset)
    assert (plan.block_q, plan.block_k) == (128, FWD_BLOCK_K)
    pos, seg, valid, is_sum = _rows(S, packed)
    mask = dti_mask(*(torch.from_numpy(x) for x in (pos, pos)),
                    window=window, is_sum_k=torch.from_numpy(is_sum),
                    valid_k=torch.from_numpy(valid),
                    seg_q=torch.from_numpy(seg),
                    seg_k=torch.from_numpy(seg)).numpy()
    assert mask.any()
    seen = np.zeros_like(mask, dtype=np.int64)
    for q0 in range(0, S, plan.block_q):
        lo, hi = kv_band(q0, S, window, plan.block_q, plan.block_k)
        assert lo % plan.block_k == 0 and lo < hi <= S
        for w0 in range(q0, min(q0 + plan.block_q, S), 64):
            rows = np.arange(w0, min(w0 + 64, S))
            for k0 in range(lo, hi, plan.block_k):
                keys = np.arange(k0, min(k0 + plan.block_k, S))
                if _warpgroup_live(pos, seg, valid, is_sum, rows, keys,
                                   window):
                    seen[rows[:, None], keys[None, :]] += 1
    assert (seen[mask] == 1).all()
    assert (seen <= 1).all()


@pytest.mark.parametrize("B,S,H", [(2, 150, 4), (3, 200, 8), (1, 2048, 2),
                                   (2, 1, 3), (1, 129, 1), (8, 2048, 128)])
def test_wide_plan_grid_covers_every_row_head_and_query_once(B, S, H):
    """The wgmma class's grid is (q tiles, H, B), q tiles innermost and
    last first: every (batch row, head, query) once."""
    plan = _wide(B, S, H)
    assert plan.grid == (-(-S // 128), H, B)
    hits = np.zeros((B, H, S), np.int64)
    for x in range(plan.grid[0]):
        for y in range(plan.grid[1]):
            for z in range(plan.grid[2]):
                b, h, q0 = tile_of_block(plan, x, y, z)
                assert 0 <= q0 < S
                hits[b, h, q0:q0 + plan.block_q] += 1
    assert (hits == 1).all()
    assert tile_of_block(plan, 0, 0, 0)[2] == (plan.grid[0] - 1) * 128


@pytest.mark.parametrize("use_nope,use_reset", FLAGS)
@pytest.mark.parametrize("d", [136, 160, MAX_QK_DIM])
def test_wide_plan_fits_the_card(use_nope, use_reset, d):
    """One CTA per SM: two consumer warpgroups (8 warps, 128 query rows)
    and a producer warpgroup (4 warps); Q 128 x 192, a K ring and a V
    ring of four stages, or two where K_nope beside K (V0 beside V) fills
    the same bytes, within 227 KB and the SM's 228 KB; the registers
    setmaxnreg gives the consumers and takes from the producer fit the
    CTA's pool at launch (384 threads at 168). Head dims past 128 share
    the plan."""
    plan = _wide(8, 2048, 128, use_nope, use_reset)
    assert windowed_tile_plan(8, 2048, 128, bf16=True, use_nope=use_nope,
                              use_reset=use_reset, d=d) == plan
    assert (plan.warps, plan.warpgroups, plan.producer_warps) == (8, 2, 4)
    assert plan.terms == (1, 1, 2, 1)
    kv = FWD_BLOCK_K * 2 * (MAX_QK_DIM + MAX_HEAD_DIM)
    assert plan.stage_bytes == FWD_BLOCK_K * 2 * (
        (1 + use_nope) * MAX_QK_DIM + (1 + use_reset) * MAX_HEAD_DIM)
    assert plan.stages == FWD_MAX_STAGES * kv // plan.stage_bytes
    assert plan.stages == (FWD_MAX_STAGES if not (use_nope or use_reset)
                           else 2)
    assert plan.stages * plan.stage_bytes <= FWD_MAX_STAGES * kv
    assert 128 * MAX_QK_DIM * 2 + FWD_MAX_STAGES * kv < plan.smem_bytes
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.smem_bytes + CTA_RESERVED <= SM_SMEM
    threads = 32 * (plan.warps + plan.producer_warps)
    assert WG_LAUNCH_REGS == SM_REGS // threads // 8 * 8
    assert (32 * plan.warps * WG_CONSUMER_REGS
            + 32 * plan.producer_warps * WG_PRODUCER_REGS
            <= threads * WG_LAUNCH_REGS <= SM_REGS)


@pytest.mark.parametrize("use_reset", [False, True])
def test_wide_plan_at_deepseek_shapes(use_reset):
    """deepseek-v2's prefill (B=8, S=2048, H=128, NoPE) and training
    (NoPE + reset) shapes: 16 q tiles of 128 rows per (head, row), 2,048
    CTAs a row, kv tiles of 64 keys, 223,992 B of shared memory (Q 48 KB,
    a K ring of 96 KB, a V ring of 64 KB); a CTA whose q tile holds a
    [SUM] row stages K and K_nope (48 KB) twice and V four times (with
    reset V and V0, 32 KB, twice), the others K (24 KB) and V (16 KB) four
    times."""
    plan = _wide(8, 2048, 128, True, use_reset)
    assert plan.grid == (16, 128, 8)
    assert plan.smem_bytes == 223992
    assert plan.stages == 2
    assert plan.stage_bytes == (81920 if use_reset else 65536)
    assert kv_band(1920, 2048, 1024, 128, FWD_BLOCK_K) == (896, 2048)
    assert kv_band(0, 2048, 1024, 128, FWD_BLOCK_K) == (0, 128)
