"""The host side of kernels 2 and 3: ``windowed_bwd_plan``, ``kv_band``,
``q_band`` and ``sum_tiles`` (pure Python, as
``csrc/windowed_attn_bwd.cu`` computes them). Every pair the DTI mask
lets attend is visited by exactly one dq CTA and, per query head, by
exactly one (dk/dv CTA, q tile) of phase A; phase B revisits exactly the
band's q tiles that hold a [SUM] row, so every [SUM] row's pairs once;
the grids cover every query and key once; shared memory and registers fit
the card with the CTAs per SM the plan states. Fixed inputs only."""
import numpy as np
import pytest
import torch

from repro_torch.core.windowed import dti_mask
from repro_torch.kernels.windowed_attn import (BAND_TABLE, BLOCK_K,
                                               BWD_Q_TILE, MAX_HEAD_DIM,
                                               MAX_QK_DIM, PLANE_LD,
                                               SMEM_LIMIT, WARPS,
                                               WG_CONSUMER_REGS,
                                               WG_LAUNCH_REGS,
                                               WG_PRODUCER_REGS, dkv_block,
                                               dq_block, kv_band, q_band,
                                               sum_tiles, windowed_bwd_plan)

SM_SMEM = 233472         # bytes of shared memory an H100 SM holds (228 KB)
CTA_RESERVED = 1024      # bytes the card reserves for each resident CTA
SM_REGS = 65536          # 32-bit registers of an SM
THREAD_REGS = 255        # the most a thread may take
FLAGS = [(False, False), (True, False), (False, True), (True, True)]


def _rows(S, packed, sums):
    """Positions, segments, valid flags and [SUM] flags of one row of S
    slots: one prompt and a padded tail, or three packed prompts
    (positions restart at each) and a padded tail. [SUM] rows: ``tail``,
    20 every 7 slots before the padding (DTI streaming rows); ``spread``,
    every 37th slot; ``none``."""
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
    if sums == "tail":
        is_sum[np.maximum(S - pad - 1 - 7 * np.arange(20), 0)] = True
    elif sums == "spread":
        is_sum[np.arange(S) % 37 == 36] = True
    return pos, seg, valid, is_sum & valid


@pytest.mark.parametrize("sums", ["tail", "spread", "none"])
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("window", [40, 100, 1024])
@pytest.mark.parametrize("S", [150, 190, 2048])
def test_every_attendable_pair_is_visited_once(S, window, packed, bf16,
                                               sums):
    _visit_once(S, window, packed, bf16, sums, d=MAX_HEAD_DIM)


@pytest.mark.parametrize("sums", ["tail", "spread"])
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("window", [100, 1024])
@pytest.mark.parametrize("S", [190, 333, 2048])
def test_every_attendable_pair_is_visited_once_at_dqk_192(S, window, packed,
                                                          bf16, sums):
    """The wide class's plans (bf16: CTAs of two warpgroups, 128 query
    rows or keys, S = 190 and 333 ragged against them; fp32: dq CTAs of
    32 query rows) visit every attendable pair once too."""
    _visit_once(S, window, packed, bf16, sums, d=MAX_QK_DIM)


def _visit_once(S, window, packed, bf16, sums, d):
    dq, dkv = windowed_bwd_plan(1, S, 1, 1, bf16=bf16, use_nope=True,
                                use_reset=True, d=d)
    pos, seg, valid, is_sum = _rows(S, packed, sums)
    t = torch.from_numpy
    mask = dti_mask(t(pos), t(pos), window=window, is_sum_k=t(is_sum),
                    valid_k=t(valid), seg_q=t(seg), seg_k=t(seg)).numpy()
    assert mask.any()
    # dq: each CTA's q tile against its kv band
    seen = np.zeros((S, S), np.int16)
    for y in range(dq.grid[1]):
        _, _, q0 = dq_block(dq, 0, y, 0)
        lo, hi = kv_band(q0, S, window, dq.block_rows, dq.block_cols)
        assert lo % dq.block_cols == 0 and lo < hi <= S
        seen[q0:q0 + dq.block_rows, lo:hi] += 1
    assert (seen[mask] == 1).all()
    # dk/dv: each CTA's keys against the q tiles of its transposed band in
    # phase A, and against phase B's tiles
    seen_a = np.zeros((S, S), np.int16)
    seen_b = np.zeros((S, S), np.int16)
    for x in range(dkv.grid[0]):
        _, _, k0 = dkv_block(dkv, x, 0, 0)
        keys = slice(k0, k0 + dkv.block_rows)
        lo, hi = q_band(k0, S, window, dkv.block_rows, dkv.block_cols)
        assert lo % dkv.block_cols == 0 and lo <= k0 < hi <= S
        tiles = list(range(lo, hi, dkv.block_cols))
        for q0 in tiles:
            seen_a[q0:q0 + dkv.block_cols, keys] += 1
        revisit = sum_tiles(is_sum, k0, S, window, dkv.block_rows,
                            dkv.block_cols)
        assert revisit == [q0 for q0 in tiles
                           if is_sum[q0:q0 + dkv.block_cols].any()]
        for q0 in revisit:
            seen_b[q0:q0 + dkv.block_cols, keys] += 1
    assert (seen_a[mask] == 1).all()
    sum_pairs = mask & is_sum[:, None]
    assert (seen_b[sum_pairs] == 1).all()


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("B,S,H,Hk", [(2, 150, 4, 2), (3, 190, 8, 8),
                                      (1, 2048, 4, 1), (2, 1, 3, 3),
                                      (1, 129, 2, 1), (2, 65, 8, 2)])
def test_grids_cover_every_query_and_key_once(B, S, H, Hk, bf16):
    _cover_once(B, S, H, Hk, bf16, d=MAX_HEAD_DIM)


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("B,S,H,Hk", [(2, 150, 4, 2), (1, 2048, 4, 4),
                                      (2, 1, 3, 3), (2, 65, 8, 2),
                                      (1, 129, 2, 1), (3, 257, 4, 2)])
def test_grids_cover_every_query_and_key_once_at_dqk_192(B, S, H, Hk, bf16):
    _cover_once(B, S, H, Hk, bf16, d=MAX_QK_DIM)


def _cover_once(B, S, H, Hk, bf16, d):
    dq, dkv = windowed_bwd_plan(B, S, H, Hk, bf16=bf16, use_nope=False,
                                use_reset=False, d=d)
    assert dq.grid[0] == H and dq.grid[2] == B
    assert dkv.grid[1] == Hk and dkv.grid[2] == B
    hits = np.zeros((B, H, S), np.int64)
    for x in range(dq.grid[0]):
        for y in range(dq.grid[1]):
            for z in range(dq.grid[2]):
                b, h, q0 = dq_block(dq, x, y, z)
                assert 0 <= q0 < S
                hits[b, h, q0:q0 + dq.block_rows] += 1
    assert (hits == 1).all()
    hits = np.zeros((B, Hk, S), np.int64)
    for x in range(dkv.grid[0]):
        for y in range(dkv.grid[1]):
            for z in range(dkv.grid[2]):
                b, hk, k0 = dkv_block(dkv, x, y, z)
                assert 0 <= k0 < S
                hits[b, hk, k0:k0 + dkv.block_rows] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("use_nope,use_reset", FLAGS)
def test_shared_memory_and_registers_fit_the_card(use_nope, use_reset,
                                                  bf16):
    """Planes are padded to MAX_HEAD_DIM, so the plans do not depend on
    the head dims up to it. Every flag fits one CTA's 227 KB; the CTAs an
    SM holds by the plan fit its shared memory and, at 255 registers a
    thread, its registers: two (8 warps) in bf16."""
    for plan in windowed_bwd_plan(8, 2048, 32, 8, bf16=bf16,
                                  use_nope=use_nope, use_reset=use_reset):
        assert plan.block_rows == 16 * plan.warps
        assert plan.smem_bytes <= SMEM_LIMIT
        assert plan.stages * plan.stage_bytes < plan.smem_bytes
        assert plan.ctas_per_sm * (plan.smem_bytes + CTA_RESERVED) <= SM_SMEM
        assert plan.ctas_per_sm * 32 * plan.warps * THREAD_REGS <= SM_REGS
        if bf16:
            assert plan.ctas_per_sm == 2 and plan.stages >= 2
            assert plan.warps == WARPS and plan.terms == (1, 2)
        else:
            assert plan.ctas_per_sm == 1 and plan.stages == 1
            assert plan.terms == (3, 3)


@pytest.mark.parametrize("B,S,H,Hk", [(8, 2048, 128, 128), (2, 190, 8, 2)])
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("use_nope,use_reset", FLAGS)
def test_wide_plans_fit_the_card(use_nope, use_reset, bf16, B, S, H, Hk):
    """The Dqk-192 class (``DQ = 192`` in the source): every flag fits one
    CTA's 227 KB and runs one CTA per SM, whose shared memory and
    registers (255 a thread) fit the SM. bf16 runs on ``wgmma``: CTAs of
    two consumer warpgroups (8 warps, 128 query rows or keys) and a
    producer warpgroup (4 warps), planes of core matrices 192 (q, K,
    q_nope, K_nope) and 128 (V, V0, dO) values wide without padding, three
    stages, the gradients in registers; the registers setmaxnreg gives
    the consumers and takes from the producer fit the CTA's pool at
    launch (384 threads at 168). fp32 keeps
    ``mma.sync``: planes 200 and 136 values wide, 32 floats a thread of
    gradient columns past 128 in shared memory, and a dq pass of 2 warps
    (32 query rows): at 4 warps Q and dO and a stage of K, K_nope, V and
    V0 in three terms would pass 227 KB."""
    dq, dkv = windowed_bwd_plan(B, S, H, Hk, bf16=bf16, use_nope=use_nope,
                                use_reset=use_reset, d=MAX_QK_DIM)
    for plan in (dq, dkv):
        assert plan.block_rows == 16 * plan.warps
        assert plan.smem_bytes <= SMEM_LIMIT
        assert plan.stages * plan.stage_bytes < plan.smem_bytes
        assert plan.ctas_per_sm == 1
        assert plan.smem_bytes + CTA_RESERVED <= SM_SMEM
        assert 32 * plan.warps * THREAD_REGS <= SM_REGS
        assert plan.terms == ((1, 2) if bf16 else (3, 3))
        assert plan.warpgroups == (2 if bf16 else 0)
        assert plan.producer_warps == (4 if bf16 else 0)
    assert dq.grid == (H, -(-S // dq.block_rows), B)
    assert dkv.grid == (-(-S // dkv.block_rows), Hk, B)
    nt = dq.terms[0]
    kpl, vpl = nt * (1 + use_nope), nt * (1 + use_reset)
    if bf16:
        assert (dq.warps, dq.block_rows, dq.stages) == (8, 128, 3)
        assert (dkv.warps, dkv.block_rows, dkv.stages) == (8, 128, 3)
        assert dq.producer_warps == dkv.producer_warps == 4
        assert dq.stage_bytes == BLOCK_K * 2 * (kpl * 192 + vpl * 128)
        assert dkv.stage_bytes == BWD_Q_TILE * 2 * (192 + 128)
        threads = 32 * (dq.warps + dq.producer_warps)
        assert threads * WG_LAUNCH_REGS <= SM_REGS
        assert WG_LAUNCH_REGS == SM_REGS // threads // 8 * 8
        assert (32 * dq.warps * WG_CONSUMER_REGS
                + 32 * dq.producer_warps * WG_PRODUCER_REGS
                <= threads * WG_LAUNCH_REGS)
        return
    assert (dq.warps, dq.block_rows) == (2, 32)
    assert dkv.warps == 2
    assert dq.stage_bytes == BLOCK_K * 2 * (kpl * 200 + vpl * PLANE_LD)
    assert dkv.stage_bytes == BWD_Q_TILE * 2 * nt * (200 + PLANE_LD)
    # the 4-warp fp32 dq CTA this plan avoids
    if use_nope:
        four = (nt * 64 * (200 + PLANE_LD) * 2 + dq.stage_bytes
                + (2 * 4 * BLOCK_K + 5 * 64 + 8 + 2 + 32 * 128) * 4)
        assert four > SMEM_LIMIT


def test_wide_plans_at_deepseek_training_shape():
    """deepseek-v2's train step (B=8, S=2048, H = Hk = 128, NoPE + reset):
    in bf16 dq CTAs of 128 query rows and dk/dv CTAs of 128 keys, 16 per
    (head, row), three stages each: ~204 KB (Q and dO 80 KB, stages of K,
    K_nope, V and V0 40 KB) and ~224 KB (the keys' four planes 160 KB,
    stages of Q and dO 20 KB); fp32's dq CTA of 2 warps ~203 KB."""
    dq, dkv = windowed_bwd_plan(8, 2048, 128, 128, bf16=True, use_nope=True,
                                use_reset=True, d=192)
    assert (dq.grid, dkv.grid) == ((128, 16, 8), (16, 128, 8))
    assert dq.stages == dkv.stages == 3
    assert dq.warpgroups == dkv.warpgroups == 2
    assert dq.producer_warps == dkv.producer_warps == 4
    assert (dq.smem_bytes, dkv.smem_bytes) == (209064, 229856)
    dq32, dkv32 = windowed_bwd_plan(8, 2048, 128, 128, bf16=False,
                                    use_nope=True, use_reset=True, d=192)
    assert (dq32.grid, dkv32.grid) == ((128, 64, 8), (64, 128, 8))
    assert (dq32.smem_bytes, dkv32.smem_bytes) == (203416, 203852)


@pytest.mark.parametrize("d", [8, 64, 96, 127, 128])
def test_narrow_plans_do_not_depend_on_the_head_dim(d):
    """Head dims up to 128 take the 128 class's plans, as before the wide
    class existed."""
    for bf16 in (True, False):
        for nope, reset in FLAGS:
            kw = dict(bf16=bf16, use_nope=nope, use_reset=reset)
            assert windowed_bwd_plan(8, 2048, 32, 8, d=d, **kw) == \
                windowed_bwd_plan(8, 2048, 32, 8, **kw)
    with pytest.raises(ValueError, match="exceeds"):
        windowed_bwd_plan(1, 64, 1, 1, bf16=True, use_nope=False,
                          use_reset=False, d=MAX_QK_DIM + 8)


def test_plans_at_the_training_shape():
    """dti-llama's train step (B=8, S=2048, H=32, Hk=8, NoPE + reset,
    bf16): dq CTAs of 64 query rows over kv tiles of 32 keys, 32 per
    (head, row); dk/dv CTAs of 64 keys over q tiles of 32 rows, 32 per
    (kv head, row); two stages each. A [SUM] tail of 20 rows every 7 slots
    makes phase B revisit 5 tiles of a band that holds the tail, 2 of the
    last CTA's and none of the first's."""
    dq, dkv = windowed_bwd_plan(8, 2048, 32, 8, bf16=True, use_nope=True,
                                use_reset=True)
    assert (dq.block_rows, dq.block_cols, dq.grid) == (64, BLOCK_K,
                                                       (32, 32, 8))
    assert (dkv.block_rows, dkv.block_cols, dkv.grid) == (64, BWD_Q_TILE,
                                                          (32, 8, 8))
    assert dq.stages == dkv.stages == 2
    assert dq.stage_bytes == 4 * BLOCK_K * (MAX_HEAD_DIM + 8) * 2
    assert q_band(0, 2048, 1024, 64) == (0, 1088)
    assert q_band(1984, 2048, 1024, 64) == (1984, 2048)
    _, _, _, is_sum = _rows(2048, False, "tail")
    assert sum_tiles(is_sum, 0, 2048, 1024, 64) == []
    assert sum_tiles(is_sum, 1984, 2048, 1024, 64) == [1984, 2016]
    assert sum_tiles(is_sum, 1024, 2048, 1024, 64) == [1888, 1920, 1952,
                                                       1984, 2016]


def test_a_band_longer_than_the_table_revisits_every_tile():
    """Phase B's table holds BAND_TABLE q tiles; a longer band (a window
    of more than BAND_TABLE tiles) revisits every tile of it, [SUM] row or
    not."""
    S, window = 12000, 9000
    lo, hi = q_band(0, S, window, 64)
    n = -(-(hi - lo) // BWD_Q_TILE)
    assert n > BAND_TABLE
    assert sum_tiles(np.zeros(S, bool), 0, S, window, 64) == \
        list(range(lo, hi, BWD_Q_TILE))
    assert sum_tiles(np.zeros(S, bool), 0, S, 100, 64) == []
