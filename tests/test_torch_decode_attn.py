"""Port decode attention (plain version on CPU) against the reference's
Pallas decode kernel in interpret mode, fp32, atol 1e-4; and the kernel's
split plan (pure Python), which decides its grid and workspace."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn.ops import decode_attention as j_decode
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.decode_attn import (
    KV_TILE, MAX_HEAD_DIM, MAX_TILES, MLA_CTAS, MLA_CTAS_PER_SM,
    MLA_GEOMETRIES,
    MLA_MAX_QK, MLA_MAX_ROPE, MLA_MAX_V, ROW_BLOCK, _check, _check_mla,
    mla_geometry,
    decode_attention, decode_attention_plain, decode_split_plan,
    mla_smem_bytes, mla_split_plan, split_workspace)
from repro_torch.kernels.windowed_attn import SMEM_LIMIT

TOL = 1e-4
SM_SMEM = 233472         # bytes of shared memory an H100 SM holds (228 KB)
CTA_RESERVED = 1024      # bytes the card reserves for each resident CTA


def _operands(seed=0, B=3, s=5, H=4, Hk=2, D=8, Dv=8, cap=22):
    r = np.random.default_rng(seed)
    f = lambda *shape: r.normal(size=shape).astype(np.float32)
    pos_k = np.full((B, cap), -1, np.int32)          # rows at different fill
    pos_k[0, :10] = np.arange(10)
    pos_k[1, :17] = np.arange(17)                    # row 2 stays empty
    seg_k = np.full((B, cap), -1, np.int32)
    seg_k[0, 7:10] = [0, 0, 1]
    seg_q = np.zeros((B, s), np.int32)
    seg_q[0] = [0, 0, 1, 1, 1]
    return dict(q=f(B, s, H, D), k=f(B, cap, Hk, D), v=f(B, cap, Hk, Dv),
                pos_q=np.tile(np.arange(10, 10 + s, dtype=np.int32), (B, 1)),
                pos_k=pos_k), dict(
        is_sum_q=r.random((B, s)) < 0.4, q_nope=f(B, s, H, D),
        k_nope=f(B, cap, Hk, D),
        alibi=r.uniform(0.1, 1.0, H).astype(np.float32),
        seg_q=seg_q, seg_k=seg_k)


def _both(base, opt, window, **extra_j):
    want = np.asarray(j_decode(*[jnp.asarray(base[k]) for k in
                                 ("q", "k", "v", "pos_q", "pos_k")],
                               window=window, interpret=True,
                               **{k: jnp.asarray(v) for k, v in opt.items()},
                               **extra_j))
    T = lambda x: torch.from_numpy(x)
    got = decode_attention(*[T(base[k]) for k in
                             ("q", "k", "v", "pos_q", "pos_k")],
                           window=window, **{k: T(v) for k, v in opt.items()})
    return got.numpy(), want


@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("use_nope", [False, True])
@pytest.mark.parametrize("use_seg", [False, True])
def test_decode_matches_reference(window, use_nope, use_seg):
    base, opt = _operands()
    keep = (["is_sum_q", "q_nope", "k_nope", "alibi"] if use_nope else []) + (
        ["seg_q", "seg_k"] if use_seg else [])
    got, want = _both(base, {k: opt[k] for k in keep}, window, block_size=8)
    np.testing.assert_allclose(got, want, atol=TOL)
    assert np.all(got[2] == 0.0)      # the empty cache row gives exactly 0


def test_decode_mqa_value_dim():
    """Hk=1 with Dv != Dqk (the absorbed-MLA operand shape)."""
    base, _ = _operands(Hk=1, Dv=5)
    got, want = _both(base, {}, 0, block_size=16)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_decode_absorbed_mla_geometry():
    """The MLA mode's geometry, Hk=1 with Dqk 288 and Dv 256 (minicpm3-4b's
    absorbed operands), NoPE stream and segments on."""
    base, opt = _operands(2, B=2, s=5, H=4, Hk=1, D=288, Dv=256, cap=22)
    got, want = _both(base, opt, 6, block_size=8)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_cpu_wrapper_uses_plain_version_and_counts_nothing():
    base, opt = _operands(1)
    T = lambda x: torch.from_numpy(x)
    args = [T(base[k]) for k in ("q", "k", "v", "pos_q", "pos_k")]
    before = dict(LAUNCHES)
    got = decode_attention(*args, window=6, seg_q=T(opt["seg_q"]),
                           seg_k=T(opt["seg_k"]))
    want = decode_attention_plain(*args, window=6, seg_q=T(opt["seg_q"]),
                                  seg_k=T(opt["seg_k"]))
    assert torch.equal(got, want) and LAUNCHES == before


# (B, s, H, Hk, cap, n_sm, Dv): the GQA mode's decode and scheduler
# shapes, MQA, a cap below one tile, caps off the tile and off the split,
# an empty cache, a cache longer than one range may hold
GQA_PLAN_SHAPES = [
    (8, 64, 32, 8, 2048, 132, 128), (8, 32, 32, 8, 2048, 132, 128),
    (8, 16, 32, 8, 2048, 132, 128), (8, 1, 32, 8, 2048, 132, 128),
    (8, 64, 32, 4, 2048, 132, 128), (1, 16, 32, 1, 4000, 132, 128),
    (2, 16, 8, 2, 203, 132, 64), (2, 16, 8, 2, 20, 132, 64),
    (3, 9, 8, 1, 130, 132, 48), (1, 5, 4, 2, 0, 132, 8),
    (3, 70, 8, 2, 300, 66, 64), (1, 64, 32, 8, 20000, 8, 128)]
# then the MLA mode's (one latent key, Dv = r): minicpm3-4b's 40 heads at
# the decode burst and every scheduler bucket, latents of 136 and 72, a
# cache longer than one range may hold
MLA_PLAN_SHAPES = [
    (8, 64, 40, 1, 2048, 132, 256), (8, 32, 40, 1, 2048, 132, 256),
    (8, 16, 40, 1, 2048, 132, 256), (8, 1, 40, 1, 2048, 132, 256),
    (3, 12, 8, 1, 190, 132, 136), (3, 70, 8, 1, 300, 132, 72),
    (1, 1, 40, 1, 9000, 132, 256)]
PLAN_SHAPES = GQA_PLAN_SHAPES + MLA_PLAN_SHAPES
MLA_SLOTS = 132 * MLA_CTAS_PER_SM        # resident MLA CTAs on an H100


def _plan(B, s, H, Hk, cap, n_sm, Dv):
    if (B, s, H, Hk, cap, n_sm, Dv) in MLA_PLAN_SHAPES:
        return mla_split_plan(B, s, H, cap, n_sm, Dv)
    return decode_split_plan(B, s, H, Hk, cap, n_sm, Dv)


@pytest.mark.parametrize("B,s,H,Hk,cap,n_sm,Dv", PLAN_SHAPES)
def test_split_plan_covers_every_row_and_slot_once(B, s, H, Hk, cap, n_sm,
                                                   Dv):
    """Each row block's rows and each range's slots once; in both modes a
    CTA owns every value column of its rows (no value axis)."""
    plan = _plan(B, s, H, Hk, cap, n_sm, Dv)
    rows = (H // Hk) * s
    owner = np.zeros(rows, int)
    for rb in range(plan.n_rb):
        owner[rb * ROW_BLOCK:min(rows, (rb + 1) * ROW_BLOCK)] += 1
    assert (owner == 1).all()
    assert plan.span % KV_TILE == 0 and 0 < plan.span <= MAX_TILES * KV_TILE
    slots = np.zeros(cap, int)
    for sp in range(plan.n_split):
        lo, hi = sp * plan.span, min(cap, (sp + 1) * plan.span)
        assert hi > lo or cap == 0          # no split is left without slots
        slots[lo:hi] += 1
    assert (slots == 1).all()
    assert plan.grid == B * Hk * plan.n_rb * plan.n_split


@pytest.mark.parametrize("s", [1, 16, 32, 64])
def test_split_plan_fills_the_card(s):
    """B=8, H=32, Hk=8, cap=2048 on an H100's 132 SMs: every bucket of the
    scheduler and the decode burst give a grid of at least 132 CTAs; row
    blocks alone do at s=64, so no workspace is needed there."""
    plan = decode_split_plan(8, s, 32, 8, 2048, 132, 128)
    assert plan.grid >= 132
    assert (plan.n_split == 1) == (s == 64)


@pytest.mark.parametrize("s", [1, 16, 32, 64])
def test_split_plan_fills_the_card_in_the_mla_mode(s):
    """minicpm3-4b's absorbed decode (B=8, 40 heads on one latent key,
    cap=2048, Dv 256) on an H100, two MLA CTAs per SM: at every bucket the
    grid fills at least one wave of resident CTAs (264), with the fewest
    cache ranges that do: none at s=64 (320 row blocks), 2 at s=32, 4 at
    s=16; at s=1 (ring steps, one row block per batch row) ranges of one
    tile."""
    plan = mla_split_plan(8, s, 40, 2048, 132, 256)
    assert plan.grid >= MLA_SLOTS
    assert plan.n_rb == -(-40 * s // ROW_BLOCK)
    want = {1: (64, KV_TILE), 16: (4, 16 * KV_TILE), 32: (2, 32 * KV_TILE),
            64: (1, 64 * KV_TILE)}[s]
    assert (plan.n_split, plan.span) == want
    # the next coarser equal cut (3, 1 and 32 ranges) would leave part of
    # the wave empty
    coarser = {1: 32, 16: 3, 32: 1, 64: 1}[s]
    assert s == 64 or plan.grid // plan.n_split * coarser < MLA_SLOTS


def test_mla_mode_takes_the_wide_head_dims():
    """The MLA mode takes two geometries: a latent of up to 256 values and
    an even rope span of up to 32 (288 / 256 at minicpm3-4b), and up to
    512 and 64 (deepseek-v2's 576 / 512); wider ones (a latent of 1024, a
    rope span past 64, an odd one) are refused naming both, and the GQA
    mode refuses head dims past 128 on the card, naming the MLA entry
    point. Shapes only: the checks run before any launch."""
    assert (MLA_MAX_QK, MLA_MAX_V, MLA_MAX_ROPE) == (576, 512, 64)
    assert MLA_GEOMETRIES == ((256, 32), (512, 64))
    z = lambda *sh: torch.zeros(sh)
    for d, r in ((1088, 1024), (577, 512), (584, 520), (578, 512),
                 (321, 256)):
        with pytest.raises(ValueError, match="288/256, 576/512"):
            _check_mla(z(1, 2, 4, d), z(1, 32, r), z(1, 32, d - r),
                       z(1, 32, d - r), False, True, None, None)
    for d, r, geo in ((288, 256, (256, 32)), (576, 512, (512, 64)),
                      (289 + 1, 256, (512, 64)), (288, 264, (512, 64))):
        _check_mla(z(1, 2, 4, d), z(1, 32, r), z(1, 32, d - r),
                   z(1, 32, d - r), False, True, None, None)
        assert mla_geometry(r, d - r) == geo
    with pytest.raises(ValueError, match="decode_attention_mla"):
        _check(z(1, 2, 4, MAX_HEAD_DIM + 8), z(1, 32, 1, MAX_HEAD_DIM + 8),
               z(1, 32, 1, 64), False, None, None, torch.float32)


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("nope", [False, True])
@pytest.mark.parametrize("s", [1, 16, 64])
def test_mla_smem_allows_the_stated_ctas_per_sm(bf16, quant, nope, s):
    """The shared memory an MLA CTA asks for (minicpm3-4b's 40 heads) fits
    a CTA's 227 KB and lets ``MLA_CTAS_PER_SM`` CTAs share an SM's 228 KB,
    1 KB of it reserved per CTA; bf16 at s=64 with the NoPE stream, the
    largest, stays near 104 KB."""
    smem = mla_smem_bytes(bf16, quant, nope, s, 40)
    assert smem <= SMEM_LIMIT
    assert MLA_CTAS_PER_SM * (smem + CTA_RESERVED) <= SM_SMEM
    if bf16 and nope and not quant and s == 64:
        assert smem <= 104 * 1024


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("nope", [False, True])
@pytest.mark.parametrize("s", [1, 6, 16, 64])
def test_mla_smem_at_deepseek_geometry_fits_one_cta(bf16, quant, nope, s):
    """deepseek-v2's geometry (128 heads on one latent key, r 512, dr 64):
    one MLA CTA per SM (``MLA_CTAS``), whose shared memory fits a CTA's
    227 KB; in bf16 the Q planes (64 x 576), three plane stages of 32
    slots (latent, roped and, with the NoPE stream, unroped rope span) and
    the tables come to ~200 KB, so two CTAs cannot share an SM."""
    assert MLA_CTAS[(512, 64)] == 1
    smem = mla_smem_bytes(bf16, quant, nope, s, 128, 512, 64)
    assert smem <= SMEM_LIMIT
    assert smem > mla_smem_bytes(bf16, quant, nope, s, 128)
    if bf16 and not quant:
        q_planes = ROW_BLOCK * 576 * 2
        stage = KV_TILE * (512 + 64 + 64 * nope) * 2
        assert smem >= q_planes + 3 * stage
        assert 2 * (smem + CTA_RESERVED) > SM_SMEM


@pytest.mark.parametrize("s", [1, 6, 16, 64])
def test_mla_split_plan_at_deepseek_geometry(s):
    """deepseek-v2's absorbed decode on an H100 (B=8, 128 heads on one
    latent key, cap 2048, r 512): ceil(128 s / 64) row blocks a batch row
    (1,024 in all at s=64), each taken by two CTAs of 256 value columns,
    times the fewest cache ranges that fill one wave of resident CTAs (132
    at one a SM): none from s=6 on, where row blocks alone fill it; every
    row and slot once, the workspace (Dv + 2) fp32 a row and range."""
    b, h, cap, n_sm = 8, 128, 2048, 132
    plan = mla_split_plan(b, s, h, cap, n_sm, 512, 64)
    assert plan.n_rb == -(-h * s // ROW_BLOCK)
    assert plan.grid == b * plan.n_rb * 2 * plan.n_split >= n_sm
    assert (plan.n_split == 1) == (s >= 6)
    if s == 64:
        assert b * plan.n_rb == 1024 and plan.grid == 2048
    if plan.n_split > 1:    # the next coarser cut leaves part of the wave
        coarser = plan.n_split - 1
        assert b * plan.n_rb * 2 * coarser < n_sm
        assert plan.workspace == plan.n_split * b * s * h * 514
    slots = np.zeros(cap, int)
    for sp in range(plan.n_split):
        slots[sp * plan.span:min(cap, (sp + 1) * plan.span)] += 1
    assert (slots == 1).all() and plan.span % KV_TILE == 0


@pytest.mark.parametrize("B,s,H,Hk,cap,n_sm,Dv", PLAN_SHAPES)
def test_split_workspace_matches_the_plan(B, s, H, Hk, cap, n_sm, Dv):
    """What the wrapper allocates: the kernel's partial acc (n_split, B,
    s, H, Dv), then m and l (n_split, B, s, H), in fp32; nothing with one
    range."""
    plan = _plan(B, s, H, Hk, cap, n_sm, Dv)
    ws = split_workspace(plan, torch.device("cpu"))
    if plan.n_split == 1:
        assert ws is None and plan.workspace == 0
    else:
        assert ws.dtype == torch.float32
        assert ws.numel() == plan.workspace == \
            plan.n_split * B * s * H * (Dv + 2)
