"""Port decode attention (plain version on CPU) against the reference's
Pallas decode kernel in interpret mode, fp32, atol 1e-4; and the kernel's
split plan (pure Python), which decides its grid and workspace."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn.ops import decode_attention as j_decode
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.decode_attn import (KV_TILE, MAX_TILES, ROW_BLOCK,
                                             decode_attention,
                                             decode_attention_plain,
                                             decode_split_plan,
                                             split_workspace)

TOL = 1e-4


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


# (B, s, H, Hk, cap, n_sm, Dv): the decode and scheduler shapes, MQA, a
# cap below one tile, caps off the tile and off the split, an empty cache,
# a cache longer than one range may hold
PLAN_SHAPES = [(8, 64, 32, 8, 2048, 132, 128), (8, 32, 32, 8, 2048, 132, 128),
               (8, 16, 32, 8, 2048, 132, 128), (8, 1, 32, 8, 2048, 132, 128),
               (8, 64, 32, 4, 2048, 132, 128), (1, 16, 32, 1, 4000, 132, 128),
               (2, 16, 8, 2, 203, 132, 64), (2, 16, 8, 2, 20, 132, 64),
               (3, 9, 8, 1, 130, 132, 48), (1, 5, 4, 2, 0, 132, 8),
               (3, 70, 8, 2, 300, 66, 64), (1, 64, 32, 8, 20000, 8, 128)]


@pytest.mark.parametrize("B,s,H,Hk,cap,n_sm,Dv", PLAN_SHAPES)
def test_split_plan_covers_every_row_and_slot_once(B, s, H, Hk, cap, n_sm,
                                                   Dv):
    plan = decode_split_plan(B, s, H, Hk, cap, n_sm, Dv)
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


@pytest.mark.parametrize("B,s,H,Hk,cap,n_sm,Dv", PLAN_SHAPES)
def test_split_workspace_matches_the_plan(B, s, H, Hk, cap, n_sm, Dv):
    """What the wrapper allocates: the kernel's partial acc (n_split, B,
    s, H, Dv), then m and l (n_split, B, s, H), in fp32; nothing with one
    range."""
    plan = decode_split_plan(B, s, H, Hk, cap, n_sm, Dv)
    ws = split_workspace(plan, torch.device("cpu"))
    if plan.n_split == 1:
        assert ws is None and plan.workspace == 0
    else:
        assert ws.dtype == torch.float32
        assert ws.numel() == plan.workspace == \
            plan.n_split * B * s * H * (Dv + 2)
