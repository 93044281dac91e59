"""The host side of kernel 5's design, ``bag_plan`` and ``lane_columns``
(pure Python, as ``csrc/embedding_bag.cu`` computes them): the vector a
lane loads divides both the row's bytes and the table pointer's
alignment, every column of a slot is loaded by exactly one lane of one
group, the groups and a round's ids fit in a warp, the grid covers each
(bag, column chunk) and each slot once, and the grid fills the card where
the bags allow it. Fixed inputs only."""
import pytest

from repro_torch.kernels.embedding_bag import (BLOCKS_PER_SM, MAX_VEC,
                                               MAX_WARPS, STEPS, bag_plan,
                                               lane_columns)

N_SM = 132               # an H100 SXM's SMs
BASE = 0x7F3A00000000    # a device address aligned far past 16 bytes
WIDTHS = [1, 10, 17, 18, 33, 50, 64, 128, 200]
# (esize, pointer alignments it can have): fp32, bf16, int8
KINDS = {"fp32": (4, [16, 8, 4]), "bf16": (2, [16, 8, 4, 2]),
         "int8": (1, [16, 8, 4, 2, 1])}
CASES = [(d, kind, align) for d in WIDTHS for kind, (_, aligns) in
         KINDS.items() for align in aligns]


def _addr(align):
    """An address whose alignment (up to 16 bytes) is exactly ``align``."""
    return BASE if align == MAX_VEC else BASE + align


@pytest.mark.parametrize("d,kind,align", CASES)
def test_every_column_of_a_slot_is_loaded_by_one_lane_of_one_group(
        d, kind, align):
    esize = KINDS[kind][0]
    plan = bag_plan(65536, 100, d, esize, _addr(align), N_SM)
    row = d * esize
    assert plan.align == align
    # the widest power of two up to 16 bytes dividing both
    assert row % plan.vec == 0 and align % plan.vec == 0
    assert plan.vec >= esize and plan.vec & (plan.vec - 1) == 0
    assert plan.vec == MAX_VEC or row % (2 * plan.vec) \
        or align % (2 * plan.vec)
    # groups and a round's ids fit in one warp
    assert plan.lanes_per_row <= 32
    assert plan.rows_per_step == 32 // plan.lanes_per_row >= 1
    assert plan.rows_per_step * plan.lanes_per_row <= 32
    assert 1 <= plan.steps <= STEPS
    assert plan.rows_per_step * plan.steps <= 32
    # the fewest column chunks of at most 32 lanes, none empty
    lanes = row // plan.vec
    assert plan.col_chunks == -(-lanes // 32)
    assert (plan.col_chunks - 1) * plan.lanes_per_row < lanes \
        <= plan.col_chunks * plan.lanes_per_row
    assert plan.col_chunks == 1 or plan.rows_per_step == 1
    # each group loads every column of its slot once, in vec-wide pieces
    for g in range(plan.rows_per_step):
        seen = []
        for chunk in range(plan.col_chunks):
            for lane in range(32):
                grp, cols = lane_columns(plan, d, esize, chunk, lane)
                assert grp == lane // plan.lanes_per_row
                if grp == g:
                    assert len(cols) in (0, plan.vec // esize)
                    seen.extend(cols)
        assert sorted(seen) == list(range(d))
    # lanes of the groups past rows_per_step load nothing
    for lane in range(plan.rows_per_step * plan.lanes_per_row, 32):
        assert len(lane_columns(plan, d, esize, 0, lane)[1]) == 0


# (B, H, D, esize): DIN's and MIND's real shapes, one bag of one slot, few
# bags of many slots (split over warps), column chunks, the edges of the
# split rule (16 warps an SM: 2,112 warps) and of the block rule (264)
GRIDS = [(65536, 100, 18, 4), (65536, 100, 18, 1), (512, 100, 64, 4),
         (512, 100, 64, 1), (1, 1, 18, 4), (3, 300, 200, 4),
         (700, 45, 33, 1), (1056, 100, 10, 4), (1057, 100, 10, 4),
         (2, 1000, 128, 2), (264, 30, 50, 4), (263, 7, 1, 4)]


@pytest.mark.parametrize("B,H,D,esize", GRIDS)
def test_grid_covers_every_bag_and_slot_once(B, H, D, esize):
    plan = bag_plan(B, H, D, esize, BASE, N_SM)
    assert plan.split in (1, 2, 4, 8) and plan.warps in (1, 2, 4, 8)
    chunk = plan.rows_per_step * plan.steps
    rounds = -(-H // chunk)
    # (bag, warp's share) of each (block, warp), as the kernel reads them
    owners = {}
    for bx in range(plan.blocks):
        for wid in range(plan.warps):
            bag = bx if plan.split > 1 else bx * plan.warps + wid
            if bag < B:
                part = wid if plan.split > 1 else 0
                assert (bag, part) not in owners
                owners[bag, part] = True
    assert len(owners) == B * plan.split
    assert {bag for bag, _ in owners} == set(range(B))
    # a bag's slots: the rounds part, part + split, ... of each share;
    # a round's step u, group g takes slot j0 + u * rows_per_step + g
    slots = []
    for part in range(plan.split):
        for j0 in range(part * chunk, H, chunk * plan.split):
            n = min(chunk, H - j0)
            for u in range(plan.steps):
                for g in range(plan.rows_per_step):
                    if u * plan.rows_per_step + g < n:
                        slots.append(j0 + u * plan.rows_per_step + g)
    assert sorted(slots) == list(range(H))
    # split only with few bags, never more warps than rounds
    assert plan.split == 1 or (plan.warps == plan.split
                               and plan.blocks == B
                               and plan.split <= min(MAX_WARPS, rounds))
    # the grid fills the card where the bags allow it
    blocks = plan.blocks * plan.col_chunks
    assert blocks >= min(BLOCKS_PER_SM * N_SM, B * plan.col_chunks)
    if plan.split == 1 and plan.warps < MAX_WARPS:
        assert -(-B // (2 * plan.warps)) * plan.col_chunks \
            < BLOCKS_PER_SM * N_SM


def test_din_and_mind_plans():
    """The plans the op path runs at DIN's and MIND's real shapes."""
    din = bag_plan(65536, 100, 18, 4, BASE, N_SM)
    assert (din.vec, din.lanes_per_row, din.rows_per_step, din.steps,
            din.split, din.warps, din.blocks) == (8, 9, 3, 8, 1, 8, 8192)
    din8 = bag_plan(65536, 100, 18, 1, BASE, N_SM)
    assert (din8.vec, din8.lanes_per_row, din8.rows_per_step) == (2, 9, 3)
    mind = bag_plan(512, 100, 64, 4, BASE, N_SM)
    assert (mind.vec, mind.lanes_per_row, mind.rows_per_step, mind.split,
            mind.blocks) == (16, 16, 2, 4, 512)
    mind8 = bag_plan(512, 100, 64, 1, BASE, N_SM)
    assert (mind8.vec, mind8.lanes_per_row, mind8.rows_per_step,
            mind8.steps, mind8.split) == (16, 4, 8, 4, 4)
