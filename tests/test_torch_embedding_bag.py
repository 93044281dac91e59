"""The port's embedding bag (the kernel's plain version, on the CPU) against
the reference's op over its Pallas kernel in interpret mode, and the
port's embedding substrate against ``repro.sparse.embedding``.

Tolerances: fp32 1e-5 and int8 1e-5 (summation order only; the int8 scale
folds exactly into the weights), bf16 2e-2 (the output is rounded to
bf16 on both sides, at different places). ``hash_bucket`` bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import quantize_q8 as j_quantize_q8
from repro.kernels.embedding_bag.ops import embedding_bag as j_bag
from repro.sparse import embedding as j_emb
from repro_torch.core.quant import quantize_q8
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.embedding_bag import (bag_weights, embedding_bag,
                                               embedding_bag_plain)
from repro_torch.sparse import embedding as t_emb

TOL = 1e-5
BF16_TOL = 2e-2

# tests/test_kernels.py's grid plus the recsys family's row widths
GRID = [(64, 8, 4, 3), (512, 32, 16, 8), (1000, 128, 8, 20), (37, 16, 5, 7),
        (300, 10, 6, 12), (300, 18, 7, 20), (300, 50, 3, 9), (300, 64, 5, 16)]


def _bag_operands(seed, V, B, H, D, *, scale=1.0):
    r = np.random.default_rng(seed)
    table = (scale * r.normal(size=(V, D))).astype(np.float32)
    ids = r.integers(0, V, (B, H)).astype(np.int32)
    valid = r.random((B, H)) < 0.8
    valid[0] = False                                   # an all-invalid bag
    # masked slots may hold any id: below 0 and past the table's end
    junk = r.integers(-2 * V, 3 * V, (B, H)).astype(np.int32)
    ids = np.where(valid, ids, junk)
    return table, ids, valid


def _ref(table, ids, valid, **kw):
    jv = None if valid is None else jnp.asarray(valid)
    return np.asarray(j_bag(jnp.asarray(table), jnp.asarray(ids), jv,
                            interpret=True, **kw), np.float32)


def _port(table, ids, valid, **kw):
    tv = None if valid is None else torch.from_numpy(valid)
    return embedding_bag(torch.from_numpy(table), torch.from_numpy(ids), tv,
                         **kw)


@pytest.mark.parametrize("V,D,B,H", GRID)
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_bag_matches_reference_op(V, D, B, H, mode):
    table, ids, valid = _bag_operands(V + D, V, B, H, D)
    before = dict(LAUNCHES)
    got = _port(table, ids, valid, mode=mode)
    assert dict(LAUNCHES) == before          # the plain version never counts
    assert got.dtype == torch.float32 and got.shape == (B, D)
    np.testing.assert_allclose(got.numpy(), _ref(table, ids, valid,
                                                 mode=mode), atol=TOL, rtol=0)
    assert torch.all(got[0] == 0)


@pytest.mark.parametrize("use_valid", [False, True])
def test_bag_weights_match_reference(use_valid):
    table, ids, valid = _bag_operands(1, 100, 8, 5, 16)
    if not use_valid:
        ids, valid = np.abs(ids) % 100, None
    w = np.random.default_rng(2).normal(size=(8, 5)).astype(np.float32)
    got = _port(table, ids, valid, weights=torch.from_numpy(w))
    want = _ref(table, ids, valid, weights=jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_bf16_table_matches_reference(mode):
    table, ids, valid = _bag_operands(3, 64, 4, 6, 32)
    got = embedding_bag(torch.from_numpy(table).bfloat16(),
                        torch.from_numpy(ids), torch.from_numpy(valid),
                        mode=mode)
    assert got.dtype == torch.bfloat16
    want = np.asarray(j_bag(jnp.asarray(table, jnp.bfloat16),
                            jnp.asarray(ids), jnp.asarray(valid), mode=mode,
                            interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_TOL,
                               rtol=BF16_TOL)


@pytest.mark.parametrize("D", [16, 18, 64])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_int8_table_matches_reference(D, mode):
    table, ids, valid = _bag_operands(4 + D, 200, 8, 6, D, scale=3.0)
    codes, scale = quantize_q8(torch.from_numpy(table))
    j_codes, j_scale = j_quantize_q8(jnp.asarray(table))
    assert codes.numpy().tobytes() == np.asarray(j_codes).tobytes()
    assert scale.numpy().tobytes() == np.asarray(j_scale).tobytes()
    got = embedding_bag(codes, torch.from_numpy(ids),
                        torch.from_numpy(valid), mode=mode,
                        table_scale=scale)
    assert got.dtype == torch.float32
    want = np.asarray(j_bag(j_codes, jnp.asarray(ids), jnp.asarray(valid),
                            mode=mode, table_scale=j_scale, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_bag_rejects_what_the_kernel_does_not_do():
    table, ids, valid = _bag_operands(5, 10, 2, 4, 8)
    with pytest.raises(ValueError):
        _port(table, ids, valid, mode="max")
    codes, scale = quantize_q8(torch.from_numpy(table))
    with pytest.raises(TypeError):                    # codes need scales
        embedding_bag(codes, torch.from_numpy(ids))
    with pytest.raises(TypeError):
        embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                      table_scale=scale)


@pytest.mark.parametrize("int8", [False, True])
def test_nonfinite_row_under_masked_or_zero_weight_slot_gives_nan(int8):
    """The reference's kernel adds row * w for every slot: an inf row under
    a masked slot (its id clamped onto row 0) or a zero-weight slot gives
    NaN in that bag, and the port's plain version (the kernel's contract)
    gives the same; for int8 codes an inf or NaN row scale does so."""
    V, D, B, H = 40, 18, 4, 6
    table, ids, _ = _bag_operands(7, V, B, H, D)
    ids = np.abs(ids) % (V - 2) + 1
    valid = np.ones((B, H), bool)
    w = np.ones((B, H), np.float32)
    ids[0, 2], valid[0, 2] = -7, False      # masked: clamps onto row 0
    ids[1, 4], w[1, 4] = V - 1, 0.0         # zero weight on row V - 1
    if int8:
        codes, scale = quantize_q8(torch.from_numpy(table))
        scale[0], scale[V - 1] = float("inf"), float("nan")
        got = embedding_bag(codes, torch.from_numpy(ids),
                            torch.from_numpy(valid),
                            weights=torch.from_numpy(w), table_scale=scale)
        want = np.asarray(j_bag(jnp.asarray(codes.numpy()), jnp.asarray(ids),
                                jnp.asarray(valid), weights=jnp.asarray(w),
                                table_scale=jnp.asarray(scale.numpy()),
                                interpret=True))
    else:
        table[0, 3], table[V - 1, 5] = np.inf, -np.inf
        got = _port(table, ids, valid, weights=torch.from_numpy(w))
        want = _ref(table, ids, valid, weights=jnp.asarray(w))
    got = got.numpy()
    assert np.isnan(want[:2]).any(-1).all() and np.isfinite(want[2:]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_plain_version_is_the_op_after_its_weights():
    table, ids, valid = _bag_operands(6, 50, 5, 7, 12)
    t, i, v = map(torch.from_numpy, (table, ids, valid))
    w = bag_weights(i, v, mode="mean")
    np.testing.assert_array_equal(embedding_bag_plain(t, i, w).numpy(),
                                  embedding_bag(t, i, v, mode="mean").numpy())


# ---------------------------------------------------------------------------
# the substrate: repro_torch.sparse.embedding against repro.sparse.embedding
# ---------------------------------------------------------------------------

def _table(seed=0, V=40, D=6):
    return np.random.default_rng(seed).normal(size=(V, D)).astype(np.float32)


def test_lookup_and_field_lookup_match():
    r = np.random.default_rng(1)
    table = _table()
    ids = r.integers(0, 40, (3, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        t_emb.embedding_lookup(torch.from_numpy(table),
                               torch.from_numpy(ids)).numpy(),
        np.asarray(j_emb.embedding_lookup(jnp.asarray(table),
                                          jnp.asarray(ids))))
    vocabs = (7, 40, 3)
    tables = {f"field{i}": _table(i, v, 4) for i, v in enumerate(vocabs)}
    fids = np.stack([r.integers(0, v, 9) for v in vocabs], 1).astype(np.int32)
    got = t_emb.field_lookup({k: torch.from_numpy(v) for k, v in
                              tables.items()}, torch.from_numpy(fids))
    want = j_emb.field_lookup({k: jnp.asarray(v) for k, v in tables.items()},
                              jnp.asarray(fids))
    assert got.shape == (9, 3, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("use_valid,use_weights", [(False, False),
                                                   (True, False),
                                                   (True, True)])
def test_substrate_bag_matches(mode, use_valid, use_weights):
    r = np.random.default_rng(2)
    table = _table()
    ids = r.integers(0, 40, (2, 3, 5)).astype(np.int32)   # leading dims
    valid = r.random((2, 3, 5)) < 0.7
    valid[0, 0] = False
    w = r.normal(size=(2, 3, 5)).astype(np.float32)
    tv = torch.from_numpy(valid) if use_valid else None
    jv = jnp.asarray(valid) if use_valid else None
    tw = torch.from_numpy(w) if use_weights else None
    jw = jnp.asarray(w) if use_weights else None
    got = t_emb.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                              tv, mode=mode, weights=tw)
    want = j_emb.embedding_bag(jnp.asarray(table), jnp.asarray(ids), jv,
                               mode=mode, weights=jw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("use_weights", [False, True])
def test_ragged_bag_matches_and_drops_out_of_range_segments(use_weights):
    r = np.random.default_rng(3)
    table = _table()
    flat = r.integers(0, 40, 30).astype(np.int32)
    seg = r.integers(-2, 7, 30).astype(np.int32)   # -2, -1, 5, 6 are dropped
    w = r.normal(size=30).astype(np.float32)
    got = t_emb.embedding_bag_ragged(
        torch.from_numpy(table), torch.from_numpy(flat), torch.from_numpy(seg),
        5, weights=torch.from_numpy(w) if use_weights else None)
    want = j_emb.embedding_bag_ragged(
        jnp.asarray(table), jnp.asarray(flat), jnp.asarray(seg), 5,
        weights=jnp.asarray(w) if use_weights else None)
    assert got.shape == (5, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("vocab", [1, 7, 1000, 2 ** 20, 2 ** 31 - 1])
def test_hash_bucket_is_bit_exact(vocab):
    r = np.random.default_rng(4)
    edge = [0, 1, -1, 2, -2, 2 ** 31 - 1, 2 ** 31 - 2, -2 ** 31,
            -2 ** 31 + 1, 2 ** 16, 2 ** 16 - 1, -2 ** 16, 0x9E3779B9 - 2 ** 32]
    ids = np.concatenate([np.asarray(edge, np.int64),
                          r.integers(-2 ** 31, 2 ** 31, 500)]).astype(np.int32)
    got = t_emb.hash_bucket(torch.from_numpy(ids), vocab).numpy()
    want = np.asarray(j_emb.hash_bucket(jnp.asarray(ids), vocab))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < vocab


def test_hash_bucket_salt_matches():
    ids = np.arange(-50, 50, dtype=np.int32)
    got = t_emb.hash_bucket(torch.from_numpy(ids), 97, salt=12345).numpy()
    want = np.asarray(j_emb.hash_bucket(jnp.asarray(ids), 97, salt=12345))
    np.testing.assert_array_equal(got, want)
