"""Port decode attention (plain version on CPU) against the reference's
Pallas decode kernel in interpret mode, fp32, atol 1e-4."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn.ops import decode_attention as j_decode
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.decode_attn import (decode_attention,
                                             decode_attention_plain)

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
