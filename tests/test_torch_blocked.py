"""The port's blocked attention (``repro_torch.core.windowed
.attention_blocked``, plain PyTorch as in the reference) against
``repro.core.windowed.attention_blocked``, fp32, atol 2e-5 (the tolerance
``tests/test_attention.py`` holds the reference's blocked path to).

The flag grid of ``tests/test_attention.py`` (plain window, [SUM]
isolation, NoPE + ALiBi, the full DTI set with reset) at windows 32 and 64,
each with the query blocks computed at once and in chunks of two
(``q_chunk``); packed segments; and a GQA model's forward on the blocked
path against the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.windowed import ResetConfig as JReset
from repro.core.windowed import attention_blocked as j_blocked
from repro.models.layers import alibi_slopes as j_alibi
from repro.models.transformer import ModelConfig as JConfig
from repro.models.transformer import forward as j_forward
from repro.models.transformer import init_params as j_init
from repro_torch.bridge import config_from_jax, from_jax_params
from repro_torch.core.windowed import ResetConfig, attention, attention_blocked
from repro_torch.models.layers import alibi_slopes
from repro_torch.models.transformer import forward

TOL = 2e-5
T = torch.from_numpy
FLAG_SETS = [dict(), dict(sum=True), dict(sum=True, nope=True),
             dict(sum=True, nope=True, reset=True)]


def _inputs(B=2, S=128, H=4, Hk=2, D=16, seed=0):
    r = np.random.default_rng(seed)
    f = lambda *shape: r.normal(size=shape).astype(np.float32)
    return dict(q=f(B, S, H, D), k=f(B, S, Hk, D), v=f(B, S, Hk, D),
                qn=f(B, S, H, D), kn=f(B, S, Hk, D), v0=f(B, S, Hk, D),
                pos=np.tile(np.arange(S, dtype=np.int32), (B, 1)),
                is_sum=r.random((B, S)) < 0.15, valid=r.random((B, S)) < 0.9)


def _both(o, flags, W, q_chunk, H=4, seg=None):
    """(port, reference) outputs of the blocked path on ``o``."""
    kw = dict(pos_q=o["pos"], pos_k=o["pos"], window=W, valid_k=o["valid"])
    if flags.get("sum"):
        kw.update(is_sum_q=o["is_sum"], is_sum_k=o["is_sum"])
    if flags.get("nope"):
        kw.update(q_nope=o["qn"], k_nope=o["kn"])
    if flags.get("reset"):
        kw.update(v0=o["v0"])
    if seg is not None:
        kw.update(seg_q=seg, seg_k=seg)
    reset = flags.get("reset")
    jkw = {k: jnp.asarray(v) for k, v in kw.items() if k != "window"}
    tkw = {k: T(v) for k, v in kw.items() if k != "window"}
    if flags.get("nope"):
        jkw["alibi"], tkw["alibi"] = j_alibi(H), alibi_slopes(H)
    if reset:
        jkw["reset"] = JReset(0.05, 0.3, W / 2)
        tkw["reset"] = ResetConfig(0.05, 0.3, W / 2)
    want = j_blocked(*(jnp.asarray(o[n]) for n in "qkv"), window=W,
                     q_chunk=q_chunk, **jkw)
    got = attention_blocked(*(T(o[n]) for n in "qkv"), window=W,
                            q_chunk=q_chunk, **tkw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("q_chunk", [0, 2])
@pytest.mark.parametrize("W", [32, 64])
@pytest.mark.parametrize("flags", FLAG_SETS, ids=["window", "sum", "nope",
                                                  "dti"])
def test_blocked_matches_reference(flags, W, q_chunk):
    got, want = _both(_inputs(), flags, W, q_chunk)
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("q_chunk", [0, 2])
def test_blocked_packed_segments_match_reference(q_chunk):
    """Two packed prompts per row, positions restarting at the cut; the
    segment term keeps the pair of blocks exact across it."""
    o = _inputs(seed=3)
    cut = 56
    o["pos"][:, cut:] = np.arange(128 - cut, dtype=np.int32)
    seg = np.zeros((2, 128), np.int32)
    seg[:, cut:] = 1
    got, want = _both(o, FLAG_SETS[3], 32, q_chunk, seg=seg)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_attention_dispatches_blocked_and_checks_its_shape():
    o = _inputs(S=64)
    args = [T(o[n]) for n in "qkv"]
    pos = T(o["pos"])
    got = attention("blocked", *args, pos_q=pos, pos_k=pos, window=32)
    want = attention_blocked(*args, pos_q=pos, pos_k=pos, window=32)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="divisible"):
        attention_blocked(*args, pos_q=pos, pos_k=pos, window=48)
    with pytest.raises(ValueError, match="window"):
        attention_blocked(*args, pos_q=pos, pos_k=pos, window=0)


def test_forward_on_the_blocked_path_matches_reference():
    """A GQA model with ``attn_impl="blocked"``: DTI [SUM] rows with
    reset, q chunks of 2 over 4 blocks; hidden states within 1e-5."""
    jcfg = JConfig(n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, d_ff=96,
                   vocab_size=128, head_dim=12, window=16,
                   attn_impl="blocked", attn_q_chunk=2, dti_sum_token=True,
                   remat=False)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    assert cfg.attn_impl == "blocked" and cfg.attn_q_chunk == 2
    tree = jax.tree_util.tree_map(np.asarray,
                                  j_init(jax.random.PRNGKey(0), jcfg))
    params = from_jax_params(tree, cfg, "cpu")
    r = np.random.default_rng(5)
    toks = r.integers(5, 128, (2, 64)).astype(np.int32)
    is_sum = r.random((2, 64)) < 0.1
    want = j_forward(jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
                     jnp.asarray(toks), is_sum=jnp.asarray(is_sum),
                     dti_enabled=True)["hidden"]
    got = forward(params, cfg, T(toks), is_sum=T(is_sum),
                  dti_enabled=True)["hidden"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
