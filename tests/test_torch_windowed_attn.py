"""Port windowed attention (plain version on CPU) against the reference's
Pallas kernel in interpret mode: o and lse, fp32, atol 1e-4 (the bar the
reference holds its own kernels to)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.windowed import ResetConfig as JResetConfig
from repro.kernels.windowed_attn.ops import windowed_attention as j_attn
from repro.kernels.windowed_attn.windowed_attn import windowed_attention_bhsd
from repro_torch.core.windowed import ResetConfig, attention
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.windowed_attn import (windowed_attention,
                                               windowed_attention_plain)

TOL = 1e-4


def _operands(seed, *, B=2, S=40, H=4, Hk=2, D=8, Dv=8, packed=False):
    r = np.random.default_rng(seed)
    f = lambda *s: r.normal(size=s).astype(np.float32)
    ops = dict(q=f(B, S, H, D), k=f(B, S, Hk, D), v=f(B, S, Hk, Dv),
               qn=f(B, S, H, D), kn=f(B, S, Hk, D), v0=f(B, S, Hk, Dv),
               alibi=r.uniform(0.05, 0.5, H).astype(np.float32))
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    valid = np.ones((B, S), bool)
    valid[0, S - 5:] = False            # trailing padding
    valid[1, :] = False                 # a row with no attendable key ...
    valid[1, :3] = True                 # ... except its first three keys
    seg = np.zeros((B, S), np.int32)
    if packed:                          # two packed prompts + padding
        for b in range(B):
            seg[b, :17], seg[b, 17:S - 5], seg[b, S - 5:] = 0, 1, -1
            pos[b, 17:S - 5] = np.arange(S - 22)
            pos[b, S - 5:] = 0
    ops.update(pos=pos, valid=valid, seg=seg,
               is_sum=r.random((B, S)) < 0.15)
    return ops


def _run_both(o, *, window, nope, reset, packed, sum_iso):
    kw_j, kw_t = {}, {}
    if nope or reset:
        kw_j.update(is_sum_q=o["is_sum"], is_sum_k=o["is_sum"])
    if nope:
        kw_j.update(q_nope=o["qn"], k_nope=o["kn"], alibi=o["alibi"])
    if reset:
        kw_j.update(v0=o["v0"])
    if packed:
        kw_j.update(seg_q=o["seg"], seg_k=o["seg"])
    kw_j.update(valid_k=o["valid"], sum_isolated=sum_iso)
    kw_t = {k: torch.from_numpy(np.asarray(v)) for k, v in kw_j.items()
            if k != "sum_isolated"}
    rc = dict(y_min=0.0, y_max=0.3, midpoint=window / 2)

    jax_kw = {k: (jnp.asarray(v) if k != "sum_isolated" else v)
              for k, v in kw_j.items()}
    if reset:
        jax_kw["reset"] = JResetConfig(**rc)
    got_o_j = np.asarray(j_attn(
        jnp.asarray(o["q"]), jnp.asarray(o["k"]), jnp.asarray(o["v"]),
        pos_q=jnp.asarray(o["pos"]), pos_k=jnp.asarray(o["pos"]),
        window=window, block_size=8, interpret=True, **jax_kw))
    t = lambda x: jnp.swapaxes(jnp.asarray(x), 1, 2)
    _, lse_j = windowed_attention_bhsd(
        t(o["q"]), t(o["k"]), t(o["v"]), jnp.asarray(o["pos"]),
        jnp.asarray(o["pos"]), window=window,
        sum_q=jax_kw.get("is_sum_q"), sum_k=jax_kw.get("is_sum_k"),
        valid_k=jax_kw["valid_k"], seg_q=jax_kw.get("seg_q"),
        seg_k=jax_kw.get("seg_k"),
        q_nope=t(o["qn"]) if nope else None,
        k_nope=t(o["kn"]) if nope else None,
        alibi=jax_kw.get("alibi"), v0=t(o["v0"]) if reset else None,
        reset=(rc["y_min"], rc["y_max"], rc["midpoint"]) if reset else None,
        sum_isolated=sum_iso and (nope or reset), block_size=8,
        interpret=True, return_residuals=True)

    T = lambda x: torch.from_numpy(x)
    got_o_t, lse_t = windowed_attention(
        T(o["q"]), T(o["k"]), T(o["v"]), pos_q=T(o["pos"]),
        pos_k=T(o["pos"]), window=window,
        reset=ResetConfig(**rc) if reset else None, sum_isolated=sum_iso,
        return_lse=True, **kw_t)
    return got_o_j, np.asarray(lse_j), got_o_t.numpy(), lse_t.numpy()


@pytest.mark.parametrize("window", [8, 16])
@pytest.mark.parametrize("nope,reset,packed,sum_iso", [
    (False, False, False, True),
    (True, False, False, True),
    (True, True, False, True),
    (False, True, False, False),
    (True, False, True, True),
    (True, True, True, False),
])
def test_windowed_matches_reference(window, nope, reset, packed, sum_iso):
    o = _operands(window + 2 * nope + reset, packed=packed)
    o_j, lse_j, o_t, lse_t = _run_both(o, window=window, nope=nope,
                                       reset=reset, packed=packed,
                                       sum_iso=sum_iso)
    np.testing.assert_allclose(o_t, o_j, atol=TOL)
    np.testing.assert_allclose(lse_t, lse_j, atol=TOL, rtol=0)


@pytest.mark.parametrize("hk,dv,s", [(4, 8, 40), (1, 6, 40), (2, 8, 36)])
def test_windowed_gqa_value_dim_ragged(hk, dv, s):
    """n_rep in {1, 4}, Dv != Dqk, and a ragged S (the reference shrinks
    its block to a divisor; the result must not depend on it)."""
    o = _operands(3, Hk=hk, Dv=dv, S=s)
    o_j, lse_j, o_t, lse_t = _run_both(o, window=8, nope=True, reset=True,
                                       packed=False, sum_iso=True)
    np.testing.assert_allclose(o_t, o_j, atol=TOL)
    np.testing.assert_allclose(lse_t, lse_j, atol=TOL, rtol=0)


def test_empty_rows_give_zero_and_sentinel_lse():
    o = _operands(5)
    T = lambda x: torch.from_numpy(x)
    valid = np.zeros_like(o["valid"])
    out, lse = windowed_attention_plain(
        T(o["q"]), T(o["k"]), T(o["v"]), pos_q=T(o["pos"]),
        pos_k=T(o["pos"]), window=8, valid_k=T(valid))
    assert torch.all(out == 0) and torch.all(lse == 1e30)


def test_cpu_wrapper_uses_plain_version_and_counts_nothing():
    o = _operands(6)
    T = lambda x: torch.from_numpy(x)
    before = dict(LAUNCHES)
    got = attention("cuda", T(o["q"]), T(o["k"]), T(o["v"]),
                    pos_q=T(o["pos"]), pos_k=T(o["pos"]), window=8)
    want, _ = windowed_attention_plain(T(o["q"]), T(o["k"]), T(o["v"]),
                                       pos_q=T(o["pos"]), pos_k=T(o["pos"]),
                                       window=8)
    assert torch.equal(got, want) and LAUNCHES == before
    with pytest.raises(ValueError):
        windowed_attention(T(o["q"]), T(o["k"]), T(o["v"]),
                           pos_q=T(o["pos"]), pos_k=T(o["pos"]), window=0)
    with pytest.raises(NotImplementedError):
        attention("cuda", T(o["q"]), T(o["k"]), T(o["v"]),
                  pos_q=T(o["pos"]), pos_k=T(o["pos"]), window=8,
                  seg_q=T(o["seg"]), seg_k=T(o["seg"]), seg_shared=0)
