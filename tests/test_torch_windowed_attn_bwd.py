"""The port's windowed-attention backward (its plain version, which the
CUDA dq and dk/dv kernels are held to on the card) against ``jax.vjp`` of
the reference's Pallas op in interpret mode, fp32, atol 1e-4 (the bar the
reference holds its own kernels to); and exact segment isolation of the
gradient (the deterministic layouts of ``tests/test_kernel_grads.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.windowed import ResetConfig as JResetConfig
from repro.kernels.windowed_attn.ops import windowed_attention as j_attn
from repro_torch.core.windowed import ResetConfig
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.windowed_attn import (windowed_attention,
                                               windowed_attention_bwd_plain)

TOL = 1e-4
T = torch.from_numpy


def _operands(seed, *, B=2, S=40, H=4, Hk=2, D=8, Dv=8, packed=False):
    r = np.random.default_rng(seed)
    f = lambda *s: r.normal(size=s).astype(np.float32)
    o = dict(q=f(B, S, H, D), k=f(B, S, Hk, D), v=f(B, S, Hk, Dv),
             qn=f(B, S, H, D), kn=f(B, S, Hk, D), v0=f(B, S, Hk, Dv),
             do=f(B, S, H, Dv), alibi=r.uniform(0.05, 0.5, H).astype(np.float32))
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    valid = np.ones((B, S), bool)
    valid[0, S - 5:] = False            # a padded tail
    valid[1, :] = False                 # rows past the window of the only
    valid[1, :3] = True                 # three valid keys have no key at all
    seg = np.zeros((B, S), np.int32)
    if packed:                          # two packed prompts + padding
        seg[:, 17:S - 5], seg[:, S - 5:] = 1, -1
        pos[:, 17:S - 5] = np.arange(S - 22)
        pos[:, S - 5:] = 0
    o.update(pos=pos, valid=valid, seg=seg, is_sum=r.random((B, S)) < 0.2)
    return o


def _grads_both(o, *, window, nope, reset, packed, sum_iso):
    """(reference grads, port grads), each (dq, dk, dv, dq_nope, dk_nope,
    dv0) with None for streams that are not live."""
    kw = dict(valid_k=o["valid"], sum_isolated=sum_iso)
    if nope or reset or sum_iso:
        kw.update(is_sum_q=o["is_sum"], is_sum_k=o["is_sum"])
    if nope:
        kw["alibi"] = o["alibi"]
    if packed:
        kw.update(seg_q=o["seg"], seg_k=o["seg"])
    rc = dict(y_min=0.05, y_max=0.3, midpoint=window / 2)
    names = ["q", "k", "v"] + (["qn", "kn"] if nope else []) + (
        ["v0"] if reset else [])
    arg = {"qn": "q_nope", "kn": "k_nope", "v0": "v0"}

    def j_fn(*xs):
        x = dict(zip(names, xs))
        extra = {arg[n]: x[n] for n in names[3:]}
        return j_attn(x["q"], x["k"], x["v"], pos_q=jnp.asarray(o["pos"]),
                      pos_k=jnp.asarray(o["pos"]), window=window,
                      reset=JResetConfig(**rc) if reset else None,
                      block_size=8, interpret=True, **extra,
                      **{k: (jnp.asarray(v) if k != "sum_isolated" else v)
                         for k, v in kw.items()})

    _, vjp = jax.vjp(j_fn, *(jnp.asarray(o[n]) for n in names))
    want = dict(zip(names, (np.asarray(g) for g in vjp(jnp.asarray(o["do"])))))

    t_kw = {k: (T(v) if k != "sum_isolated" else v) for k, v in kw.items()}
    t_kw.update({arg[n]: T(o[n]) for n in names[3:]})
    got = windowed_attention_bwd_plain(
        T(o["q"]), T(o["k"]), T(o["v"]), T(o["do"]), pos_q=T(o["pos"]),
        pos_k=T(o["pos"]), window=window,
        reset=ResetConfig(**rc) if reset else None, **t_kw)
    order = ["q", "k", "v", "qn", "kn", "v0"]
    return [want.get(n) for n in order], got


@pytest.mark.parametrize("hk,dv,window,nope,reset,packed,sum_iso", [
    (4, 8, 8, False, False, False, True),     # n_rep 1, plain causal window
    (2, 8, 16, True, False, False, True),     # NoPE+ALiBi
    (2, 6, 8, True, True, False, True),       # + reset, Dv != Dqk
    (1, 8, 8, False, True, False, False),     # n_rep 4, reset only, no iso
    (2, 8, 8, True, False, True, True),       # packed segments
    (1, 6, 16, True, True, True, False),      # everything, iso off
])
def test_backward_matches_reference_vjp(hk, dv, window, nope, reset, packed,
                                        sum_iso):
    o = _operands(hk * 10 + window + nope + 2 * reset, Hk=hk, Dv=dv,
                  packed=packed)
    want, got = _grads_both(o, window=window, nope=nope, reset=reset,
                            packed=packed, sum_iso=sum_iso)
    for name, w, g in zip(("dq", "dk", "dv", "dq_nope", "dk_nope", "dv0"),
                          want, got):
        assert (w is None) == (g is None), name
        if w is not None:
            np.testing.assert_allclose(g.numpy(), w, atol=TOL, err_msg=name)


def test_cpu_gradient_runs_the_plain_version():
    """A CPU tensor that asks for a gradient is differentiated through the
    plain version by autograd, launching (and counting) no kernel."""
    o = _operands(1)
    q, k, v = (T(o[n]).requires_grad_(True) for n in ("q", "k", "v"))
    before = dict(LAUNCHES)
    out = windowed_attention(q, k, v, pos_q=T(o["pos"]), pos_k=T(o["pos"]),
                             window=8, valid_k=T(o["valid"]))
    out.backward(T(o["do"]))
    want = windowed_attention_bwd_plain(
        T(o["q"]), T(o["k"]), T(o["v"]), T(o["do"]), pos_q=T(o["pos"]),
        pos_k=T(o["pos"]), window=8, valid_k=T(o["valid"]))
    for g, w in zip((q.grad, k.grad, v.grad), want):
        assert torch.equal(g, w)
    assert want[3:] == (None, None, None) and LAUNCHES == before


def segment_leakage(attn, lens, *, window, seed, with_sum, target_seg):
    """Largest |gradient| of segment ``target_seg``'s summed output with
    respect to q, k and v at the positions of every other segment, through
    ``attn(q, k, v, **kw)`` (the same layouts as the reference's
    ``tests/test_kernel_grads.py::_leakage_case``)."""
    H, D, S = 2, 8, ((sum(lens) + 7) // 8) * 8
    n_pad = S - sum(lens)
    seg = np.concatenate([np.repeat(np.arange(len(lens)), lens),
                          np.full(n_pad, -1)]).astype(np.int32)
    pos = np.concatenate([np.concatenate([np.arange(n) for n in lens]),
                          np.zeros(n_pad)]).astype(np.int32)
    valid = seg >= 0
    r = np.random.default_rng(seed)
    is_sum = (r.random(S) < 0.25) & valid if with_sum else np.zeros(S, bool)
    x = [T(r.normal(size=(1, S, H, D)).astype(np.float32)) for _ in range(6)]
    q, k, v = (t.requires_grad_(True) for t in x[:3])
    kw = dict(pos_q=T(pos[None]), pos_k=T(pos[None]), window=window,
              seg_q=T(seg[None]), seg_k=T(seg[None]),
              valid_k=T(valid[None]))
    if with_sum:
        kw.update(is_sum_q=T(is_sum[None]), is_sum_k=T(is_sum[None]),
                  q_nope=x[3], k_nope=x[4],
                  alibi=torch.tensor([0.3, 0.1]), v0=x[5],
                  reset=ResetConfig(0.05, 0.3, window / 2))
    sel = T(seg == target_seg)[None, :, None, None]
    torch.where(sel, attn(q, k, v, **kw), 0.0).sum().backward()
    others = T((seg != target_seg) & valid)
    return max(float(g[0, others].abs().max()) for g in (q.grad, k.grad,
                                                         v.grad))


@pytest.mark.parametrize("lens,window,seed,with_sum,target", [
    ([12, 9, 7], 8, 0, True, 1),
    ([5, 17], 4, 1, False, 0),
])
def test_cross_segment_gradient_is_exactly_zero(lens, window, seed, with_sum,
                                                target):
    assert segment_leakage(windowed_attention, lens, window=window,
                           seed=seed, with_sum=with_sum,
                           target_seg=target) == 0.0
