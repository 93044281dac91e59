"""Decode attention's absorbed-MLA mode on the CPU: ``decode_attention_mla``
takes the latent cache's own tensors (ckv, the roped and raw rope spans;
in int8 their codes and per-slot scales) and must give, bit for bit, what
``decode_attention_plain`` gives on the concatenated operands the serving
engine built before (K = [ckv | kpe_rope], V = ckv, K_nope = [ckv | kpe];
int8: codes [ckv | kpe] with two scale groups split at r), in fp32, bf16
and int8, with [SUM] rows and segments; and it must stay within 1e-4 (fp32)
of the reference's decode kernel (``repro``'s op over
``decode_attention_bshd``, in interpret mode) on those operands, at small
MLA dims."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn.ops import decode_attention as j_decode
from repro_torch.core.quant import quantize_q8
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.decode_attn import (decode_attention_mla,
                                             decode_attention_mla_plain,
                                             decode_attention_plain)
from repro_torch.models.layers import apply_rope

TOL = 1e-4          # fp32 on both sides: only summation order differs
THETA = 10000.0


def _latent(seed, B=3, s=6, H=4, cap=30, r=24, dr=8):
    """A latent cache of three rows at different fill (row 2 empty), the
    burst's queries after row 0's and row 1's keys, a segment burst in
    row 0; fp32 numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.normal(size=sh).astype(np.float32)
    pos_k = np.full((B, cap), -1, np.int32)
    pos_k[0, :12] = np.arange(12)
    pos_k[1, :25] = np.arange(25)
    seg_k = np.full((B, cap), -1, np.int32)
    seg_k[0, 9:12] = [0, 0, 1]
    seg_q = np.zeros((B, s), np.int32)
    seg_q[0] = [0, 0, 1, 1, 1, 1]
    return dict(q=f(B, s, H, r + dr), qn=f(B, s, H, r + dr),
                ckv=f(B, cap, r), kpe=f(B, cap, dr),
                pos_q=np.tile(np.arange(12, 12 + s, dtype=np.int32), (B, 1)),
                pos_k=pos_k, is_sum=rng.random((B, s)) < 0.4,
                alibi=rng.uniform(0.1, 1.0, H).astype(np.float32),
                seg_q=seg_q, seg_k=seg_k)


def _operands(o, mode, nope, seg, window):
    """Torch operands in ``mode`` ("fp32", "bf16", "int8": int8 codes with
    bf16 queries): the in-place ones for ``decode_attention_mla`` and the
    concatenated ones for ``decode_attention_plain``."""
    T = lambda k: torch.from_numpy(o[k])
    dt = torch.float32 if mode == "fp32" else torch.bfloat16
    q, qn = T("q").to(dt), T("qn").to(dt)
    ckv, kpe, pos_k = T("ckv"), T("kpe"), T("pos_k")
    kw = dict(window=window)
    if nope:
        kw.update(is_sum_q=T("is_sum"), q_nope=qn, alibi=T("alibi"))
    if seg:
        kw.update(seg_q=T("seg_q"), seg_k=T("seg_k"))
    if mode == "int8":
        c8, cs = quantize_q8(ckv)
        p8, ps = quantize_q8(kpe)
        mla = (q, c8, p8, dict(kw, ckv_scale=cs, kpe_scale=ps,
                               rope_theta=THETA))
        plain = (q, torch.cat([c8, p8], -1)[:, :, None], c8[:, :, None],
                 dict(kw, k_scale=torch.stack([cs, ps], -1)[:, :, None],
                      v_scale=cs[:, :, None], rope_start=ckv.shape[-1],
                      rope_theta=THETA))
        return mla, plain
    ckv, kpe = ckv.to(dt), kpe.to(dt)
    kpe_rope = apply_rope(kpe[:, :, None], pos_k.clamp(min=0), THETA)[:, :, 0]
    mla = (q, ckv, kpe, dict(kw, kpe_rope=kpe_rope))
    plain = (q, torch.cat([ckv, kpe_rope], -1)[:, :, None], ckv[:, :, None],
             dict(kw, k_nope=(torch.cat([ckv, kpe], -1)[:, :, None]
                              if nope else None)))
    return mla, plain


@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("nope", [False, True])
@pytest.mark.parametrize("seg", [False, True])
def test_mla_matches_plain_on_concatenated_operands(mode, nope, seg):
    """The same bits as the engine's former call, on the CPU (the plain
    version), counting no launch; the empty row gives exactly 0."""
    o = _latent(1)
    (q, ckv, kpe, kw), (pq, k, v, pkw) = _operands(o, mode, nope, seg, 7)
    pos_q, pos_k = torch.from_numpy(o["pos_q"]), torch.from_numpy(o["pos_k"])
    before = dict(LAUNCHES)
    got = decode_attention_mla(q, ckv, kpe, pos_q, pos_k, **kw)
    assert LAUNCHES == before
    want = decode_attention_plain(pq, k, v, pos_q, pos_k, **pkw)
    assert got.dtype == q.dtype and got.shape == (3, 6, 4, 24)
    assert torch.equal(got, want)
    assert torch.equal(decode_attention_mla_plain(q, ckv, kpe, pos_q, pos_k,
                                                  **kw), want)
    assert torch.all(got[2] == 0)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("nope", [False, True])
@pytest.mark.parametrize("window", [0, 7])
def test_mla_matches_reference_kernel(quant, nope, window):
    """fp32 queries against the reference's Pallas decode kernel in
    interpret mode on the concatenated operands (int8: the codes, two
    scale groups split at r, rope inside the kernel), segments on."""
    o = _latent(2)
    r = o["ckv"].shape[-1]
    (q, ckv, kpe, kw), (pq, k, v, pkw) = _operands(
        o, "int8" if quant else "fp32", nope, True, window)
    if quant:
        q, kw["q_nope"] = (torch.from_numpy(o["q"]),
                           torch.from_numpy(o["qn"]) if nope else None)
    pos_q, pos_k = torch.from_numpy(o["pos_q"]), torch.from_numpy(o["pos_k"])
    got = decode_attention_mla(q, ckv, kpe, pos_q, pos_k, **kw)
    J = lambda t: None if t is None else jnp.asarray(t.numpy())
    jkw = dict(window=window, seg_q=J(pkw["seg_q"]), seg_k=J(pkw["seg_k"]),
               block_size=8, interpret=True)
    if nope:
        jkw.update(is_sum_q=J(pkw["is_sum_q"]), q_nope=J(kw["q_nope"]),
                   alibi=J(pkw["alibi"]))
        if not quant:
            jkw["k_nope"] = J(pkw["k_nope"])
    if quant:
        jkw.update(k_scale=J(pkw["k_scale"]), v_scale=J(pkw["v_scale"]),
                   rope_start=r, rope_theta=THETA)
    want = np.asarray(j_decode(J(q), J(k), J(v), J(pos_q), J(pos_k), **jkw))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    assert np.all(got.numpy()[2] == 0.0)


def test_mla_refuses_a_roped_span_in_the_int8_mode():
    """int8 ropes the kpe codes itself: the card's path refuses a roped
    span, in the checks made before any launch."""
    from repro_torch.kernels.decode_attn import _check_mla
    o = _latent(3)
    (q, ckv, kpe, kw), _ = _operands(o, "int8", False, False, 0)
    with pytest.raises(ValueError, match="kpe_rope"):
        _check_mla(q, ckv, kpe, torch.zeros(kpe.shape), True, False,
                   kw["ckv_scale"], kw["kpe_scale"])
