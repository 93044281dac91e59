"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip without an NVIDIA card (there is no nvcc or
card on a CPU machine). On the card:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""
import pytest
import torch

from repro_torch import kernels
from repro_torch.core.windowed import ResetConfig
from repro_torch.kernels.decode_attn import (decode_attention,
                                             decode_attention_plain)
from repro_torch.kernels.windowed_attn import (windowed_attention,
                                               windowed_attention_bwd_plain,
                                               windowed_attention_plain)

pytestmark = pytest.mark.cuda
TOL = 1e-4      # fp32 on both sides: only summation order differs


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


@pytest.mark.parametrize("hk,dv,nope,reset", [(2, 64, True, True),
                                              (8, 48, False, True),
                                              (2, 64, True, False)])
def test_windowed_kernel_matches_plain(gen, hk, dv, nope, reset):
    B, S, H, D = 2, 150, 8, 64
    r = lambda *s: torch.randn(s, generator=gen, device="cuda")
    q, k, v = r(B, S, H, D), r(B, S, hk, D), r(B, S, hk, dv)
    pos = torch.arange(S, device="cuda", dtype=torch.int32).expand(B, S)
    is_sum = torch.rand(B, S, generator=gen, device="cuda") < 0.1
    valid = torch.ones(B, S, dtype=torch.bool, device="cuda")
    valid[1, 100:] = False
    kw = dict(pos_q=pos, pos_k=pos, window=40, is_sum_q=is_sum,
              is_sum_k=is_sum, valid_k=valid)
    if nope:
        kw.update(q_nope=r(B, S, H, D), k_nope=r(B, S, hk, D),
                  alibi=torch.rand(H, generator=gen, device="cuda"))
    if reset:
        kw.update(v0=r(B, S, hk, dv), reset=ResetConfig(0.0, 0.3, 20.0))
    before = kernels.LAUNCHES["windowed_attn"]
    o, lse = windowed_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["windowed_attn"] == before + 1
    o_p, lse_p = windowed_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(o, o_p, atol=TOL, rtol=0)
    torch.testing.assert_close(lse, lse_p, atol=TOL, rtol=0)


@pytest.mark.parametrize("hk,window,seg", [(2, 0, True), (8, 30, False),
                                           (1, 30, True)])
def test_decode_kernel_matches_plain(gen, hk, window, seg):
    B, s, H, D, cap = 3, 9, 8, 64, 130
    r = lambda *sh: torch.randn(sh, generator=gen, device="cuda")
    q, k, v = r(B, s, H, D), r(B, cap, hk, D), r(B, cap, hk, D)
    pos_k = torch.full((B, cap), -1, dtype=torch.int32, device="cuda")
    pos_k[0, :90] = torch.arange(90, device="cuda", dtype=torch.int32)
    pos_k[1, :120] = torch.arange(120, device="cuda", dtype=torch.int32)
    pos_q = torch.full((B, s), 125, dtype=torch.int32, device="cuda")
    seg_k = torch.full((B, cap), -1, dtype=torch.int32, device="cuda")
    seg_k[:, 80:90] = 1
    seg_q = torch.randint(0, 2, (B, s), generator=gen, device="cuda",
                          dtype=torch.int32)
    kw = dict(window=window, is_sum_q=torch.rand(B, s, generator=gen,
                                                 device="cuda") < 0.3,
              q_nope=r(B, s, H, D), k_nope=r(B, cap, hk, D),
              alibi=torch.rand(H, generator=gen, device="cuda"))
    if seg:
        kw.update(seg_q=seg_q, seg_k=seg_k)
    o = decode_attention(q, k, v, pos_q, pos_k, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        o, decode_attention_plain(q, k, v, pos_q, pos_k, **kw),
        atol=TOL, rtol=0)
    assert torch.all(o[2] == 0)


@pytest.mark.parametrize("hk,dv,window,nope,reset,packed,sum_iso", [
    (8, 64, 40, False, False, False, True),   # n_rep 1
    (4, 64, 40, True, False, False, True),    # n_rep 2, NoPE+ALiBi
    (2, 48, 70, True, True, False, True),     # n_rep 4, reset, Dv != Dqk
    (2, 64, 40, False, True, True, False),    # packed, isolation off
    (4, 48, 200, True, True, True, True),     # window past S
])
def test_windowed_backward_kernels_match_plain(gen, hk, dv, window, nope,
                                               reset, packed, sum_iso):
    """Kernels 2 (dq) and 3 (dk/dv), through the autograd Function, against
    ``torch.autograd.grad`` of the plain version: padded tails, a row whose
    keys are all padding, [SUM] rows, segments."""
    B, S, H, D = 2, 150, 8, 64
    r = lambda *s: torch.randn(s, generator=gen, device="cuda")
    q, k, v, do = r(B, S, H, D), r(B, S, hk, D), r(B, S, hk, dv), r(B, S, H, dv)
    pos = torch.arange(S, device="cuda", dtype=torch.int32).expand(B, S)
    pos = pos.contiguous()
    valid = torch.ones(B, S, dtype=torch.bool, device="cuda")
    valid[0, 120:] = False
    valid[1, 3:] = False
    seg = torch.zeros(B, S, dtype=torch.int32, device="cuda")
    if packed:
        seg[:, 60:] = 1
        pos[:, 60:] = torch.arange(S - 60, device="cuda", dtype=torch.int32)
    is_sum = torch.rand(B, S, generator=gen, device="cuda") < 0.15
    kw = dict(pos_q=pos, pos_k=pos, window=window, valid_k=valid,
              sum_isolated=sum_iso, is_sum_q=is_sum, is_sum_k=is_sum)
    if nope:
        kw.update(q_nope=r(B, S, H, D), k_nope=r(B, S, hk, D),
                  alibi=torch.rand(H, generator=gen, device="cuda"))
    if reset:
        kw.update(v0=r(B, S, hk, dv), reset=ResetConfig(0.05, 0.3,
                                                         window / 2))
    if packed:
        kw.update(seg_q=seg, seg_k=seg)
    names = [n for n, use in (("q_nope", nope), ("k_nope", nope),
                              ("v0", reset)) if use]
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    extra = {n: kw[n].clone().requires_grad_(True) for n in names}
    before = dict(kernels.LAUNCHES)
    o = windowed_attention(*leaves, **dict(kw, **extra))
    o.backward(do)
    torch.cuda.synchronize()
    for name in ("windowed_attn", "windowed_attn_dq", "windowed_attn_dkv"):
        assert kernels.LAUNCHES[name] == before[name] + 1, name
    got = [t.grad for t in leaves] + [extra[n].grad for n in names]
    want = [g for g in windowed_attention_bwd_plain(q, k, v, do, **kw)
            if g is not None]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=TOL, rtol=0)


def q8_operands(gen, *, B, s, H, hk, d, dv, cap, rope_start, g, base=0):
    """The int8 mode's operands: fp32 truth quantized into codes and
    scales (one group, or two split at ``rope_start``), each row filled
    to its own length from position ``base`` on, with a hole, an empty
    tail whose scales hold arbitrary values, and a burst of two segments
    written after the context."""
    from repro_torch.core.quant import quantize_q8
    r = lambda *sh: torch.randn(sh, generator=gen, device="cuda")
    kf, vf = 1.5 * r(B, cap, hk, d), 1.5 * r(B, cap, hk, dv)
    if g == 2:
        c_q, c_s = quantize_q8(kf[..., :rope_start])
        p_q, p_s = quantize_q8(kf[..., rope_start:])
        k, k_scale = torch.cat([c_q, p_q], -1), torch.stack([c_s, p_s], -1)
    else:
        k, k_s = quantize_q8(kf)
        k_scale = k_s[..., None]
    v, v_scale = quantize_q8(vf)
    pos_k = torch.full((B, cap), -1, dtype=torch.int32, device="cuda")
    seg_k = torch.full((B, cap), -1, dtype=torch.int32, device="cuda")
    pos_q = torch.zeros(B, s, dtype=torch.int32, device="cuda")
    seg_q = (torch.arange(s, device="cuda") * 2 // s).to(torch.int32)
    for b in range(B - 1):                       # the last row stays empty
        n = cap - s - 7 * b - 3
        pos_k[b, :n] = base + torch.arange(n, device="cuda", dtype=torch.int32)
        pos_k[b, n // 3] = -1                    # a hole
        pos_q[b] = base + n + torch.arange(s, device="cuda",
                                           dtype=torch.int32) % (s // 2)
        pos_k[b, n:n + s] = pos_q[b]
        seg_k[b, n:n + s] = seg_q
    empty = pos_k < 0                            # arbitrary scales there
    k_scale[empty] = 1e3 * torch.rand(k_scale[empty].shape, generator=gen,
                                      device="cuda")
    v_scale[empty] = 1e3 * torch.rand(v_scale[empty].shape, generator=gen,
                                      device="cuda")
    return dict(q=r(B, s, H, d), qn=r(B, s, H, d), k=k, v=v,
                k_scale=k_scale, v_scale=v_scale, pos_q=pos_q, pos_k=pos_k,
                seg_q=seg_q.expand(B, s).contiguous(), seg_k=seg_k,
                is_sum=torch.rand(B, s, generator=gen, device="cuda") < 0.3,
                alibi=torch.rand(H, generator=gen, device="cuda"))


@pytest.mark.parametrize("hk,d,dv,rope_start,g,nope,seg,window", [
    (2, 64, 64, 0, 1, True, True, 0),       # GQA geometry, every flag
    (8, 64, 48, 0, 1, False, False, 40),    # n_rep 1, window, Dv != Dqk
    (1, 12, 8, 8, 2, True, True, 0),        # two scale groups (MLA shape)
    (1, 12, 8, 8, 2, True, False, 30),
])
def test_decode_kernel_int8_matches_plain(gen, hk, d, dv, rope_start, g,
                                          nope, seg, window):
    B, s, H, cap = 3, 10, 8, 130
    o = q8_operands(gen, B=B, s=s, H=H, hk=hk, d=d, dv=dv, cap=cap,
                    rope_start=rope_start, g=g, base=1900)
    kw = dict(window=window, k_scale=o["k_scale"], v_scale=o["v_scale"],
              rope_start=rope_start, rope_theta=10000.0)
    if nope:
        kw.update(is_sum_q=o["is_sum"], q_nope=o["qn"], alibi=o["alibi"])
    if seg:
        kw.update(seg_q=o["seg_q"], seg_k=o["seg_k"])
    before = dict(kernels.LAUNCHES)
    got = decode_attention(o["q"], o["k"], o["v"], o["pos_q"], o["pos_k"],
                           **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["decode_attn_q8"] == before["decode_attn_q8"] + 1
    assert kernels.LAUNCHES["decode_attn"] == before["decode_attn"]
    want = decode_attention_plain(o["q"], o["k"], o["v"], o["pos_q"],
                                  o["pos_k"], **kw)
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)
    assert torch.all(got[-1] == 0)


@pytest.mark.parametrize("V,D,B,H", [(64, 8, 4, 3), (1000, 128, 8, 20),
                                     (37, 16, 5, 7), (300, 18, 9, 40),
                                     (300, 10, 6, 12), (300, 200, 3, 33)])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_kernel_matches_plain(gen, V, D, B, H, mode):
    """fp32, bf16 and int8 tables; masked slots hold out-of-range ids; bag
    0 is all invalid. fp32 and int8 within 1e-5 (summation order), bf16
    within 2^-8 |x| + 1e-6 of the plain version in fp32 (the output's
    rounding to bf16)."""
    from repro_torch.core.quant import dequantize_q8, quantize_q8
    from repro_torch.kernels.embedding_bag import (bag_weights, embedding_bag,
                                                   embedding_bag_plain)
    table = torch.randn(V, D, generator=gen, device="cuda")
    ids = torch.randint(0, V, (B, H), generator=gen, device="cuda",
                        dtype=torch.int32)
    valid = torch.rand(B, H, generator=gen, device="cuda") < 0.8
    valid[0] = False
    junk = torch.randint(-2 * V, 3 * V, (B, H), generator=gen, device="cuda",
                         dtype=torch.int32)
    ids = torch.where(valid, ids, junk)
    w = bag_weights(ids, valid, mode=mode)
    before = dict(kernels.LAUNCHES)
    got = embedding_bag(table, ids, valid, mode=mode)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["embedding_bag"] == before["embedding_bag"] + 1
    torch.testing.assert_close(got, embedding_bag_plain(table, ids, w),
                               atol=1e-5, rtol=0)
    assert torch.all(got[0] == 0)
    tb = table.bfloat16()
    got = embedding_bag(tb, ids, valid, mode=mode).float()
    want = embedding_bag_plain(tb, ids, w)
    assert torch.all((got - want).abs() <= 2.0 ** -8 * want.abs() + 1e-6)
    codes, scale = quantize_q8(table)
    got = embedding_bag(codes, ids, valid, mode=mode, table_scale=scale)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["embedding_bag_q8"] == \
        before["embedding_bag_q8"] + 1
    torch.testing.assert_close(
        got, embedding_bag_plain(dequantize_q8(codes, scale), ids, w),
        atol=1e-5, rtol=0)


ROUND_TOL, ROW_TOL = 2.0 ** -8, 1e-3   # chip_smoke.py's bf16 gate


def _hold(got, want):
    """fp32 within TOL; bf16 per element within ROUND_TOL |o| + ROW_TOL
    max|o| over its row (the output's rounding, chip_smoke.py's gate)."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want.float(), atol=TOL, rtol=0)
        return
    want = want.float()
    tol = ROUND_TOL * want.abs() + ROW_TOL * want.abs().amax(-1, keepdim=True)
    assert bool(((got.float() - want).abs() <= tol).all())


def split_operands(gen, *, B, s, H, hk, cap, fills, d=64, dv=64, n_seg=0,
                   hole=None):
    """Rows filled to ``fills`` from position 0 (0: an empty row), the
    burst's queries after them; ``hole`` empties a range of slots in every
    row; with ``n_seg`` the burst is written after the context as that
    many segments. Row 0's first query sits before every key (causal: no
    attendable key)."""
    r = lambda *sh: torch.randn(sh, generator=gen, device="cuda")
    pos_k = torch.full((B, cap), -1, dtype=torch.int32, device="cuda")
    seg_k = torch.full((B, cap), -1, dtype=torch.int32, device="cuda")
    pos_q = torch.zeros(B, s, dtype=torch.int32, device="cuda")
    seg_q = torch.zeros(B, s, dtype=torch.int32, device="cuda")
    ar = lambda n: torch.arange(n, device="cuda", dtype=torch.int32)
    for b, n in enumerate(fills):
        n = min(n, cap - (s if n_seg else 0))
        if n <= 0:
            continue
        pos_k[b, :n] = ar(n) + 5
        pos_q[b] = n + 5 + ar(s)
        if n_seg:
            seg_q[b] = (ar(s) * n_seg // s).to(torch.int32)
            pos_k[b, n:n + s] = pos_q[b]
            seg_k[b, n:n + s] = seg_q[b]
    if hole is not None:
        pos_k[:, hole[0]:hole[1]] = -1
    pos_q[0, 0] = 0                       # before every key of row 0
    return dict(q=r(B, s, H, d), qn=r(B, s, H, d), k=r(B, cap, hk, d),
                kn=r(B, cap, hk, d), v=r(B, cap, hk, dv), pos_q=pos_q,
                pos_k=pos_k, seg_q=seg_q, seg_k=seg_k,
                is_sum=torch.rand(B, s, generator=gen, device="cuda") < 0.3,
                alibi=torch.rand(H, generator=gen, device="cuda"))


# B, s, H, Hk, cap, fills, hole, window: the splits of the redesigned kernel
SPLIT_CASES = {
    "cap_off_tile_and_split": (2, 16, 8, 2, 203, (150, 190), None, 0),
    "cap_below_one_tile": (3, 5, 8, 2, 20, (12, 3, 0), None, 0),
    "empty_split": (2, 16, 8, 2, 300, (280, 290), (40, 230), 0),
    "rows_without_keys": (3, 16, 8, 8, 200, (0, 100, 0), None, 30),
    "n_rep_s_over_256": (2, 64, 32, 4, 300, (200, 230), None, 100),
    "s1": (8, 1, 32, 8, 600, tuple(300 + 30 * b for b in range(8)), None, 0),
    "s16": (8, 16, 32, 8, 600, tuple(300 + 30 * b for b in range(8)), None, 256),
    "s32": (8, 32, 32, 8, 600, tuple(300 + 30 * b for b in range(8)), None, 0),
    "s64": (8, 64, 32, 8, 600, tuple(300 + 30 * b for b in range(8)), None, 256),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("nope,seg", [(False, False), (True, True)])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_decode_kernel_splits_match_plain(gen, case, nope, seg, quant,
                                          dtype):
    """Kernel 4 (both modes, fp32 and bf16 queries) against the plain
    version in fp32 on the same inputs, over the cuts of its split plan;
    rows with no attendable key give exactly 0, and a second call on the
    same inputs gives the same bits."""
    from repro_torch.core.quant import quantize_q8
    B, s, H, hk, cap, fills, hole, window = SPLIT_CASES[case]
    o = split_operands(gen, B=B, s=s, H=H, hk=hk, cap=cap, fills=fills,
                       hole=hole, n_seg=3 if seg else 0)
    q, qn = o["q"].to(dtype), o["qn"].to(dtype)
    kw = dict(window=window)
    if nope:
        kw.update(is_sum_q=o["is_sum"], q_nope=qn, alibi=o["alibi"])
    if seg:
        kw.update(seg_q=o["seg_q"], seg_k=o["seg_k"])
    if quant:
        k, ks = quantize_q8(o["k"])
        v, vs = quantize_q8(o["v"])
        kw.update(k_scale=ks[..., None], v_scale=vs, rope_start=0,
                  rope_theta=10000.0)
        name = "decode_attn_q8"
    else:
        k, v = o["k"].to(dtype), o["v"].to(dtype)
        if nope:
            kw["k_nope"] = o["kn"].to(dtype)
        name = "decode_attn"
    before = kernels.LAUNCHES[name]
    got = decode_attention(q, k, v, o["pos_q"], o["pos_k"], **kw)
    again = decode_attention(q, k, v, o["pos_q"], o["pos_k"], **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 2
    assert torch.equal(got, again)
    f32 = lambda x: x.float() if torch.is_tensor(x) and x.is_floating_point() \
        and x.dtype != torch.float32 else x
    want = decode_attention_plain(f32(q), k if quant else f32(k),
                                  v if quant else f32(v), o["pos_q"],
                                  o["pos_k"],
                                  **{n: f32(x) for n, x in kw.items()})
    _hold(got, want)
    for b, n in enumerate(fills):
        if n == 0:
            assert torch.all(got[b] == 0)
    assert torch.all(got[0, 0] == 0)        # its query precedes every key


# B, s, H, cap, fills, hole, window, r, dr: kernel 4's MLA mode on latent
# operands (one latent key) at minicpm3-4b's geometry (r 256, dr 32) over
# the cuts of its split plan (s=1: ranges of one tile), a latent and rope
# span off the 16-value k-step, and a narrow latent
MLA_CASES = {
    "mla_s1": (8, 1, 40, 600, tuple(300 + 30 * b for b in range(8)), None,
               0, 256, 32),
    "mla_s16": (8, 16, 40, 600, tuple(300 + 30 * b for b in range(8)),
                None, 256, 256, 32),
    "mla_s64": (8, 64, 40, 600, tuple(300 + 30 * b for b in range(8)),
                (40, 100), 0, 256, 32),
    "mla_partial_chunk": (3, 12, 8, 200, (150, 190, 0), None, 30, 136, 24),
    "mla_dv_below_dqk": (2, 16, 8, 203, (150, 190), None, 0, 80, 16),
    # deepseek-v2's geometry (r 512, dr 64, 128 heads): two CTAs of 256
    # value columns a row block; and a latent of 300 (its second chunk 44
    # columns wide) with a rope span of 40
    "mla576_s1": (4, 1, 128, 300, (200, 230, 260, 290), None, 0, 512, 64),
    "mla576_s16": (2, 16, 128, 300, (200, 290), (40, 100), 128, 512, 64),
    "mla576_odd": (3, 12, 8, 200, (150, 190, 0), None, 30, 300, 40),
}


def mla_operands(gen, *, B, s, H, cap, fills, hole, r, dr, n_seg, quant):
    """``split_operands`` as the latent cache holds them: ckv (the latent
    and the values), the raw rope span kpe and its roped view (bf16/fp32),
    or their int8 codes with a scale each per slot; K_nope = [ckv | kpe]
    differs from K = [ckv | kpe_rope] only in the rope span. Returns the
    operands and the keyword arguments of ``decode_attention_mla``."""
    from repro_torch.core.quant import quantize_q8
    from repro_torch.models.layers import apply_rope
    o = split_operands(gen, B=B, s=s, H=H, hk=1, cap=cap, fills=fills,
                       hole=hole, n_seg=n_seg, d=r + dr, dv=r)
    lat = o["k"][:, :, 0]
    o["ckv"], o["kpe"] = lat[..., :r].contiguous(), lat[..., r:].contiguous()
    if quant:
        (o["ckv"], cs), (o["kpe"], ps) = quantize_q8(o["ckv"]), quantize_q8(o["kpe"])
        return o, dict(ckv_scale=cs, kpe_scale=ps, rope_theta=10000.0)
    kpe_rope = apply_rope(o["kpe"][:, :, None], o["pos_k"].clamp(min=0),
                          10000.0)[:, :, 0].contiguous()
    return o, dict(kpe_rope=kpe_rope)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("nope,seg", [(False, False), (True, True)])
@pytest.mark.parametrize("case", list(MLA_CASES))
def test_decode_kernel_mla_mode_matches_plain(gen, case, nope, seg, quant,
                                              dtype):
    """Kernel 4's MLA mode (``decode_attn_mla``, and on int8 latent and
    rope codes, ``decode_attn_mla_q8``) on the latent cache's tensors
    against its plain version in fp32 on the same inputs, as the GQA mode
    is held above; the GQA mode's counts do not move."""
    from repro_torch.kernels.decode_attn import (MLA_KEYS,
                                                 decode_attention_mla,
                                                 decode_attention_mla_plain,
                                                 mla_geometry)
    B, s, H, cap, fills, hole, window, r, dr = MLA_CASES[case]
    o, lat_kw = mla_operands(gen, B=B, s=s, H=H, cap=cap, fills=fills,
                             hole=hole, r=r, dr=dr, n_seg=3 if seg else 0,
                             quant=quant)
    q, qn = o["q"].to(dtype), o["qn"].to(dtype)
    ckv, kpe = o["ckv"], o["kpe"]
    if not quant:
        ckv, kpe = ckv.to(dtype), kpe.to(dtype)
        lat_kw = dict(kpe_rope=lat_kw["kpe_rope"].to(dtype))
    kw = dict(window=window, **lat_kw)
    if nope:
        kw.update(is_sum_q=o["is_sum"], q_nope=qn, alibi=o["alibi"])
    if seg:
        kw.update(seg_q=o["seg_q"], seg_k=o["seg_k"])
    key = MLA_KEYS[mla_geometry(r, dr)]
    name = key + "_q8" if quant else key
    before = dict(kernels.LAUNCHES)
    got = decode_attention_mla(q, ckv, kpe, o["pos_q"], o["pos_k"], **kw)
    again = decode_attention_mla(q, ckv, kpe, o["pos_q"], o["pos_k"], **kw)
    torch.cuda.synchronize()
    moved = {n: c - before[n] for n, c in kernels.LAUNCHES.items()
             if c != before[n]}
    assert moved == {name: 2}
    assert torch.equal(got, again)
    f32 = lambda x: x.float() if torch.is_tensor(x) and x.is_floating_point() \
        and x.dtype != torch.float32 else x
    want = decode_attention_mla_plain(f32(q), f32(ckv), f32(kpe), o["pos_q"],
                                      o["pos_k"],
                                      **{n: f32(x) for n, x in kw.items()})
    _hold(got, want)
    for b, n in enumerate(fills):
        if n == 0:
            assert torch.all(got[b] == 0)
    assert torch.all(got[0, 0] == 0)


@pytest.mark.parametrize("d,dv", [(1088, 1024), (577, 512), (584, 520)])
def test_decode_kernel_refuses_head_dims_past_the_mla_mode(gen, d, dv):
    """The MLA mode stops at a latent of 512 and a rope span of 64
    (deepseek-v2's 576 / 512, its wider geometry): a wider call raises,
    naming both geometries, and launches nothing."""
    from repro_torch.kernels.decode_attn import decode_attention_mla
    z = lambda *sh: torch.zeros(sh, device="cuda")
    pos_q = torch.full((1, 2), 40, dtype=torch.int32, device="cuda")
    pos_k = torch.arange(32, dtype=torch.int32, device="cuda")[None]
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="288/256, 576/512"):
        decode_attention_mla(z(1, 2, 4, d), z(1, 32, dv), z(1, 32, d - dv),
                             pos_q, pos_k, window=0,
                             kpe_rope=z(1, 32, d - dv))
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("d,dv", [(136, 64), (288, 256)])
def test_decode_kernel_gqa_mode_refuses_wide_head_dims(gen, d, dv):
    """``decode_attention`` is the GQA mode on the card: head dims past 128
    raise and name ``decode_attention_mla``, before any launch."""
    z = lambda *sh: torch.zeros(sh, device="cuda")
    pos_q = torch.full((1, 2), 40, dtype=torch.int32, device="cuda")
    pos_k = torch.arange(32, dtype=torch.int32, device="cuda")[None]
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="decode_attention_mla"):
        decode_attention(z(1, 2, 4, d), z(1, 32, 1, d), z(1, 32, 1, dv),
                         pos_q, pos_k, window=0)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("quant", [False, True])
def test_decode_kernel_mla_mode_fits_two_ctas_per_sm(gen, bf16, quant):
    """The CUDA runtime's occupancy calculator gives the MLA kernel
    ``MLA_CTAS_PER_SM`` resident CTAs per SM at minicpm3-4b's decode
    shape, with and without the NoPE stream (registers and shared memory
    both allow it)."""
    from repro_torch.kernels.decode_attn import (MLA_CTAS_PER_SM,
                                                 mla_ctas_per_sm)
    for nope in (False, True):
        assert mla_ctas_per_sm(bf16, quant, nope, 64, 40) == MLA_CTAS_PER_SM


@pytest.mark.parametrize("quant", [False, True])
def test_decode_kernel_mla_mode_wide_geometry_fits_its_ctas(gen, quant):
    """At deepseek-v2's geometry (128 heads, r 512, dr 64, s=64) the
    occupancy calculator gives the wide instance ``MLA_CTAS[(512, 64)]``
    (one) resident CTA per SM for bf16 queries, with and without the NoPE
    stream, and its fp32 instance (the gates') launches too."""
    from repro_torch.kernels.decode_attn import MLA_CTAS, mla_ctas_per_sm
    for nope in (False, True):
        assert mla_ctas_per_sm(True, quant, nope, 64, 128, 512, 64) == \
            MLA_CTAS[(512, 64)]
        assert mla_ctas_per_sm(False, quant, nope, 64, 128, 512, 64) >= 1


def test_embedding_bag_kernel_propagates_nonfinite_rows(gen):
    """As the reference's kernel adds row * w for every slot, an inf row
    under a masked slot (its id clamped onto it) or under a zero-weight
    slot gives NaN, in both modes; other bags are unaffected."""
    from repro_torch.core.quant import quantize_q8
    from repro_torch.kernels.embedding_bag import (bag_weights, embedding_bag,
                                                   embedding_bag_plain)
    V, D, B, H = 50, 18, 4, 6
    table = torch.randn(V, D, generator=gen, device="cuda")
    ids = torch.randint(1, V - 1, (B, H), generator=gen, device="cuda",
                        dtype=torch.int32)
    valid = torch.ones(B, H, dtype=torch.bool, device="cuda")
    weights = torch.ones(B, H, device="cuda")
    ids[0, 2], valid[0, 2] = -7, False      # masked: clamps onto row 0
    ids[1, 4], weights[1, 4] = V - 1, 0.0   # zero weight on row V - 1
    table[0, 3] = float("inf")
    table[V - 1, 5] = float("-inf")
    ids[2:] = ids[2:].clamp(1, V - 2)       # bags 2, 3 never touch them
    w = bag_weights(ids, valid, weights=weights)
    got = embedding_bag(table, ids, valid, weights=weights)
    codes, scale = quantize_q8(table.nan_to_num(posinf=0.0, neginf=0.0))
    scale[0], scale[V - 1] = float("inf"), float("nan")
    got8 = embedding_bag(codes, ids, valid, weights=weights,
                         table_scale=scale)
    torch.cuda.synchronize()
    for out, want in ((got, embedding_bag_plain(table, ids, w)),
                      (got8, embedding_bag_plain(codes, ids, w, scale))):
        assert torch.isnan(out[0, 3]) and torch.isnan(out[1, 5])
        assert bool(torch.isnan(out[:2]).any(-1).all())
        torch.testing.assert_close(out, want, atol=1e-5, rtol=0,
                                   equal_nan=True)
        assert bool(torch.isfinite(out[2:]).all())


# S, D, Dv, Hk, window, nope, reset, packed, sum_iso, empty: the flags of
# kernel 1's tensor-core body (ragged S, a window under one kv tile of 32
# and windows off it, Dv != D, D in {64, 96, 128}, n_rep in {1, 4, 8})
WINDOWED_CASES = {
    "reset_nope_empty_row": (150, 64, 64, 2, 40, True, True, False, True, True),
    "packed_window_under_tile": (190, 64, 48, 1, 20, True, False, True, True, False),
    "d96_reset_packed_ragged": (333, 96, 96, 8, 100, False, True, True, False, True),
    "d128_window_past_s": (300, 128, 128, 2, 1024, True, True, True, True, False),
    "d128_dv64_plain": (257, 128, 64, 8, 64, False, False, False, True, False),
    "d96_dv128_nope_empty_row": (129, 96, 128, 1, 33, True, False, False, False, True),
}
# the same flags at kernel 1's wide head-dim class (q/k up to 192: deepseek-
# v2's 128 + 64), forward only: D 192 and D 136 (off the 16-value k-step)
WINDOWED_192_CASES = {
    "d192_nope_ragged": (333, 192, 128, 8, 100, True, False, False, True, False),
    "d192_reset_packed_empty_row": (190, 192, 128, 2, 40, True, True, True, True, True),
    "d192_dv64_window_past_s": (300, 192, 64, 1, 1024, False, False, False, True, False),
    "d136_dv96_packed": (150, 136, 96, 2, 33, True, False, True, False, False),
}
# kernels 2 and 3's bf16 wide class on wgmma (CTAs of two warpgroups of 64
# query rows or keys), backward only: a packed segment boundary between a
# CTA's two warpgroups (S // 4 = row 64), S ragged against the CTA's 128
# rows (200; 129, whose last CTA's second warpgroup holds no row), and a
# dk/dv band of more q tiles than BAND_TABLE (264: phase B revisits every
# tile; one batch row of 2 heads, for the plain version's S x S scores)
WGMMA_SPLIT_CASES = {
    "d192_segment_between_warpgroups": (256, 192, 128, 2, 100, True, True, True, True, False),
    "d192_s200_reset": (200, 192, 128, 8, 64, False, True, False, True, False),
    "d192_s129_nope_empty_row": (129, 192, 128, 4, 40, True, False, False, True, True),
    "d192_band_past_table": (8448, 192, 128, 1, 8300, True, True, False, True, False),
}
CASE_BH = {"d192_band_past_table": (1, 2)}
# kernel 1's bf16 wide class on wgmma (CTAs of two warpgroups of 64 query
# rows, kv tiles of 64 keys), forward only: S ragged against 128 with
# [SUM] rows in one warpgroup of each CTA (CASE_SUM_ROWS: row 70 in CTA
# 0's second, row 140 in CTA 1's first, none in CTA 2), an empty batch
# row at S 257, and packed segments whose boundaries (rows 75, 200) fall
# inside kv tiles and inside a CTA's second warpgroup
WGMMA_FWD_CASES = {
    "d192_sum_in_one_warpgroup": (300, 192, 128, 2, 100, True, True, False, True, False),
    "d192_s257_empty_row": (257, 192, 128, 8, 64, True, False, False, True, True),
    "d192_segments_inside_tiles": (300, 192, 96, 1, 90, True, True, True, True, False),
}
CASE_SUM_ROWS = {"d192_sum_in_one_warpgroup": (70, 140)}
ALL_CASES = {**WINDOWED_CASES, **WINDOWED_192_CASES, **WGMMA_SPLIT_CASES,
             **WGMMA_FWD_CASES}


def windowed_case_operands(gen, case, dtype, B=None, H=None):
    """Operands of an ALL_CASES entry, B=2 and H=8 unless CASE_BH says
    otherwise: row 0 padded in its tail, the last row without a valid key
    when ``empty``; packed rows hold three prompts whose positions
    restart; [SUM] rows at random (~12 %), or at CASE_SUM_ROWS."""
    S, D, Dv, hk, window, nope, reset, packed, sum_iso, empty = \
        ALL_CASES[case]
    B = CASE_BH.get(case, (2, 8))[0] if B is None else B
    H = CASE_BH.get(case, (2, 8))[1] if H is None else H
    r = lambda *sh: torch.randn(sh, generator=gen, device="cuda").to(dtype)
    pos = torch.arange(S, device="cuda", dtype=torch.int32).repeat(B, 1)
    seg = torch.zeros(B, S, dtype=torch.int32, device="cuda")
    if packed:
        for cut in (S // 4, (2 * S) // 3):
            seg[:, cut:] += 1
            pos[:, cut:] = torch.arange(S - cut, device="cuda",
                                        dtype=torch.int32)
    valid = torch.ones(B, S, dtype=torch.bool, device="cuda")
    valid[0, S - 21:] = False
    if empty:
        valid[-1] = False
    is_sum = torch.rand(B, S, generator=gen, device="cuda") < 0.12
    if case in CASE_SUM_ROWS:
        is_sum = torch.zeros(B, S, dtype=torch.bool, device="cuda")
        is_sum[:, list(CASE_SUM_ROWS[case])] = True
    kw = dict(pos_q=pos, pos_k=pos, window=window, valid_k=valid,
              sum_isolated=sum_iso, is_sum_q=is_sum, is_sum_k=is_sum)
    if nope:
        kw.update(q_nope=r(B, S, H, D), k_nope=r(B, S, hk, D),
                  alibi=torch.rand(H, generator=gen, device="cuda") * 0.5)
    if reset:
        kw.update(v0=r(B, S, hk, Dv), reset=ResetConfig(0.05, 0.3,
                                                         window / 2))
    if packed:
        kw.update(seg_q=seg, seg_k=seg)
    return r(B, S, H, D), r(B, S, hk, D), r(B, S, hk, Dv), kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(WINDOWED_CASES))
def test_windowed_kernel_flags_match_plain(gen, case, dtype):
    """Kernel 1 (mma.sync, fp32 through three-term splits) against the
    plain version in fp32 on the same inputs: o by ``_hold``, lse within
    TOL (fp32) or 1e-3 (bf16, chip_smoke.py's LSE_TOL); a row without a
    valid key gives o = 0 and lse = 1e30; one launch per call."""
    q, k, v, kw = windowed_case_operands(gen, case, dtype)
    before = kernels.LAUNCHES["windowed_attn"]
    o, lse = windowed_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["windowed_attn"] == before + 1
    f32 = lambda x: x.float() if torch.is_tensor(x) and x.is_floating_point() \
        else x
    want, lse_w = windowed_attention_plain(
        f32(q), f32(k), f32(v), **{n: f32(x) for n, x in kw.items()})
    _hold(o, want)
    torch.testing.assert_close(lse, lse_w, rtol=0,
                               atol=TOL if dtype == torch.float32 else 1e-3)
    if WINDOWED_CASES[case][-1]:
        assert torch.all(o[-1] == 0) and torch.all(lse[-1] == 1e30)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(WINDOWED_192_CASES)
                         + list(WGMMA_SPLIT_CASES) + list(WGMMA_FWD_CASES))
def test_windowed_kernel_at_dqk_192_matches_plain(gen, case, dtype):
    """Kernel 1's wide head-dim class (``windowed_attn_192``; bf16: two
    warpgroups a CTA on wgmma; fp32: q and K planes 200 values wide, V's
    136) over the flag cases at Dqk 192 and 136 and the cases of the
    warpgroups' tiles (WGMMA_SPLIT_CASES, WGMMA_FWD_CASES), held as the
    narrow class is above; the narrow class's count does not move, and a
    second call gives the same bits."""
    q, k, v, kw = windowed_case_operands(gen, case, dtype)
    before = dict(kernels.LAUNCHES)
    o, lse = windowed_attention(q, k, v, return_lse=True, **kw)
    o2, lse2 = windowed_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    moved = {n: c - before[n] for n, c in kernels.LAUNCHES.items()
             if c != before[n]}
    assert moved == {"windowed_attn_192": 2}
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    f32 = lambda x: x.float() if torch.is_tensor(x) and x.is_floating_point() \
        else x
    want, lse_w = windowed_attention_plain(
        f32(q), f32(k), f32(v), **{n: f32(x) for n, x in kw.items()})
    _hold(o, want)
    torch.testing.assert_close(lse, lse_w, rtol=0,
                               atol=TOL if dtype == torch.float32 else 1e-3)
    if ALL_CASES[case][-1]:
        assert torch.all(o[-1] == 0) and torch.all(lse[-1] == 1e30)


def test_windowed_kernel_trains_at_dqk_192(gen):
    """With autograd recording at a q/k head dim of 192, the backward runs
    kernels 2 and 3's wide class (``windowed_attn_dq_192``,
    ``windowed_attn_dkv_192``; the 128 class's counts do not move) and
    matches the plain version; a head dim past 192 raises before any
    launch."""
    q, k, v, kw = windowed_case_operands(gen, "d192_nope_ragged",
                                         torch.bfloat16)
    do = torch.randn(q.shape[:3] + (v.shape[3],), generator=gen,
                     device="cuda").to(torch.bfloat16)
    before = dict(kernels.LAUNCHES)
    got = _kernel_grads(q, k, v, do, kw)
    torch.cuda.synchronize()
    moved = {n: c - before[n] for n, c in kernels.LAUNCHES.items()
             if c != before[n]}
    assert moved == {"windowed_attn_192": 1, "windowed_attn_dq_192": 1,
                     "windowed_attn_dkv_192": 1}
    with torch.no_grad():
        o_k = windowed_attention(q, k, v, **kw)
    f32 = lambda x: x.float() if torch.is_tensor(x) and x.is_floating_point() \
        else x
    kw32 = {n: f32(x) for n, x in kw.items()}
    delta = lambda o: (o.float() * do.float()).sum(-1).transpose(1, 2)
    with torch.no_grad():
        o_p, _ = windowed_attention_plain(f32(q), f32(k), f32(v), **kw32)
    want = windowed_attention_bwd_plain(f32(q), f32(k), f32(v), f32(do),
                                        dlse=delta(o_p) - delta(o_k), **kw32)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            _hold_grad(g, w)
    before = dict(kernels.LAUNCHES)
    z = lambda *sh: torch.zeros(sh, device="cuda", requires_grad=True)
    with pytest.raises(ValueError, match="192/128"):
        windowed_attention(z(1, 40, 2, 200), z(1, 40, 2, 200),
                           z(1, 40, 2, 128), pos_q=kw["pos_q"][:1, :40],
                           pos_k=kw["pos_k"][:1, :40], window=16)
    assert kernels.LAUNCHES == before


def _shifted(t):
    """A copy of ``t`` whose base is one element past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("case", ["reset_nope_empty_row",
                                  "d128_window_past_s",
                                  "d192_reset_packed_empty_row",
                                  "d192_nope_ragged",
                                  "d192_sum_in_one_warpgroup",
                                  "d136_dv96_packed"])
def test_windowed_kernel_unaligned_rows_give_the_same_bits(gen, case):
    """bf16 operands whose base is not 16-byte aligned take the path that
    converts each tile from memory in place of cp.async (at Dqk 192, of
    TMA); it stages the same bf16 values, so o and lse are bit for bit
    those of aligned copies."""
    q, k, v, kw = windowed_case_operands(gen, case, torch.bfloat16)
    names = [n for n in ("q_nope", "k_nope", "v0") if n in kw]
    kw2 = dict(kw, **{n: _shifted(kw[n]) for n in names})
    a = windowed_attention(q, k, v, return_lse=True, **kw)
    b = windowed_attention(_shifted(q), _shifted(k), _shifted(v),
                           return_lse=True, **kw2)
    torch.cuda.synchronize()
    assert _shifted(q).data_ptr() % 16 != 0
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("case", ["d128_dv64_plain",
                                  "d192_reset_packed_empty_row"])
def test_windowed_kernel_refuses_a_plan_it_would_not_make(gen, case):
    """The entry point checks the plan the wrapper hands it (q tiles, shared
    memory) against its own and refuses, without launching, one that
    differs: at both head-dim classes, and at Dqk 192 in bf16 the mma.sync
    plan of the 128 class as well."""
    from repro_torch.kernels import load, ptr
    from repro_torch.kernels import windowed_attn as wa
    q, k, v, kw = windowed_case_operands(gen, case, torch.bfloat16)
    full = dict(is_sum_q=None, is_sum_k=None, valid_k=None, seg_q=None,
                seg_k=None, q_nope=None, k_nope=None, alibi=None, v0=None,
                reset=None, sum_isolated=True, scale=None)
    full.update(kw)
    st, live, alibi_f, ints = wa._prepare(q, k, v, **full)
    flags = dict(bf16=True, use_nope=st.use_nope, use_reset=st.use_reset)
    plan = wa.windowed_tile_plan(st.b, st.s, st.h, d=st.d, **flags)
    n_qb = -(-st.s // plan.block_q)
    bad = [(n_qb, plan.smem_bytes + 16), (n_qb + 1, plan.smem_bytes)]
    if st.d > wa.MAX_HEAD_DIM:
        narrow = wa.windowed_tile_plan(st.b, st.s, st.h, **flags)
        assert plan.warpgroups == 2 and narrow.warpgroups == 0
        bad.append((-(-st.s // narrow.block_q), narrow.smem_bytes))
    o = torch.empty(q.shape[:3] + (v.shape[3],), dtype=q.dtype,
                    device="cuda")
    lse = torch.empty(st.b, st.h, st.s, device="cuda")
    lib = load("windowed_attn", wa._ARGTYPES)
    stream = torch.cuda.current_stream().cuda_stream
    qn, kn, v0 = live
    before = dict(kernels.LAUNCHES)
    for n, smem in bad:
        rc = lib.windowed_attn_fwd(
            ptr(q), ptr(qn), ptr(k), ptr(kn), ptr(v), ptr(v0), ptr(alibi_f),
            *map(ptr, ints), ptr(o), ptr(lse), *st.ints(True), n, smem,
            *st.floats(), stream)
        assert rc != 0
    assert kernels.LAUNCHES == before


GRAD_FLOOR = 1e-5    # chip_smoke.py's: of the batch row's largest |gradient|


def _kernel_grads(q, k, v, do, kw):
    """Kernels 2 and 3 through the autograd Function around kernel 1:
    ``(dq, dk, dv, dq_nope, dk_nope, dv0)``, None for streams not live."""
    names = [n for n in ("q_nope", "k_nope", "v0") if kw.get(n) is not None]
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    extra = {n: kw[n].detach().requires_grad_(True) for n in names}
    windowed_attention(*leaves, **dict(kw, **extra)).backward(do)
    got = {n: extra[n].grad for n in names}
    return tuple(t.grad for t in leaves) + tuple(
        got.get(n) for n in ("q_nope", "k_nope", "v0"))


def _hold_grad(got, want):
    """fp32 within TOL; bf16 per element within ROUND_TOL |g| + ROW_TOL
    max|g| over its row + GRAD_FLOOR max|g| over its batch row
    (chip_smoke.py's gate for kernels 2 and 3)."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want.float(), atol=TOL, rtol=0)
        return
    want = want.float()
    floor = want.abs().flatten(1).amax(1).view(-1, *[1] * (want.dim() - 1))
    tol = (ROUND_TOL * want.abs()
           + ROW_TOL * want.abs().amax(-1, keepdim=True) + GRAD_FLOOR * floor)
    assert bool(((got.float() - want).abs() <= tol).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(WINDOWED_CASES))
def test_windowed_backward_flags_match_plain(gen, case, dtype):
    """Kernels 2 (dq) and 3 (dk/dv) on tensor cores over kernel 1's flag
    cases, [SUM] rows spread through every row (~12 %, so the masked
    fragments and phase B of the dk/dv pass run in many tiles), against
    the plain version in fp32 on the same inputs given the kernels' delta
    (``windowed_attention_bwd_plain``'s ``dlse``); one launch of each a
    call, and a second call gives the same bits."""
    q, k, v, kw = windowed_case_operands(gen, case, dtype)
    do = torch.randn(q.shape[:3] + (v.shape[3],), generator=gen,
                     device="cuda").to(dtype)
    before = dict(kernels.LAUNCHES)
    got = _kernel_grads(q, k, v, do, kw)
    again = _kernel_grads(q, k, v, do, kw)
    with torch.no_grad():
        o_k = windowed_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    for name in ("windowed_attn_dq", "windowed_attn_dkv"):
        assert kernels.LAUNCHES[name] == before[name] + 2, name
    for g, a in zip(got, again):
        assert (g is None) == (a is None)
        assert g is None or torch.equal(g, a)
    f32 = lambda x: x.float() if torch.is_tensor(x) and x.is_floating_point() \
        else x
    kw32 = {n: f32(x) for n, x in kw.items()}
    delta = lambda o: (o.float() * do.float()).sum(-1).transpose(1, 2)
    with torch.no_grad():
        o_p, _ = windowed_attention_plain(f32(q), f32(k), f32(v), **kw32)
    want = windowed_attention_bwd_plain(f32(q), f32(k), f32(v), f32(do),
                                        dlse=delta(o_p) - delta(o_k), **kw32)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == dtype
            _hold_grad(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(WINDOWED_192_CASES)
                         + list(WGMMA_SPLIT_CASES))
def test_windowed_backward_at_dqk_192_flags_match_plain(gen, case, dtype):
    """Kernels 2 and 3's wide class (bf16: two warpgroups a CTA on wgmma,
    the gradients in registers; fp32: q, K, q_nope, K_nope planes 200
    values wide, the gradient columns past 128 in shared memory) over the
    Dqk-192 and -136 flag cases and the cases of the warpgroups' tile split
    (WGMMA_SPLIT_CASES), held as the 128 class is above; one launch of
    each wide key a call, none of the 128 class's, and a second call gives
    the same bits."""
    q, k, v, kw = windowed_case_operands(gen, case, dtype)
    do = torch.randn(q.shape[:3] + (v.shape[3],), generator=gen,
                     device="cuda").to(dtype)
    before = dict(kernels.LAUNCHES)
    got = _kernel_grads(q, k, v, do, kw)
    again = _kernel_grads(q, k, v, do, kw)
    with torch.no_grad():
        o_k = windowed_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    moved = {n: c - before[n] for n, c in kernels.LAUNCHES.items()
             if c != before[n]}
    assert moved == {"windowed_attn_192": 3, "windowed_attn_dq_192": 2,
                     "windowed_attn_dkv_192": 2}
    for g, a in zip(got, again):
        assert (g is None) == (a is None)
        assert g is None or torch.equal(g, a)
    f32 = lambda x: x.float() if torch.is_tensor(x) and x.is_floating_point() \
        else x
    kw32 = {n: f32(x) for n, x in kw.items()}
    delta = lambda o: (o.float() * do.float()).sum(-1).transpose(1, 2)
    with torch.no_grad():
        o_p, _ = windowed_attention_plain(f32(q), f32(k), f32(v), **kw32)
    want = windowed_attention_bwd_plain(f32(q), f32(k), f32(v), f32(do),
                                        dlse=delta(o_p) - delta(o_k), **kw32)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == dtype
            _hold_grad(g, w)


@pytest.mark.parametrize("case", ["reset_nope_empty_row",
                                  "d128_window_past_s",
                                  "d192_reset_packed_empty_row",
                                  "d136_dv96_packed"])
def test_windowed_backward_unaligned_rows_give_the_same_bits(gen, case):
    """bf16 operands whose base is not 16-byte aligned take the path that
    converts each tile from memory in place of cp.async; it stages the
    same bf16 values, so every gradient is bit for bit that of aligned
    copies."""
    q, k, v, kw = windowed_case_operands(gen, case, torch.bfloat16)
    do = torch.randn(q.shape[:3] + (v.shape[3],), generator=gen,
                     device="cuda").to(torch.bfloat16)
    names = [n for n in ("q_nope", "k_nope", "v0") if n in kw]
    kw2 = dict(kw, **{n: _shifted(kw[n]) for n in names})
    a = _kernel_grads(q, k, v, do, kw)
    b = _kernel_grads(_shifted(q), _shifted(k), _shifted(v), _shifted(do),
                      kw2)
    torch.cuda.synchronize()
    assert _shifted(q).data_ptr() % 16 != 0
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        assert x is None or torch.equal(x, y)


@pytest.mark.parametrize("case", ["reset_nope_empty_row",
                                  "d192_reset_packed_empty_row"])
@pytest.mark.parametrize("name", ["windowed_attn_dq", "windowed_attn_dkv"])
def test_windowed_backward_refuses_a_plan_it_would_not_make(gen, name, case):
    """Each backward entry point checks the plan the wrapper hands it
    (tiles of the grid, shared memory) against its own and refuses,
    without launching, one that differs, at both head-dim classes."""
    from repro_torch.kernels import load, ptr
    from repro_torch.kernels import windowed_attn as wa
    q, k, v, kw = windowed_case_operands(gen, case, torch.bfloat16)
    full = dict(is_sum_q=None, is_sum_k=None, valid_k=None, seg_q=None,
                seg_k=None, q_nope=None, k_nope=None, alibi=None, v0=None,
                reset=None, sum_isolated=True, scale=None)
    full.update(kw)
    st, live, alibi_f, ints = wa._prepare(q, k, v, **full)
    out, lse = wa._fwd(st, q, k, v, live, alibi_f, ints)
    do = torch.randn_like(out)
    delta = wa._delta(out, do)
    plans = wa.windowed_bwd_plan(st.b, st.s, st.h, st.hk, bf16=True,
                                 use_nope=st.use_nope,
                                 use_reset=st.use_reset, d=st.d)
    dkv = name == "windowed_attn_dkv"
    plan = plans[1] if dkv else plans[0]
    n = plan.grid[0] if dkv else plan.grid[1]
    outs = ([torch.empty_like(k), torch.empty_like(v), torch.empty_like(k),
             torch.empty_like(v)] if dkv else
            [torch.empty_like(q), torch.empty_like(q), None, None])
    lib = load("windowed_attn_bwd", wa._BWD_ARGTYPES)
    stream = torch.cuda.current_stream().cuda_stream
    qn, kn, v0 = live
    before = dict(kernels.LAUNCHES)
    for n_blocks, smem in ((n, plan.smem_bytes + 16), (n + 1, plan.smem_bytes),
                           (n, plans[0 if dkv else 1].smem_bytes)):
        rc = getattr(lib, name)(
            ptr(q), ptr(qn), ptr(k), ptr(kn), ptr(v), ptr(v0), ptr(do),
            ptr(lse), ptr(delta), ptr(alibi_f), *map(ptr, ints),
            *map(ptr, outs), *st.ints(True), n_blocks, smem, *st.floats(),
            stream)
        assert rc != 0
    assert kernels.LAUNCHES == before


def _bag_case(gen, V, D, B, H, view):
    """A (V + 1, D) table and its int8 codes; the table is its first V
    rows, or with ``view`` its last V (a contiguous view whose pointer
    lies D values past the allocation's, so ``bag_plan`` picks a narrower
    vector for most D). Masked slots hold out-of-range ids; bag 0 is all
    invalid."""
    from repro_torch.core.quant import quantize_q8
    full = torch.randn(V + 1, D, generator=gen, device="cuda")
    codes, scale = quantize_q8(full)
    sl = slice(1, V + 1) if view else slice(0, V)
    ids = torch.randint(0, V, (B, H), generator=gen, device="cuda",
                        dtype=torch.int32)
    valid = torch.rand(B, H, generator=gen, device="cuda") < 0.8
    valid[0] = False
    junk = torch.randint(-2 * V, 3 * V, (B, H), generator=gen, device="cuda",
                         dtype=torch.int32)
    weights = torch.randn(B, H, generator=gen, device="cuda")
    return (full[sl], full.bfloat16()[sl], codes[sl], scale[sl],
            torch.where(valid, ids, junk), valid, weights)


@pytest.mark.parametrize("view", [False, True])
@pytest.mark.parametrize("D", [1, 10, 17, 18, 33, 50, 64, 128, 200])
def test_embedding_bag_kernel_widths_and_views_match_plain(gen, D, view):
    """Every vector width and lane grouping of ``bag_plan`` in the three
    modes, on the table and on its view ``[1:]``: bags whose H is not a
    multiple of the rows a step loads, a single bag of a single slot, and
    few bags of many slots (each split over warps; weighted means, as a
    long history is pooled, so that sums stay of order 1 for the absolute
    tolerance). fp32 and int8 within 1e-5, bf16 within 2^-8 |x| + 1e-6 of
    the plain version."""
    from repro_torch.core.quant import dequantize_q8
    from repro_torch.kernels.embedding_bag import (bag_weights, embedding_bag,
                                                   embedding_bag_plain)
    for B, H, mode in ((9, 37, "sum"), (1, 1, "sum"), (3, 300, "mean"),
                       (700, 45, "sum")):
        table, half, codes, scale, ids, valid, weights = _bag_case(
            gen, 300, D, B, H, view)
        if view:
            assert table.data_ptr() % 16 == (4 * D) % 16
        w = bag_weights(ids, valid, mode=mode, weights=weights)
        got = embedding_bag(table, ids, valid, mode=mode, weights=weights)
        torch.testing.assert_close(got, embedding_bag_plain(table, ids, w),
                                   atol=1e-5, rtol=0)
        assert B == 1 or torch.all(got[0] == 0)
        got = embedding_bag(half, ids, valid, mode=mode,
                            weights=weights).float()
        want = embedding_bag_plain(half, ids, w)
        assert torch.all((got - want).abs() <= 2.0 ** -8 * want.abs() + 1e-6)
        got = embedding_bag(codes, ids, valid, mode=mode, weights=weights,
                            table_scale=scale)
        torch.testing.assert_close(
            got, embedding_bag_plain(dequantize_q8(codes, scale), ids, w),
            atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("B,H", [(4096, 100), (6, 500)])
def test_embedding_bag_kernel_two_calls_give_the_same_bits(gen, kind, B, H):
    """No atomics: the plan fixes every sum's order, so two calls (one bag
    a warp, or few bags each split over warps) give the same bits."""
    from repro_torch.kernels.embedding_bag import embedding_bag
    table, half, codes, scale, ids, valid, weights = _bag_case(
        gen, 100_000, 18, B, H, False)
    t, s = {"fp32": (table, None), "bf16": (half, None),
            "int8": (codes, scale)}[kind]
    a = embedding_bag(t, ids, valid, mode="mean", table_scale=s)
    b = embedding_bag(t, ids, valid, mode="mean", table_scale=s)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("quant", [False, True])
def test_embedding_bag_refuses_a_plan_it_would_not_make(gen, quant):
    """Each entry point derives its plan from the pointer and shapes and
    refuses, without launching, a host plan that differs in any field it
    is handed; it launches the plan ``bag_plan`` makes."""
    from repro_torch.kernels import load, ptr, sm_count
    from repro_torch.kernels import embedding_bag as eb
    table, half, codes, scale, ids, valid, weights = _bag_case(
        gen, 300, 18, 40, 30, True)
    t = codes if quant else table
    w = eb.bag_weights(ids, valid)
    out = torch.empty(40, 18, device="cuda")
    plan = eb.bag_plan(40, 30, 18, t.element_size(), t.data_ptr(),
                       sm_count(t.device))
    lib = load("embedding_bag", eb._ARGTYPES)
    stream = torch.cuda.current_stream().cuda_stream

    def call(vec, lanes, steps, split, warps, align):
        if quant:
            return lib.embedding_bag_q8_fwd(
                ptr(t), ptr(scale), ptr(ids), ptr(w), ptr(out), 40, 30, 300,
                18, vec, lanes, steps, split, warps, align, stream)
        return lib.embedding_bag_fwd(
            ptr(t), ptr(ids), ptr(w), ptr(out), 40, 30, 300, 18, 0, vec,
            lanes, steps, split, warps, align, stream)

    good = (plan.vec, plan.lanes_per_row, plan.steps, plan.split, plan.warps,
            plan.align)
    before = dict(kernels.LAUNCHES)
    for k in range(len(good)):
        for bad in (good[k] * 2, max(good[k] // 2, 1) if good[k] > 1 else 3):
            wrong = good[:k] + (bad,) + good[k + 1:]
            assert call(*wrong) != 0, wrong
    assert call(*good) == 0
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == before
    torch.testing.assert_close(
        out, eb.embedding_bag_plain(t, ids, w, scale if quant else None),
        atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# GNN aggregation and multi-target serving: no kernel of their own, but
# equal bits on equal inputs, on the card too
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("aggregator", ["sum", "max", "mean"])
def test_gnn_aggregation_gives_the_same_bits(gen, aggregator):
    """Two forward and backward passes of ``gin_aggregate`` over a graph
    with hub nodes (runs longer than a chunk) give equal bits; the sum is
    within 1e-4 of its CPU value."""
    from repro_torch.models.gnn import gin_aggregate, make_edge_plan
    n, e, d = 3000, 60000, 64
    src = torch.randint(0, n, (e,), generator=gen, device="cuda")
    dst = torch.randint(0, n, (e,), generator=gen, device="cuda")
    dst[: e // 4] = 7                       # a hub: one long run
    valid = torch.rand(e, generator=gen, device="cuda") < 0.9
    plan = make_edge_plan(src, dst, n, valid, chunk_edges=4096)
    h = torch.randn(n, d, generator=gen, device="cuda")
    w = torch.randn(n, d, generator=gen, device="cuda")

    def run():
        x = h.clone().requires_grad_(True)
        out = gin_aggregate(x, aggregator=aggregator, plan=plan)
        torch.sum(torch.where(torch.isfinite(out), out, 0.0) * w).backward()
        return out.detach(), x.grad
    (o1, g1), (o2, g2) = run(), run()
    assert torch.equal(o1, o2) and torch.equal(g1, g2)
    if aggregator == "sum":
        cpu = make_edge_plan(src.cpu(), dst.cpu(), n, valid.cpu())
        torch.testing.assert_close(
            o1.cpu(), gin_aggregate(h.cpu(), plan=cpu), atol=TOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_backward_gives_the_same_bits(gen, cf, dtype):
    """Two forward and backward passes of ``moe_ffn`` (4,096 tokens, 16
    experts top-4, a shared expert; choices dropped at 1.25) give equal
    bits in the input's and every weight's gradient: the dispatch
    gather's gradient gathers each token's slots in rank order, with no
    scatter."""
    from repro_torch.models.moe import init_moe, moe_ffn
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    p = init_moe(g, 256, n_experts=16, moe_d_ff=128, top_k=4, n_shared=1,
                 dtype=dtype, device="cuda", lora_rank=4)
    x = torch.randn(4, 1024, 256, generator=gen, device="cuda").to(dtype)
    w = torch.randn(4, 1024, 256, generator=gen, device="cuda").to(dtype)
    leaves = []

    def collect(t):
        for v in t.values():
            if isinstance(v, dict):
                collect(v)
            elif v.is_floating_point():
                leaves.append(v)
    collect(p)

    def run():
        xt = x.clone().requires_grad_(True)
        for t in leaves:
            t.requires_grad_(True)
            t.grad = None
        out, aux = moe_ffn(p, xt, n_experts=16, top_k=4, capacity_factor=cf)
        (torch.sum(out.float() * w.float()) + aux).backward()
        return [xt.grad] + [t.grad for t in leaves]
    a, b = run(), run()
    assert all(x_ is not None for x_ in a)
    assert all(torch.equal(x_, y_) for x_, y_ in zip(a, b))


def test_multi_target_no_cross_candidate_leakage(gen):
    """A candidate's tokens and length changed: every other candidate's
    score keeps its bits, in bf16 on the card."""
    import dataclasses
    from repro_torch.configs.dti_llama import REPRO
    from repro_torch.core.dti import (build_multi_target_request,
                                      candidate_sum_slots)
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import make_multi_target_prefill_fn
    cfg = dataclasses.replace(REPRO, n_layers=2, param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    params = init_params(cfg, seed=0)
    r = torch.Generator().manual_seed(1)
    toks = lambda n: (torch.randint(8, 1000, (n,), generator=r)).tolist()
    ctx = [toks(5) for _ in range(12)]
    cands = [toks(3 + i % 4) for i in range(8)]
    prefill = make_multi_target_prefill_fn(cfg)

    def scores(cands_):
        row = build_multi_target_request(ctx, cands_, max_len=256)
        batch = {k: torch.from_numpy(v[None]).cuda() for k, v in row.items()}
        return prefill(params, batch)[0, candidate_sum_slots(row)].cpu()
    base = scores(cands)
    mutated = [list(c) for c in cands]
    mutated[2] = toks(len(cands[2]) + 2)
    got = scores(mutated)
    keep = torch.ones(len(cands), dtype=torch.bool)
    keep[2] = False
    assert torch.equal(got[keep], base[keep])
    assert got[2] != base[2]


def test_stream_trains_on_the_kernels_and_restores_bit_equal(gen, tmp_path):
    """Continual training on the card: a small stream trains 2 online
    steps through the kernel path (per step kernel 1 in the forward and the
    remat recompute, kernels 2 and 3 once per layer), publishes, and the
    version restored onto the card equals the trainer's params bit for
    bit."""
    import dataclasses
    from repro_torch.configs.dti_llama import REPRO
    from repro_torch.data.requests import make_event_stream, warm_histories
    from repro_torch.data.synthetic import make_ctr_dataset
    from repro_torch.kernels.windowed_attn import launch_key
    from repro_torch.models.transformer import init_params, named_leaves
    from repro_torch.stream import (IncrementalDTI, OnlineTrainer,
                                    ParamPublisher, ParamSubscriber,
                                    StreamPipeline, make_stream_loss_fn)
    from repro_torch.train.optimizer import OptimizerConfig
    cfg = dataclasses.replace(REPRO, n_layers=2, attn_impl="cuda",
                              lora_rank=4, remat=True,
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    params = init_params(cfg, seed=0)
    ds = make_ctr_dataset(n_users=4, n_items=50, seq_len=16,
                          vocab_size=cfg.vocab_size, seed=0)
    inc = IncrementalDTI(n_ctx=4, k=3, max_len=128)
    for u, (toks, labels) in enumerate(warm_histories(ds, start_frac=0.5)):
        inc.seed_history(u, toks, labels)
    ticks = make_event_stream(ds, n_ticks=3, start_frac=0.5, seed=0)
    pub = ParamPublisher(str(tmp_path))
    trainer = OnlineTrainer(make_stream_loss_fn(cfg, window=32), params,
                            OptimizerConfig(lr=1e-3, trainable="lora"),
                            publisher=pub, publish_every=0)
    keys = [launch_key(f"windowed_attn{k}", cfg.hd)
            for k in ("", "_dq", "_dkv")]
    before = [kernels.LAUNCHES[k] for k in keys]
    trainer.run(StreamPipeline(iter(ticks), inc, batch_size=2).batches(),
                n_steps=2, gen=gen)
    torch.cuda.synchronize()
    assert trainer.step == 2 and trainer.published_version == 2
    got = [kernels.LAUNCHES[k] - b for k, b in zip(keys, before)]
    assert got == [2 * 2 * cfg.n_layers, 2 * cfg.n_layers,
                   2 * cfg.n_layers]
    assert all(torch.isfinite(torch.tensor(h["loss"]))
               for h in trainer.history)
    version, restored = ParamSubscriber(str(tmp_path), params).poll()
    assert version == 2
    for (p, a), (_, b) in zip(named_leaves(restored),
                              named_leaves(trainer.state.params)):
        assert a.device.type == "cuda" and a.dtype == b.dtype, p
        assert torch.equal(a.view(torch.uint8) if a.dim() else a,
                           b.view(torch.uint8) if b.dim() else b), p
