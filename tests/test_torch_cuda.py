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
