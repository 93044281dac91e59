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
