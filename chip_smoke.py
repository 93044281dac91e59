#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # every phase, one card

Phases, each fatal on failure:

1. build  — compile the three CUDA sources from
   ``src/repro_torch/kernels/csrc`` (one nvcc each, started together) for
   sm_90a into the git-ignored ``build/``, and print the card's name and
   power limit.
2. kernels — each kernel against its plain PyTorch version on the card:
   small fp32 shapes over every flag (tolerance 1e-4), then the main
   path's real shapes in bf16 against the plain version in fp32 on the
   same bf16 inputs (a per-row tolerance, stated below). 2a/2c: the
   windowed-attention forward (kernel 1); 2b/2c: decode attention
   (kernel 4); 2d: the backward kernels (dq, dk/dv) through the autograd
   Function, then at the training shape, then cross-segment gradients,
   which must be exactly 0.
3. prefill — the serving path begins: dti-llama ``FULL`` (32 layers,
   Llama-3.1-8B widths, random seeded weights, bf16) scores 8
   sliding-window prompts of ~1,570 tokens through ``CTRServer.score``;
   the windowed kernel must run once per layer.
4. decode — user contexts committed into a contiguous cache in
   valid-padded chunks, then a 6-candidate ``commit=False`` burst with
   segment ids whose scores must match per-candidate prefill; then ring
   steps whose final [SUM] score must match phase 3. The decode kernel
   must run once per layer per step. The serving path's launch counts
   are read here, and cover phases 3 and 4 only.
5. full-width checks — the same weights in fp32 through the kernel path
   and the dense path, prefill and every decode step of phase 4; and the
   bf16 kernel path's drift from fp32 against the bf16 dense path's.
7. training — the training path, with the counts reset before it and
   read after it: the same bf16 weights train LoRA (rank 8,
   ``trainable="lora"``, remat, reset and ALiBi on, window 1024) for 4
   steps of 8 DTI streaming rows of 2048 tokens through
   ``make_train_step`` and ``Trainer``. Per step kernel 1 runs 64 times
   (forward and remat recompute), kernels 2 and 3 32 times each, no plain
   version at all; losses finite; frozen leaves bit for bit unchanged,
   every LoRA leaf (``lora_scale`` too) moved; then ``evaluate_lm`` on 16
   test prompts.
8. fp32 training check — 2 layers at FULL widths in fp32: loss and every
   LoRA gradient, kernel path against dense path.
6. times — prefill call, decode step and train step, peak memory, the
   frozen weight-gradient pass's cost, and each kernel beside its plain
   version and ``scaled_dot_product_attention`` (forward or backward: the
   library yardstick, never used by the port), with CUDA events.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. With no card, or run
outside the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12            # dense bf16 tensor-core peak, same source
SMALL_TOL = 1e-4               # fp32: only summation order differs
# bf16 at the real shapes, against the plain version in fp32 on the same
# bf16 inputs: the kernel also scores and accumulates in fp32, so the two
# differ by the kernel's final rounding of o to bf16 (half a step of its
# 8-bit significand, at most 2^-8 of |o|) and by summation order (~1e-6 of
# the row's scale). Each output element may differ by ROUND_TOL * |o| +
# ROW_TOL * max|o| over its row of Dv values: a dropped mask term moves
# ordinary rows, whose |o| is ~0.05-0.1, by a large share of the row's
# scale, far above ROW_TOL.
ROUND_TOL = 2.0 ** -8
ROW_TOL = 1e-3
LSE_TOL = 1e-3
# p_click at full width. In fp32 the kernel and dense paths differ only in
# summation order: P32_TOL over 32 layers, for prefill and for every
# decode step. That is what holds the kernels at full width. In bf16 the
# two paths round at different places and random-weight layers compound
# the differences: on an H100 they differ by ~2e-2 (PERF.md). So the bf16
# kernel path is held to the fp32 result: its
# drift may not exceed twice the dense path's own bf16 drift plus
# DRIFT_SLACK; and two bf16 kernel paths (burst vs prefill, ring vs
# prefill) agree within P_TOL, a check of the serving logic (cache
# commits, segments, ring slots), not of the kernels' arithmetic.
P32_TOL = 1e-3
# The backward kernels at the training shape are held as the forward is,
# against the plain version given the kernels' own delta = <do, o> (o is
# kernel 1's bf16 output, as in the reference; the plain version takes the
# difference as an lse cotangent, see ``windowed_attention_bwd_plain``),
# plus a floor: where a row's gradient cancels (a query with one
# attendable key has p = 1 and ds = dp - delta = 0), the plain version's
# softmax backward gives exactly 0 while the kernel's dp and the wrapper's
# delta, summed in different orders, leave ~1e-7 of the gradient's scale.
# GRAD_FLOOR is 1e-5 of the largest |gradient| of the batch row.
GRAD_FLOOR = 1e-5
DRIFT_SLACK = 5e-3
P_TOL = 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check_close(name, got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    log(f"  {name}: max|err| {err:.3e} (tol {tol:g})")
    if not err <= tol:
        fail(f"{name}: max|err| {err} > {tol}")
    return err


def check_rows(name, got, want, quiet=False, floor=0.0):
    """Hold a bf16 kernel output against the fp32 plain one, element by
    element, at ROUND_TOL * |want| + ROW_TOL * max|want| over its row
    (+ ``floor``)."""
    want = want.float()
    err = (got.float() - want).abs()
    tol = (ROUND_TOL * want.abs()
           + ROW_TOL * want.abs().amax(dim=-1, keepdim=True) + floor)
    bad = int((err > tol).sum())
    worst = (err / tol.clamp_min(1e-30)).max().item()
    max_err = err.max().item()
    if not quiet or bad:
        log(f"  {name}: max|err| {max_err:.3e}, worst err/tol {worst:.3f} "
            f"(tol {ROUND_TOL:g}|o| + {ROW_TOL:g} max|o_row|)")
    if bad:
        fail(f"{name}: {bad} elements beyond tolerance (worst err/tol "
             f"{worst})")
    return max_err


def _f32(*tensors, **kw):
    """fp32 copies of the floating-point operands, the rest as given."""
    f = lambda t: t.float() if torch.is_tensor(t) and t.is_floating_point() else t
    return [f(t) for t in tensors], {k: f(v) for k, v in kw.items()}


def cuda_ms(fn, iters=10, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# operands
# ---------------------------------------------------------------------------

def windowed_operands(gen, *, B, S, H, Hk, D, Dv, dtype, packed=False,
                      empty_row=False, sum_every=0):
    dev = "cuda"
    f = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)
    o = dict(q=f(B, S, H, D), k=f(B, S, Hk, D), v=f(B, S, Hk, Dv),
             qn=f(B, S, H, D), kn=f(B, S, Hk, D), v0=f(B, S, Hk, Dv),
             alibi=torch.rand(H, generator=gen, device=dev) * 0.5 + 0.02)
    pos = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S).clone()
    valid = torch.ones(B, S, dtype=torch.bool, device=dev)
    valid[0, S - 37:] = False
    if empty_row:
        valid[B - 1] = False
    seg = torch.zeros(B, S, dtype=torch.int32, device=dev)
    if packed:
        cut = S // 3
        seg[:, cut:] = 1
        pos[:, cut:] = torch.arange(S - cut, device=dev, dtype=torch.int32)
    if sum_every:
        is_sum = torch.zeros(B, S, dtype=torch.bool, device=dev)
        is_sum[:, sum_every - 1::sum_every] = True
    else:
        is_sum = torch.rand(B, S, generator=gen, device=dev) < 0.1
    o.update(pos=pos, valid=valid, seg=seg, is_sum=is_sum)
    return o


def windowed_kwargs(o, *, window, nope, reset, packed, sum_iso):
    from repro_torch.core.windowed import ResetConfig
    kw = dict(pos_q=o["pos"], pos_k=o["pos"], window=window,
              valid_k=o["valid"], sum_isolated=sum_iso)
    if nope or reset or sum_iso:
        kw.update(is_sum_q=o["is_sum"], is_sum_k=o["is_sum"])
    if nope:
        kw.update(q_nope=o["qn"], k_nope=o["kn"], alibi=o["alibi"])
    if reset:
        kw.update(v0=o["v0"], reset=ResetConfig(0.0, 0.3, window / 2))
    if packed:
        kw.update(seg_q=o["seg"], seg_k=o["seg"])
    return kw


def decode_operands(gen, *, B, s, H, Hk, D, Dv, cap, dtype, fills,
                    skip_block=False, n_seg=0):
    dev = "cuda"
    f = lambda *sh: torch.randn(sh, generator=gen, device=dev).to(dtype)
    pos_k = torch.full((B, cap), -1, dtype=torch.int32, device=dev)
    seg_k = torch.full((B, cap), -1, dtype=torch.int32, device=dev)
    pos_q = torch.zeros(B, s, dtype=torch.int32, device=dev)
    seg_q = torch.full((B, s), -1, dtype=torch.int32, device=dev)
    for b, n in enumerate(fills):
        if n == 0:          # an empty row: no key at all
            continue
        n = min(n, cap - s)
        pos_k[b, :n] = torch.arange(n, dtype=torch.int32, device=dev)
        if n_seg:   # a burst of n_seg candidates written after the context
            cand = torch.arange(s, device=dev) * n_seg // s
            seg_q[b] = cand.to(torch.int32)
            pos_q[b] = n + torch.arange(s, device=dev, dtype=torch.int32) % (s // n_seg)
            pos_k[b, n:n + s] = pos_q[b]
            seg_k[b, n:n + s] = seg_q[b]
        else:
            pos_q[b] = n + torch.arange(s, device=dev, dtype=torch.int32)
    if skip_block:   # an all-empty 32-slot block inside the filled range
        pos_k[:, 32:64] = -1
    return dict(q=f(B, s, H, D), k=f(B, cap, Hk, D), v=f(B, cap, Hk, Dv),
                qn=f(B, s, H, D), kn=f(B, cap, Hk, D),
                alibi=torch.rand(H, generator=gen, device=dev) * 0.5 + 0.02,
                pos_q=pos_q, pos_k=pos_k, seg_q=seg_q, seg_k=seg_k,
                is_sum=torch.rand(B, s, generator=gen, device=dev) < 0.2)


def decode_kwargs(o, *, window, nope, seg):
    kw = dict(window=window)
    if nope:
        kw.update(is_sum_q=o["is_sum"], q_nope=o["qn"], k_nope=o["kn"],
                  alibi=o["alibi"])
    if seg:
        kw.update(seg_q=o["seg_q"], seg_k=o["seg_k"])
    return kw


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels_small():
    from repro_torch.kernels.decode_attn import (decode_attention,
                                                 decode_attention_plain)
    from repro_torch.kernels.windowed_attn import (windowed_attention,
                                                   windowed_attention_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    log("phase 2a: windowed_attn vs plain, fp32, small shapes")
    cases = [  # window, nope, reset, packed, sum_iso, Hk, Dv, S, empty_row
        (48, False, False, False, False, 2, 64, 256, False),
        (48, True, False, False, True, 2, 64, 200, True),
        (48, True, True, False, True, 8, 64, 200, False),
        (100, False, True, True, True, 2, 48, 256, False),
        (300, True, True, True, False, 1, 64, 200, True),   # window off
        (64, True, False, True, True, 2, 64, 190, False),
    ]
    for window, nope, reset, packed, sum_iso, hk, dv, S, empty in cases:
        o = windowed_operands(gen, B=2, S=S, H=8, Hk=hk, D=64, Dv=dv,
                              dtype=torch.float32, packed=packed,
                              empty_row=empty)
        kw = windowed_kwargs(o, window=window, nope=nope, reset=reset,
                             packed=packed, sum_iso=sum_iso)
        got, lse = windowed_attention(o["q"], o["k"], o["v"],
                                      return_lse=True, **kw)
        torch.cuda.synchronize()
        want, lse_w = windowed_attention_plain(o["q"], o["k"], o["v"], **kw)
        tag = (f"w={window} nope={nope} reset={reset} seg={packed} "
               f"iso={sum_iso} n_rep={8 // hk} Dv={dv} S={S} empty={empty}")
        check_close(f"o   [{tag}]", got, want, SMALL_TOL)
        check_close(f"lse [{tag}]", lse, lse_w, SMALL_TOL)
        if empty and not (got[-1] == 0).all():
            fail("empty row did not give 0")

    log("phase 2b: decode_attn vs plain, fp32, small shapes")
    cases = [  # window, nope, seg, Hk, Dv, s, cap, skip_block, n_seg
        (0, False, False, 2, 64, 5, 200, False, 0),
        (40, True, False, 2, 64, 5, 200, True, 0),
        (0, True, True, 8, 64, 12, 200, False, 3),
        (40, True, True, 1, 48, 12, 190, True, 4),
        (0, True, True, 2, 64, 70, 300, False, 5),   # 280 rows: two passes
    ]
    for window, nope, seg, hk, dv, s, cap, skip, n_seg in cases:
        o = decode_operands(gen, B=3, s=s, H=8, Hk=hk, D=64, Dv=dv, cap=cap,
                            dtype=torch.float32, fills=(120, 150, 0),
                            skip_block=skip, n_seg=n_seg)
        kw = decode_kwargs(o, window=window, nope=nope, seg=seg)
        got = decode_attention(o["q"], o["k"], o["v"], o["pos_q"],
                               o["pos_k"], **kw)
        torch.cuda.synchronize()
        want = decode_attention_plain(o["q"], o["k"], o["v"], o["pos_q"],
                                      o["pos_k"], **kw)
        tag = (f"w={window} nope={nope} seg={seg} n_rep={8 // hk} Dv={dv} "
               f"s={s} cap={cap} skip={skip}")
        check_close(f"o [{tag}]", got, want, SMALL_TOL)
        if not (got[2] == 0).all():
            fail("empty cache row did not give 0")


def real_windowed(gen):
    """Kernel 1 at the prefill shape: B=8, S=2048, H=32, Hk=8, D=128,
    window 1024, NoPE + SUM isolation on, a [SUM] every ~200 tokens."""
    o = windowed_operands(gen, B=8, S=2048, H=32, Hk=8, D=128, Dv=128,
                          dtype=torch.bfloat16, sum_every=197)
    kw = windowed_kwargs(o, window=1024, nope=True, reset=False,
                         packed=False, sum_iso=True)
    return o, kw


def real_decode(gen):
    """Kernel 4 at the decode shape: B=8, cap=2048, s=64, H=32, Hk=8,
    D=128, window 1024, a 6-candidate burst over contexts of 1.4k-1.9k."""
    fills = [1400 + 70 * b for b in range(8)]
    o = decode_operands(gen, B=8, s=64, H=32, Hk=8, D=128, Dv=128, cap=2048,
                        dtype=torch.bfloat16, fills=fills, n_seg=6)
    return o, decode_kwargs(o, window=1024, nope=True, seg=True)


def check_kernels_real():
    from repro_torch.kernels.decode_attn import (decode_attention,
                                                 decode_attention_plain)
    from repro_torch.kernels.windowed_attn import (windowed_attention,
                                                   windowed_attention_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    log("phase 2c: real shapes, bf16 kernels vs the fp32 plain version")
    res = {}
    o, kw = real_windowed(gen)
    got, lse = windowed_attention(o["q"], o["k"], o["v"], return_lse=True,
                                  **kw)
    torch.cuda.synchronize()
    args, kw32 = _f32(o["q"], o["k"], o["v"], **kw)
    want, lse_w = windowed_attention_plain(*args, **kw32)
    del args, kw32
    err = check_rows("windowed_attn o   B8 S2048 H32 Hk8 D128 w1024", got,
                     want)
    check_close("windowed_attn lse", lse, lse_w, LSE_TOL)
    res["windowed_attn"] = dict(err=err, ops=(o, kw))
    del got, want, lse, lse_w

    o, kw = real_decode(gen)
    got = decode_attention(o["q"], o["k"], o["v"], o["pos_q"], o["pos_k"], **kw)
    torch.cuda.synchronize()
    args, kw32 = _f32(o["q"], o["k"], o["v"], o["pos_q"], o["pos_k"], **kw)
    want = decode_attention_plain(*args, **kw32)
    del args, kw32
    err = check_rows("decode_attn o B8 cap2048 s64 H32 Hk8 D128 w1024", got,
                     want)
    res["decode_attn"] = dict(err=err, ops=(o, kw))
    return res


# ---------------------------------------------------------------------------
# phase 2d: the backward kernels against their plain version
# ---------------------------------------------------------------------------

GRADS = ("dq", "dk", "dv", "dq_nope", "dk_nope", "dv0")
PASS_GRADS = {"windowed_attn_dq": ("dq", "dq_nope"),
              "windowed_attn_dkv": ("dk", "dv", "dk_nope", "dv0")}


def kernel_grads(q, k, v, do, **kw):
    """Kernels 2 and 3 through the autograd Function around kernel 1:
    ``(dq, dk, dv, dq_nope, dk_nope, dv0)``, None for streams not live."""
    from repro_torch.kernels.windowed_attn import windowed_attention
    names = [n for n in ("q_nope", "k_nope", "v0") if kw.get(n) is not None]
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    extra = {n: kw[n].detach().requires_grad_(True) for n in names}
    windowed_attention(*leaves, **dict(kw, **extra)).backward(do)
    got = {n: extra[n].grad for n in names}
    return tuple(t.grad for t in leaves) + tuple(
        got.get(n) for n in ("q_nope", "k_nope", "v0"))


def train_windowed(gen):
    """Kernels 2 and 3 at the training shape of phase 7: B=8, S=2048,
    H=32, Hk=8, D=128, window 1024, NoPE + reset + [SUM] isolation, 20
    [SUM] rows in each row's tail as streaming prompts place them, and
    padded tails of 8-60 slots."""
    o = windowed_operands(gen, B=8, S=2048, H=32, Hk=8, D=128, Dv=128,
                          dtype=torch.bfloat16)
    B, S = o["valid"].shape
    o["is_sum"] = torch.zeros(B, S, dtype=torch.bool, device="cuda")
    o["valid"] = torch.ones(B, S, dtype=torch.bool, device="cuda")
    for b in range(B):
        n = S - 8 - 7 * b
        o["valid"][b, n:] = False
        o["is_sum"][b, n - 1 - 7 * torch.arange(20, device="cuda")] = True
    o["do"] = (torch.randn(B, S, 32, 128, generator=gen, device="cuda")
               .to(torch.bfloat16))
    kw = windowed_kwargs(o, window=1024, nope=True, reset=True,
                         packed=False, sum_iso=True)
    return o, kw


def card_leakage(lens, *, window, seed, with_sum, target_seg):
    """Largest |gradient| through kernels 2 and 3 of segment
    ``target_seg``'s summed output with respect to q, k and v at every
    other segment's positions (the layouts of the reference's
    ``tests/test_kernel_grads.py::_leakage_case``)."""
    from repro_torch.core.windowed import ResetConfig
    H, D, S = 2, 8, ((sum(lens) + 7) // 8) * 8
    n_pad = S - sum(lens)
    seg = np.concatenate([np.repeat(np.arange(len(lens)), lens),
                          np.full(n_pad, -1)]).astype(np.int32)
    pos = np.concatenate([np.concatenate([np.arange(n) for n in lens]),
                          np.zeros(n_pad)]).astype(np.int32)
    valid = seg >= 0
    r = np.random.default_rng(seed)
    is_sum = (r.random(S) < 0.25) & valid if with_sum else np.zeros(S, bool)
    x = _cuda(*[r.normal(size=(1, S, H, D)).astype(np.float32)
                for _ in range(6)])
    seg_t, pos_t, valid_t, sum_t = _cuda(seg[None], pos[None], valid[None],
                                         is_sum[None])
    kw = dict(pos_q=pos_t, pos_k=pos_t, window=window, seg_q=seg_t,
              seg_k=seg_t, valid_k=valid_t)
    if with_sum:
        kw.update(is_sum_q=sum_t, is_sum_k=sum_t, q_nope=x[3], k_nope=x[4],
                  alibi=torch.tensor([0.3, 0.1], device="cuda"), v0=x[5],
                  reset=ResetConfig(0.05, 0.3, window / 2))
    sel = torch.from_numpy(seg == target_seg).cuda()[None, :, None, None]
    do = sel.float().expand(1, S, H, D).contiguous()
    g = kernel_grads(x[0], x[1], x[2], do, **kw)[:3]
    torch.cuda.synchronize()
    others = torch.from_numpy((seg != target_seg) & valid).cuda()
    return max(float(t[0, others].abs().max()) for t in g)


def check_kernels_bwd():
    """Phase 2d. Off the main path: the launches here are reset before
    phase 3."""
    from repro_torch.kernels.windowed_attn import windowed_attention_bwd_plain
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    log("phase 2d: windowed_attn_dq / windowed_attn_dkv vs plain, fp32, "
        "small shapes")
    cases = [  # window, nope, reset, packed, sum_iso, Hk, Dv, S, empty_row
        (48, False, False, False, False, 8, 64, 256, False),
        (48, True, False, False, True, 4, 64, 200, True),
        (48, True, True, False, True, 2, 48, 200, False),
        (100, False, True, True, True, 2, 48, 256, False),
        (300, True, True, True, False, 1, 64, 200, True),   # window off
        (64, True, False, True, True, 2, 64, 190, False),
    ]
    for window, nope, reset, packed, sum_iso, hk, dv, S, empty in cases:
        o = windowed_operands(gen, B=2, S=S, H=8, Hk=hk, D=64, Dv=dv,
                              dtype=torch.float32, packed=packed,
                              empty_row=empty)
        kw = windowed_kwargs(o, window=window, nope=nope, reset=reset,
                             packed=packed, sum_iso=sum_iso)
        do = torch.randn(2, S, 8, dv, generator=gen, device="cuda")
        got = kernel_grads(o["q"], o["k"], o["v"], do, **kw)
        torch.cuda.synchronize()
        want = windowed_attention_bwd_plain(o["q"], o["k"], o["v"], do, **kw)
        tag = (f"w={window} nope={nope} reset={reset} seg={packed} "
               f"iso={sum_iso} n_rep={8 // hk} Dv={dv} S={S} empty={empty}")
        for name, g, w in zip(GRADS, got, want):
            if (g is None) != (w is None):
                fail(f"{name} [{tag}]: stream live on one side only")
            if g is not None:
                check_close(f"{name:7s} [{tag}]", g, w, SMALL_TOL)

    log("phase 2d: training shape, bf16 kernels vs the fp32 plain version")
    from repro_torch.kernels.windowed_attn import (windowed_attention,
                                                   windowed_attention_plain)
    o, kw = train_windowed(gen)
    got = kernel_grads(o["q"], o["k"], o["v"], o["do"], **kw)
    with torch.no_grad():
        o_k = windowed_attention(o["q"], o["k"], o["v"], **kw)
    torch.cuda.synchronize()
    delta = lambda out, do: (out.float() * do.float()).sum(-1).transpose(1, 2)
    errs = {}
    for b in range(o["q"].shape[0]):       # the plain version row by row
        row = lambda t: (t[b:b + 1].float() if t.is_floating_point()
                         else t[b:b + 1])
        kwb = {n: (row(t) if torch.is_tensor(t) and t.dim() >= 2 else t)
               for n, t in kw.items()}
        args = (row(o["q"]), row(o["k"]), row(o["v"]))
        with torch.no_grad():
            o_p, _ = windowed_attention_plain(*args, **kwb)
        dlse = delta(o_p, row(o["do"])) - delta(o_k[b:b + 1], o["do"][b:b + 1])
        want = windowed_attention_bwd_plain(*args, row(o["do"]), dlse=dlse,
                                            **kwb)
        for name, g, w in zip(GRADS, got, want):
            if g is None:
                continue
            errs[name] = max(errs.get(name, 0.0), check_rows(
                f"{name:7s} row {b}", g[b:b + 1], w, quiet=True,
                floor=GRAD_FLOOR * float(w.abs().max())))
    for name in GRADS:
        log(f"  {name}: max|err| over 8 rows {errs[name]:.3e}")
    t0 = time.perf_counter()
    plain_ms = cuda_ms(lambda: windowed_attention_bwd_plain(
        o["q"], o["k"], o["v"], o["do"], **kw), iters=1, warmup=1)
    log(f"  plain backward at B=8 (bf16 inputs, fp32 scores): "
        f"{plain_ms:.2f} ms ({time.perf_counter() - t0:.1f}s)")

    log("phase 2d: cross-segment gradients through the kernels")
    for lens, window, seed, with_sum, target in (([12, 9, 7], 8, 0, True, 1),
                                                 ([5, 17], 4, 1, False, 0)):
        leak = card_leakage(lens, window=window, seed=seed,
                            with_sum=with_sum, target_seg=target)
        log(f"  segments {lens} window {window} [SUM] {with_sum}: largest "
            f"cross-segment |grad| {leak}")
        if leak != 0.0:
            fail(f"gradient leaks across segments: {leak}")
    return {name: dict(err=max(errs[g] for g in grads), ops=(o, kw),
                       plain_ms=plain_ms)
            for name, grads in PASS_GRADS.items()}


# ---------------------------------------------------------------------------
# phases 3 and 4: the serving path at full width
# ---------------------------------------------------------------------------

def build_model():
    from repro_torch.configs.dti_llama import FULL
    from repro_torch.models.transformer import init_params
    t0 = time.perf_counter()
    params = init_params(FULL, seed=0)
    # nonzero LoRA B (zero at init) so the adapters take part
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)

    def lora(t):
        for k, v in t.items():
            if k == "lora_b":
                v.copy_(torch.randn(v.shape, generator=gen, device="cuda") * 0.01)
            elif isinstance(v, dict):
                lora(v)
    for lp in params["layers"]:
        lora(lp)
    torch.cuda.synchronize()
    n = sum(p.numel() for lp in params["layers"] for p in _leaves(lp))
    log(f"  FULL params on card: {n / 1e9:.2f}B per-layer weights + embed/"
        f"head, {torch.cuda.memory_allocated() / 2**30:.1f} GiB, "
        f"{time.perf_counter() - t0:.1f}s")
    return FULL, params


def _leaves(t):
    for v in t.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


N_CTX, MAX_LEN, N_CAND = 260, 2048, 6


def serving_material(cfg):
    from repro_torch.core.dti import build_sliding_prompts
    from repro_torch.data.synthetic import make_ctr_dataset
    ds = make_ctr_dataset(n_users=8, n_items=400, seq_len=N_CTX + N_CAND + 1,
                          vocab_size=cfg.vocab_size, seed=0)
    users = []
    for u in range(8):
        toks, labels = ds.user_prompt_material(u)
        users.append((toks, labels))
    prompts = [build_sliding_prompts(t, l, n_ctx=N_CTX, max_len=MAX_LEN)[0]
               for t, l in users]
    return users, prompts


def _score(cfg, params, prompts, impl, batch=8):
    from repro_torch.serve.engine import CTRServer
    server = CTRServer(params, dataclasses.replace(cfg, attn_impl=impl),
                       max_len=MAX_LEN)
    return np.asarray([p for i in range(0, len(prompts), batch)
                       for p in server.score(prompts[i:i + batch])])


def phase_prefill(cfg, params, prompts, kernels):
    """The main path's prefill: ``CTRServer.score`` in bf16 on kernel 1."""
    from repro_torch.serve.engine import CTRServer
    log("phase 3: prefill, CTRServer.score on 8 sliding-window prompts")
    lens = [int(p["valid"].sum()) for p in prompts]
    log(f"  prompt lengths {lens} (window {cfg.window})")
    server = CTRServer(params, cfg, max_len=MAX_LEN)
    before = kernels.LAUNCHES["windowed_attn"]
    p = np.asarray(server.score(prompts))
    n = kernels.LAUNCHES["windowed_attn"] - before
    if n != cfg.n_layers:
        fail(f"windowed kernel ran {n} times in one prefill, want "
             f"{cfg.n_layers}")
    if not (np.isfinite(p).all() and ((p > 0) & (p < 1)).all()):
        fail(f"p_click not in (0, 1): {p}")
    log(f"  p_click bf16 cuda {p.tolist()}; windowed kernel launches per "
        f"prefill {n}")
    return server, p


def _map_tensors(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tensors(v, fn) for v in tree]
    return fn(tree)


def _chunk_batch(rows, lo, width):
    """Tokens [lo, lo + width) of each row, right-padded with valid=False."""
    B = len(rows)
    toks = np.zeros((B, width), np.int32)
    pos = np.tile(np.arange(lo, lo + width, dtype=np.int32), (B, 1))
    valid = np.zeros((B, width), bool)
    for b, r in enumerate(rows):
        part = r[lo:lo + width]
        toks[b, :len(part)] = part
        valid[b, :len(part)] = True
    return toks, pos, valid


def _cuda(*arrays):
    return [torch.from_numpy(np.asarray(a)).cuda() for a in arrays]


CHUNK, BURST = 256, 64


def _slate(ctx_rows, users, sum_id):
    """The burst: each user's next N_CAND interactions as candidates, each
    closed by a [SUM], with segment ids 0..N_CAND-1 and positions that all
    continue from the end of the committed context."""
    burst = {k: np.zeros((8, BURST), d) for k, d in
             (("tok", np.int32), ("pos", np.int32), ("sum", bool),
              ("valid", bool))}
    burst["seg"] = np.full((8, BURST), -1, np.int32)
    for b, (toks, _) in enumerate(users):
        j, n = 0, len(ctx_rows[b])
        for c_i, c in enumerate(toks[N_CTX:N_CTX + N_CAND]):
            seq = list(c) + [sum_id]
            burst["tok"][b, j:j + len(seq)] = seq
            burst["pos"][b, j:j + len(seq)] = np.arange(n, n + len(seq))
            burst["sum"][b, j + len(seq) - 1] = True
            burst["valid"][b, j:j + len(seq)] = True
            burst["seg"][b, j:j + len(seq)] = c_i
            j += len(seq)
    return burst


def drive_decode(cfg, params, users, kernels):
    """The decode steps of phase 4 on ``cfg.attn_impl``: commit each user's
    context into a contiguous cache in valid-padded chunks of CHUNK, score
    the slate as one ``commit=False`` burst, then stream context + first
    target through a window+64-slot ring in steps of BURST. Each step must
    launch the decode kernel once per layer on the kernel path and never
    on the dense path. Returns the p_click of every valid token of every
    step, in step order, and what phase 4 checks and phase 6 times."""
    from repro_torch.core.dti import SpecialTokens
    from repro_torch.serve.cache import init_lm_cache
    from repro_torch.serve.engine import make_decode_fn
    sp = SpecialTokens()
    per_step = cfg.n_layers if cfg.attn_impl == "cuda" else 0

    def step(fn, *args):
        before = kernels.LAUNCHES["decode_attn"]
        p, cache = fn(params, *args)
        n = kernels.LAUNCHES["decode_attn"] - before
        if n != per_step:
            fail(f"decode kernel ran {n} times in one step, want {per_step}")
        return p.float().cpu().numpy(), cache

    ctx_rows = [[sp.bos] + [t for it in toks[:N_CTX] for t in it]
                for toks, _ in users]
    cache = init_lm_cache(cfg, 8, MAX_LEN, dtype=cfg.cdtype)
    decode = make_decode_fn(cfg, window=cfg.window, ring=False)
    valid_p = []
    for lo in range(0, max(len(r) for r in ctx_rows), CHUNK):
        toks, pos, valid = _chunk_batch(ctx_rows, lo, CHUNK)
        t, ps, v = _cuda(toks, pos, valid)
        p, cache = step(decode, cache, t, ps, torch.zeros_like(v), v)
        valid_p.append(p[valid])
    if cache["cursor"].tolist() != [len(r) for r in ctx_rows]:
        fail("cursor does not equal the committed context lengths")

    burst = _slate(ctx_rows, users, sp.sum)
    bt = _cuda(burst["tok"], burst["pos"], burst["sum"], burst["valid"],
               np.zeros(8, bool), burst["seg"])
    pos0, cur0 = cache["pos"].clone(), cache["cursor"].clone()
    p, cache = step(decode, cache, *bt)
    if not (torch.equal(cache["pos"], pos0)
            and torch.equal(cache["cursor"], cur0)):
        fail("a commit=False burst changed pos/cursor")
    valid_p.append(p[burst["valid"]])
    p_burst = np.stack([p[b, burst["sum"][b]] for b in range(8)])

    ring = init_lm_cache(cfg, 8, cfg.window + 64, dtype=cfg.cdtype)
    rdec = make_decode_fn(cfg, window=cfg.window, ring=True)
    rows = [r + list(toks[N_CTX]) + [sp.sum] for r, (toks, _) in
            zip(ctx_rows, users)]
    p_ring = np.zeros(8)
    for lo in range(0, max(len(r) for r in rows), BURST):
        toks, pos, valid = _chunk_batch(rows, lo, BURST)
        is_sum = np.zeros_like(valid)
        for b, r in enumerate(rows):
            if lo <= len(r) - 1 < lo + BURST:
                is_sum[b, len(r) - 1 - lo] = True
        t, ps, ss, v = _cuda(toks, pos, is_sum, valid)
        p, ring = step(rdec, ring, t, ps, ss, v)
        valid_p.append(p[valid])
        p_ring[is_sum.any(1)] = p[is_sum]
    return dict(valid_p=np.concatenate(valid_p), n_steps=len(valid_p),
                burst=p_burst, ring=p_ring, ring_cap=ring["pos"].shape[1],
                decode=decode, cache=cache, burst_args=bt)


def phase_decode(cfg, params, users, server, p_prefill, kernels):
    """The main path's decode in bf16 on kernel 4; the burst's scores are
    held to per-candidate prefill (kernel 1) and the ring's to phase 3."""
    from repro_torch.core.dti import build_sliding_prompts
    log(f"phase 4: decode, contiguous cache B=8 cap={MAX_LEN}, then a ring")
    run = drive_decode(cfg, params, users, kernels)
    got = run["burst"]
    prompts = []
    for toks, _ in users:
        for c in toks[N_CTX:N_CTX + N_CAND]:
            prompts += build_sliding_prompts(toks[:N_CTX] + [c],
                                             [0] * (N_CTX + 1), n_ctx=N_CTX,
                                             max_len=MAX_LEN)
    calls = range(0, len(prompts), 8)
    want = np.asarray([server.score(prompts[i:i + 8])
                       for i in calls]).reshape(8, N_CAND)
    run["n_prefill_calls"] = len(calls)
    err = float(np.max(np.abs(got - want)))
    log(f"  burst scores row 0 {np.round(got[0], 5).tolist()}")
    log(f"  per-candidate prefill  {np.round(want[0], 5).tolist()}")
    log(f"  max|burst - prefill| over 8x{N_CAND} candidates {err:.3e} "
        f"(tol {P_TOL}); decode kernel launches per step {cfg.n_layers}")
    if not err <= P_TOL:
        fail(f"burst scores differ from per-candidate prefill by {err}")
    err = float(np.max(np.abs(run["ring"] - np.asarray(p_prefill))))
    log(f"  ring ({run['ring_cap']} slots, steps of {BURST}): "
        f"max|p_ring - p_prefill| {err:.3e} (tol {P_TOL}); "
        f"{run['n_steps']} decode steps in all")
    if not err <= P_TOL:
        fail(f"ring stream scores differ from prefill by {err}")
    return run


def phase_full_width_checks(cfg, params, prompts, users, p_bf16, kernels):
    """Off the main path (its launches are already read). The same weights
    in fp32 through the kernel path and the dense path must agree closely,
    for prefill and for every decode step of phase 4: that holds both
    kernels' semantics at full width. The bf16 kernel path may then drift
    from the fp32 result by no more than the bf16 dense path's own drift
    allows."""
    log("phase 5: full-width checks, fp32 kernel path vs dense path")
    p_dense = _score(cfg, params, prompts, "dense")
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    params32 = _map_tensors(params, lambda t: t.float())
    p32 = _score(cfg32, params32, prompts, "cuda")
    p32_dense = _score(cfg32, params32, prompts, "dense", batch=4)
    run = drive_decode(cfg32, params32, users, kernels)
    dec, n_steps = run["valid_p"], run["n_steps"]
    del run
    dec_dense = drive_decode(dataclasses.replace(cfg32, attn_impl="dense"),
                             params32, users, kernels)["valid_p"]
    del params32
    torch.cuda.empty_cache()

    err32 = float(np.abs(p32 - p32_dense).max())
    err_dec = float(np.abs(dec - dec_dense).max())
    drift_cuda = float(np.abs(p_bf16 - p32).max())
    drift_dense = float(np.abs(p_dense - p32).max())
    log(f"  p_click bf16 dense {p_dense.tolist()}")
    log(f"  p_click fp32 cuda  {p32.tolist()}")
    log(f"  fp32 prefill: max|p_cuda - p_dense| {err32:.3e} (tol {P32_TOL})")
    log(f"  fp32 decode: max|p_cuda - p_dense| over {dec.size} tokens of "
        f"{n_steps} steps {err_dec:.3e} (tol {P32_TOL})")
    log(f"  bf16 drift from fp32: cuda path {drift_cuda:.3e}, dense path "
        f"{drift_dense:.3e} (allowed for cuda: 2 x dense + {DRIFT_SLACK})")
    log(f"  bf16: max|p_cuda - p_dense| "
        f"{float(np.abs(p_bf16 - p_dense).max()):.3e}")
    if not err32 <= P32_TOL:
        fail(f"fp32 prefill: kernel path differs from dense by {err32}")
    if not err_dec <= P32_TOL:
        fail(f"fp32 decode: kernel path differs from dense by {err_dec}")
    if not drift_cuda <= 2 * drift_dense + DRIFT_SLACK:
        fail(f"bf16 kernel path drifts {drift_cuda} from fp32, dense path "
             f"{drift_dense}")


# ---------------------------------------------------------------------------
# phases 7 and 8: training at full width
# ---------------------------------------------------------------------------

TRAIN_K, TRAIN_ROWS, TRAIN_STEPS, TRAIN_LEN = 20, 8, 4, 2048
# phase 8, fp32 at 2 layers: the kernel path and the dense path differ in
# summation order only. The loss within LOSS32_TOL; each LoRA leaf's
# gradient within GRAD32_TOL of that leaf's largest |gradient|.
LOSS32_TOL = 1e-5
GRAD32_TOL = 1e-4


def training_material(cfg):
    """DTI streaming prompts at the full vocabulary: one prompt per user
    with TRAIN_K targets and as many context items as make
    ``train_max_len`` 2048; TRAIN_STEPS batches of TRAIN_ROWS rows. And 16
    sliding-window test prompts of other users for ``evaluate_lm``."""
    from repro_torch.core.dti import (batch_prompts, build_sliding_prompts,
                                      build_streaming_prompts, train_max_len,
                                      window_tokens)
    from repro_torch.data.synthetic import make_ctr_dataset
    n_users = TRAIN_ROWS * TRAIN_STEPS + 16
    probe = make_ctr_dataset(n_users=1, n_items=400, seq_len=2,
                             vocab_size=cfg.vocab_size, seed=5)
    avg = probe.avg_item_tokens    # items come first from the seed
    n_ctx = 400
    while train_max_len(n_ctx, TRAIN_K, avg) > TRAIN_LEN:
        n_ctx -= 1
    max_len = train_max_len(n_ctx, TRAIN_K, avg)
    if max_len != TRAIN_LEN:
        fail(f"no n_ctx gives train_max_len {TRAIN_LEN} (avg {avg})")
    ds = make_ctr_dataset(n_users=n_users, n_items=400,
                          seq_len=n_ctx + TRAIN_K, vocab_size=cfg.vocab_size,
                          seed=5)
    prompts, test, labels = [], [], []
    for u in range(n_users):
        toks, lab = ds.user_prompt_material(u)
        if u < TRAIN_ROWS * TRAIN_STEPS:
            prompts += build_streaming_prompts(toks, lab, n_ctx=n_ctx,
                                               k=TRAIN_K, max_len=max_len)
        else:
            test += build_sliding_prompts(toks[-n_ctx - 1:], lab[-n_ctx - 1:],
                                          n_ctx=n_ctx, max_len=max_len)
            labels.append(int(lab[-1]))
    batches = list(batch_prompts(prompts, TRAIN_ROWS))
    window = window_tokens(n_ctx, avg)
    return dict(batches=batches, window=window, n_ctx=n_ctx, avg=avg,
                test=test, test_labels=np.asarray(labels))


def _bits(t):
    """A fingerprint of a tensor's raw bits (sum and sum of squares of its
    16- or 32-bit words)."""
    w = t.view(torch.int16 if t.element_size() == 2 else torch.int32)
    w = w.to(torch.int64)
    return int(w.sum()), int((w * w).sum())


class _PlainCalls:
    """Counts calls of the attention's plain versions while installed."""

    def __init__(self):
        import repro_torch.core.windowed as cw
        import repro_torch.kernels.windowed_attn as wa
        self.n = 0
        self._orig = [(wa, "windowed_attention_plain"),
                      (wa, "attention_dense"), (cw, "attention_dense")]
        self._saved = [getattr(m, a) for m, a in self._orig]
        for (m, a), fn in zip(self._orig, self._saved):
            setattr(m, a, self._wrap(fn))

    def _wrap(self, fn):
        def counted(*args, **kw):
            self.n += 1
            return fn(*args, **kw)
        return counted

    def close(self):
        for (m, a), fn in zip(self._orig, self._saved):
            setattr(m, a, fn)


def phase_train(cfg, params, mat, kernels):
    """The training path: ``make_train_step`` + ``Trainer`` with LoRA rank
    8, ``trainable="lora"``, remat, reset and ALiBi, on the serving
    phases' bf16 weights. Per step: kernel 1 once per layer in the forward
    and once in the remat recompute, kernels 2 and 3 once per layer."""
    from repro_torch.launch.train import evaluate_lm, make_lm_loss_fn
    from repro_torch.models.transformer import named_leaves
    from repro_torch.train.optimizer import OptimizerConfig, is_trainable
    from repro_torch.train.trainer import (Trainer, init_train_state,
                                           make_train_step)
    b0 = mat["batches"][0]
    log(f"phase 7: training, {TRAIN_STEPS} steps of {TRAIN_ROWS} DTI "
        f"streaming rows (n_ctx {mat['n_ctx']}, k {TRAIN_K}, max_len "
        f"{b0['tokens'].shape[1]}, window {mat['window']}, "
        f"{int(b0['valid'].sum())} tokens and {int(b0['is_sum'].sum())} "
        f"targets in batch 1), LoRA rank {cfg.lora_rank}, remat {cfg.remat}")
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=TRAIN_STEPS,
                           trainable="lora")
    named = list(named_leaves(params))
    frozen = {p: (t, _bits(t)) for p, t in named
              if not is_trainable(ocfg, p)}
    lora = {p: t.clone() for p, t in named if is_trainable(ocfg, p)}
    step = make_train_step(make_lm_loss_fn(cfg, mat["window"]), ocfg)
    per_step = []

    def counted(state, batch, gen):
        before = dict(kernels.LAUNCHES)
        out = step(state, batch, gen)
        per_step.append({k: kernels.LAUNCHES[k] - before[k]
                         for k in kernels.LAUNCHES})
        return out

    trainer = Trainer(counted, init_train_state(params, ocfg), log_every=1,
                      log_fn=lambda m: log(f"  {m}"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plain = _PlainCalls()
    kernels.reset_launches()
    try:
        trainer.run(iter(mat["batches"]), n_steps=TRAIN_STEPS)
    finally:
        plain.close()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches per step {per_step}; plain attention calls {plain.n}; "
        f"peak memory {peak / 2**30:.2f} GiB")
    want = {"windowed_attn": 2 * cfg.n_layers,
            "windowed_attn_dq": cfg.n_layers,
            "windowed_attn_dkv": cfg.n_layers, "decode_attn": 0}
    if any(d != want for d in per_step) or len(per_step) != TRAIN_STEPS:
        fail(f"launches per step {per_step}, want {want} x {TRAIN_STEPS}")
    if plain.n:
        fail(f"the plain attention ran {plain.n} times on the card")
    losses = [h["loss"] for h in trainer.history]
    log(f"  losses {losses}; grad norms "
        f"{[h['grad_norm'] for h in trainer.history]}")
    if not all(np.isfinite(losses)):
        fail(f"non-finite loss: {losses}")
    new = dict(named_leaves(trainer.state.params))
    changed = [p for p, (t, bits) in frozen.items()
               if new[p] is not t or _bits(new[p]) != bits]
    if changed:
        fail(f"{len(changed)} frozen leaves changed, e.g. {changed[:3]}")
    # Training state lives in the fp32 masters: every LoRA leaf's must
    # move. A bf16 lora_scale of 2.0 has steps of 2^-7, more than a few
    # steps of lr 1e-3 move it, so its bf16 copy is counted, not required.
    master = dict(named_leaves(trainer.state.opt.master))
    still = [p for p, t in lora.items() if torch.equal(master[p], t.float())]
    still += [p for p, t in lora.items()
              if p[-1] != "lora_scale" and torch.equal(new[p], t)]
    if still:
        fail(f"{len(still)} LoRA leaves did not move, e.g. {still[:3]}")
    scales = [p for p in lora if p[-1] == "lora_scale"]
    moved = sum(1 for p in scales if not torch.equal(new[p], lora[p]))
    log(f"  {len(frozen)} frozen leaves bit for bit unchanged; the fp32 "
        f"masters of all {len(lora)} LoRA leaves moved, and the bf16 "
        f"lora_a/lora_b; {moved} of {len(scales)} bf16 lora_scale moved")
    m = evaluate_lm(trainer.state.params, cfg, mat["window"], mat["test"],
                    mat["test_labels"], batch_size=8)
    log(f"  evaluate_lm on {len(mat['test'])} sliding-window prompts: {m}")
    if not all(np.isfinite(list(m.values()))):
        fail(f"evaluate_lm gave {m}")
    return dict(trainer=trainer, launches=launches, peak=peak,
                step_fn=step, state=trainer.state)


def _lora_grads(cfg, params, batch, window):
    """Loss and the gradient of every LoRA leaf (autograd on those leaves
    only)."""
    from repro_torch.launch.train import make_lm_loss_fn
    from repro_torch.models.transformer import named_leaves
    leaves = [(p, t) for p, t in named_leaves(params) if "lora" in str(p)]
    for _, t in leaves:
        t.requires_grad_(True)
    try:
        loss, _ = make_lm_loss_fn(cfg, window)(params, batch)
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
    finally:
        for _, t in leaves:
            t.requires_grad_(False)
    return float(loss.detach()), {p: g for (p, _), g in zip(leaves, grads)}


def phase_fp32_train_check(cfg, params, mat):
    """Off the main path. Two layers at FULL widths in fp32 (so the dense
    path's score tensors fit), on half of batch 1: the kernel path and the
    dense path must give the same loss and LoRA gradients."""
    log("phase 8: fp32 at 2 layers, kernel path vs dense path: loss and "
        "every LoRA gradient")
    cfg2 = dataclasses.replace(cfg, n_layers=2, param_dtype="float32",
                               compute_dtype="float32")
    p32 = {k: _map_tensors(v, lambda t: t.float()) for k, v in params.items()
           if k != "layers"}
    p32["layers"] = [_map_tensors(lp, lambda t: t.float())
                     for lp in params["layers"][:2]]
    dev = params["embed"].device
    batch = {k: torch.from_numpy(v[:TRAIN_ROWS // 2]).to(dev)
             for k, v in mat["batches"][0].items()}
    got = {impl: _lora_grads(dataclasses.replace(cfg2, attn_impl=impl), p32,
                             batch, mat["window"])
           for impl in ("cuda", "dense")}
    (lc, gc), (ld, gd) = got["cuda"], got["dense"]
    worst, worst_rel = 0.0, 0.0
    for p in gd:
        err = float((gc[p] - gd[p]).abs().max())
        scale = float(gd[p].abs().max())
        worst = max(worst, err)
        worst_rel = max(worst_rel, err / max(scale, 1e-30))
        if not err <= GRAD32_TOL * scale:
            fail(f"LoRA gradient {p}: kernel vs dense {err}, largest "
                 f"|grad| {scale}")
    log(f"  loss cuda {lc:.8f} dense {ld:.8f} (|diff| {abs(lc - ld):.3e}, "
        f"tol {LOSS32_TOL}); {len(gd)} LoRA gradients: max|diff| "
        f"{worst:.3e}, max|diff|/max|grad| per leaf {worst_rel:.3e} (tol "
        f"{GRAD32_TOL})")
    if not abs(lc - ld) <= LOSS32_TOL:
        fail(f"fp32 loss: kernel path {lc} vs dense {ld}")
    del p32, got
    torch.cuda.empty_cache()
    return dict(loss_diff=abs(lc - ld), grad_rel=worst_rel)


# ---------------------------------------------------------------------------
# phase 6: times
# ---------------------------------------------------------------------------

def _bytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _attended_bytes(mask, is_sum_q, *, hk, d, dv, esize):
    """Bytes of K, K_nope and V that these inputs' attended (query, key)
    pairs need, each key read once per (row, kv head): K for the keys an
    ordinary query attends, K_nope for those a [SUM] query attends, V for
    those any query attends. ``mask`` is (B, Sq, Sk), ``is_sum_q`` (B, Sq).
    Returns the bytes and the three key counts."""
    sq = is_sum_q[:, :, None]
    n = (int((mask & ~sq).any(1).sum()), int((mask & sq).any(1).sum()),
         int(mask.any(1).sum()))
    return (n[0] * d + n[1] * d + n[2] * dv) * hk * esize, n


def time_kernels(real):
    """Each kernel, its plain version and SDPA at the real shapes; the
    bound counts what these inputs need: each query row reads q or q_nope,
    the attended keys as ``_attended_bytes`` counts, the index operands,
    and writes o (and lse); FLOPs are 2 (D + Dv) per attended pair and
    head."""
    import torch.nn.functional as F
    from repro_torch.core.windowed import dti_mask
    from repro_torch.kernels.decode_attn import (_decode_mask,
                                                 decode_attention,
                                                 decode_attention_plain)
    from repro_torch.kernels.windowed_attn import (windowed_attention,
                                                   windowed_attention_plain)
    out = {}
    o, kw = real["windowed_attn"]["ops"]
    B, S, H, D = o["q"].shape
    Hk, Dv, e = o["k"].shape[2], o["v"].shape[3], o["q"].element_size()
    ms = cuda_ms(lambda: windowed_attention(o["q"], o["k"], o["v"],
                                            return_lse=True, **kw))
    plain = cuda_ms(lambda: windowed_attention_plain(o["q"], o["k"], o["v"],
                                                     **kw), iters=3, warmup=1)
    mask = dti_mask(o["pos"], o["pos"], window=1024, is_sum_k=o["is_sum"],
                    valid_k=o["valid"])
    kv_bytes, keys = _attended_bytes(mask, o["is_sum"], hk=Hk, d=D, dv=Dv,
                                     esize=e)
    nbytes = (kv_bytes + B * S * H * (D + Dv) * e + B * H * S * 4
              + _bytes(o["pos"], o["pos"], o["is_sum"], o["is_sum"],
                       o["valid"], o["alibi"]))
    flops = int(mask.sum()) * H * 2 * (D + Dv)
    mask = mask[:, None]
    qt, kt, vt = (x.transpose(1, 2) for x in
                  (o["q"], o["k"].repeat_interleave(H // Hk, 2),
                   o["v"].repeat_interleave(H // Hk, 2)))
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                         attn_mask=mask))
    out["windowed_attn"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                bytes=nbytes, flops=flops, keys=keys)
    del mask, qt, kt, vt

    o, kw = real["decode_attn"]["ops"]
    B, s, H, D = o["q"].shape
    Hk, Dv, e = o["k"].shape[2], o["v"].shape[3], o["q"].element_size()
    ms = cuda_ms(lambda: decode_attention(o["q"], o["k"], o["v"], o["pos_q"],
                                          o["pos_k"], **kw))
    plain = cuda_ms(lambda: decode_attention_plain(
        o["q"], o["k"], o["v"], o["pos_q"], o["pos_k"], **kw))
    mask = _decode_mask(o["pos_k"], o["pos_q"], 1024, o["seg_q"], o["seg_k"])
    # K is the roped cache view, K_nope the raw cache the [SUM] rows read
    kv_bytes, keys = _attended_bytes(mask, o["is_sum"], hk=Hk, d=D, dv=Dv,
                                     esize=e)
    nbytes = (kv_bytes + B * s * H * (D + Dv) * e
              + _bytes(o["pos_q"], o["pos_k"], o["is_sum"], o["seg_q"],
                       o["seg_k"], o["alibi"]))
    flops = int(mask.sum()) * H * 2 * (D + Dv)
    mask = mask[:, None]
    qt = o["q"].transpose(1, 2)
    kt = o["k"].repeat_interleave(H // Hk, 2).transpose(1, 2)
    vt = o["v"].repeat_interleave(H // Hk, 2).transpose(1, 2)
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                         attn_mask=mask))
    out["decode_attn"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                              bytes=nbytes, flops=flops, keys=keys)
    return out


def time_train(cfg, params, mat, run):
    """Phase 6 for the training path: the steady step (median of the
    Trainer's steps after the first), targets and non-pad tokens per
    second, peak memory, and what the frozen leaves' weight-gradient pass
    costs: the step against one forward+backward that differentiates the
    LoRA leaves only (the step's optimizer update is a few hundred small
    tensors)."""
    hist = run["trainer"].history
    step_s = float(np.median([h["sec"] for h in hist[1:]]))
    b = mat["batches"][0]
    targets, tokens = int(b["is_sum"].sum()), int(b["valid"].sum())
    batch = {k: torch.from_numpy(v).to(params["embed"].device)
             for k, v in b.items()}
    t_lora = cuda_ms(lambda: _lora_grads(cfg, params, batch, mat["window"]),
                     iters=1, warmup=0)
    out = dict(step_ms=step_s * 1e3, first_s=hist[0]["sec"],
               targets_per_s=targets / step_s, tokens_per_s=tokens / step_s,
               peak_gib=run["peak"] / 2**30, fwd_bwd_lora_ms=t_lora)
    frozen_ms = out["step_ms"] - t_lora
    log(f"  train step B={TRAIN_ROWS} S={TRAIN_LEN} 32 layers: median "
        f"{out['step_ms']:.2f} ms over {len(hist) - 1} steady steps (first "
        f"step {out['first_s']:.2f} s); {out['targets_per_s']:.2f} targets/s, "
        f"{out['tokens_per_s']:.1f} non-pad tokens/s; peak memory "
        f"{out['peak_gib']:.2f} GiB")
    log(f"  forward+backward with the LoRA leaves only differentiated: "
        f"{t_lora:.2f} ms; the step's frozen weight-gradient pass (and its "
        f"norms) costs {frozen_ms:.2f} ms ({frozen_ms / out['step_ms']:.1%} "
        f"of the step)")
    return out


def time_bwd_kernels(bwd):
    """Kernels 2 and 3 at the training shape, each on its own, beside the
    backward of ``scaled_dot_product_attention`` (the library yardstick:
    the same boolean mask, repeated kv heads, no NoPE or reset stream).
    The bound counts the attended pairs of these inputs: 2 (2D + Dv) FLOPs
    per pair and head for dq, 2 (2D + 2Dv) for dk/dv; bytes: q, k, v,
    q_nope, k_nope, v0, o, do, lse and the pass's gradients, once each."""
    import torch.nn.functional as F
    from repro_torch.core.windowed import dti_mask
    from repro_torch.kernels import windowed_attn as wa
    o, kw = bwd["windowed_attn_dq"]["ops"]
    q, k, v, do = o["q"], o["k"], o["v"], o["do"]
    B, S, H, D = q.shape
    Hk, Dv = k.shape[2], v.shape[3]
    fwd_kw = dict(is_sum_q=None, is_sum_k=None, valid_k=None, seg_q=None,
                  seg_k=None, q_nope=None, k_nope=None, alibi=None, v0=None,
                  reset=None, sum_isolated=True, scale=None)
    fwd_kw.update(kw)
    st, live, alibi_f, ints = wa._prepare(q, k, v, **fwd_kw)
    out, lse = wa._fwd(st, q, k, v, live, alibi_f, ints)
    delta = wa._delta(out, do)
    args = (st, q, k, v, live, alibi_f, ints, lse, delta, do)
    bufs = {"windowed_attn_dq": (torch.empty_like(q), torch.empty_like(q)),
            "windowed_attn_dkv": (torch.empty_like(k), torch.empty_like(v),
                                  torch.empty_like(k), torch.empty_like(v))}
    mask = dti_mask(o["pos"], o["pos"], window=1024, is_sum_k=o["is_sum"],
                    valid_k=o["valid"])
    pairs = int(mask.sum())
    ins = _bytes(q, k, v, kw["q_nope"], kw["k_nope"], kw["v0"], out, do,
                 lse)
    flops = {"windowed_attn_dq": pairs * H * 2 * (2 * D + Dv),
             "windowed_attn_dkv": pairs * H * 2 * (2 * D + 2 * Dv)}
    res = {}
    for name, outs in bufs.items():
        ms = cuda_ms(lambda: wa._bwd_pass(name, *args, outs), iters=5,
                     warmup=1)
        res[name] = dict(ms=ms, bytes=ins + _bytes(*outs), flops=flops[name],
                         plain_ms=bwd[name]["plain_ms"])
    rep = H // Hk
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in
                  (q, k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)))
    y = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask[:, None])
    dot = do.transpose(1, 2)
    lib = cuda_ms(lambda: torch.autograd.grad(y, (qt, kt, vt), dot,
                                              retain_graph=True), iters=5,
                  warmup=1)
    for r in res.values():
        r["library_ms"] = lib
    log(f"  attended pairs at the training shape {pairs} (of {B * S * S}); "
        f"SDPA backward {lib:.4f} ms")
    return res


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def main() -> int:
    if len(sys.argv) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository (no "
              "src/repro_torch beside this script)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    log("phase 1: build")
    t0 = time.perf_counter()
    logs = kernels.build()
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  [{name}] {line.strip()}")
    log(f"  built {sorted(logs)} in {time.perf_counter() - t0:.1f}s")
    card = card_line()
    log(card)
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    check_kernels_small()
    real = check_kernels_real()
    bwd = check_kernels_bwd()

    cfg, params = build_model()
    users, prompts = serving_material(cfg)
    kernels.reset_launches()
    server, p_prefill = phase_prefill(cfg, params, prompts, kernels)
    run = phase_decode(cfg, params, users, server, p_prefill, kernels)
    launches = dict(kernels.LAUNCHES)
    want = {"windowed_attn": cfg.n_layers * (1 + run["n_prefill_calls"]),
            "windowed_attn_dq": 0, "windowed_attn_dkv": 0,
            "decode_attn": cfg.n_layers * run["n_steps"]}
    log(f"  serving path launches {launches}: kernel 1 in "
        f"{1 + run['n_prefill_calls']} prefill calls, kernel 4 in "
        f"{run['n_steps']} decode steps")
    if launches != want:
        fail(f"serving path launches {launches}, want {want}")

    phase_full_width_checks(cfg, params, prompts, users, p_prefill, kernels)

    mat = training_material(cfg)
    train = phase_train(cfg, params, mat, kernels)
    log(f"  training path launches {train['launches']}")
    for name, n in train["launches"].items():
        launches[name] += n
    check32 = phase_fp32_train_check(cfg, params, mat)

    log("phase 6: times (CUDA events after warm-up)")
    t_prefill = cuda_ms(lambda: server.score(prompts), iters=3, warmup=1)
    t_decode = cuda_ms(lambda: run["decode"](params, run["cache"],
                                             *run["burst_args"]),
                       iters=5, warmup=1)
    log(f"  prefill call B=8 S=2048 32 layers: {t_prefill:.2f} ms; decode "
        f"burst step B=8 s=64 cap=2048: {t_decode:.2f} ms ({card})")
    del run, server
    t_train = time_train(cfg, params, mat, train)
    del train
    times = time_kernels(real)
    times.update(time_bwd_kernels(bwd))
    errs = {name: r["err"] for name, r in {**real, **bwd}.items()}
    bwd_src = "src/repro/kernels/windowed_attn/windowed_attn_bwd.py"
    src = {"windowed_attn": ("src/repro_torch/kernels/csrc/windowed_attn.cu",
                             "src/repro/kernels/windowed_attn/windowed_attn.py:79"),
           "windowed_attn_dq": ("src/repro_torch/kernels/csrc/windowed_attn_bwd.cu",
                                f"{bwd_src}:112"),
           "windowed_attn_dkv": ("src/repro_torch/kernels/csrc/windowed_attn_bwd.cu",
                                 f"{bwd_src}:145"),
           "decode_attn": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                           "src/repro/kernels/decode_attn/decode_attn.py:116")}
    rows = []
    for name in kernels.KERNELS:
        t = times[name]
        t_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = t["flops"] / BF16_FLOPS * 1e3
        row = dict(name=name, route="cuda", source=src[name][0],
                   replaces=src[name][1], launches=launches[name],
                   max_abs_err=errs[name], ms=t["ms"],
                   plain_ms=t["plain_ms"], bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   library_ms=t["library_ms"])
        log(f"  {name}: {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, sdpa "
            f"{t['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}: {t['bytes'] / 1e6:.1f} MB, "
            f"{t['flops'] / 1e12:.4f} TFLOP), launches {launches[name]}"
            + (f"; keys read per (row, kv head), summed over rows, for "
               f"K/K_nope/V: {t['keys']}" if "keys" in t else ""))
        rows.append(row)
    log(f"  summary: train step {t_train['step_ms']:.2f} ms, peak "
        f"{t_train['peak_gib']:.2f} GiB, fp32 train check loss diff "
        f"{check32['loss_diff']:.3e} grad rel {check32['grad_rel']:.3e} "
        f"({card})")
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
