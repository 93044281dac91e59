#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # every phase, one card

Phases, each fatal on failure:

1. build  — compile both CUDA kernels from ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a (into the git-ignored ``build/``) and print the
   card's name and power limit.
2. kernels — each kernel against its plain PyTorch version on the card:
   small fp32 shapes over every flag (tolerance 1e-4), then the serving
   path's real shapes in bf16 against the plain version in fp32 on the
   same bf16 inputs (a per-row tolerance, stated below).
3. prefill — the main path begins: dti-llama ``FULL`` (32 layers,
   Llama-3.1-8B widths, random seeded weights, bf16) scores 8
   sliding-window prompts of ~1,570 tokens through ``CTRServer.score``;
   the windowed kernel must run once per layer.
4. decode — user contexts committed into a contiguous cache in
   valid-padded chunks, then a 6-candidate ``commit=False`` burst with
   segment ids whose scores must match per-candidate prefill; then ring
   steps whose final [SUM] score must match phase 3. The decode kernel
   must run once per layer per step. The launch counts are read here,
   and cover phases 3 and 4 only.
5. full-width checks — the same weights in fp32 through the kernel path
   and the dense path, prefill and every decode step of phase 4; and the
   bf16 kernel path's drift from fp32 against the bf16 dense path's.
6. times — prefill call, decode step, and each kernel beside its plain
   version and ``scaled_dot_product_attention`` (the library yardstick,
   never used by the port), with CUDA events.

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


def check_rows(name, got, want):
    """Hold a bf16 kernel output against the fp32 plain one, element by
    element, at ROUND_TOL * |want| + ROW_TOL * max|want| over its row."""
    want = want.float()
    err = (got.float() - want).abs()
    tol = (ROUND_TOL * want.abs()
           + ROW_TOL * want.abs().amax(dim=-1, keepdim=True))
    bad = int((err > tol).sum())
    worst = (err / tol.clamp_min(1e-30)).max().item()
    max_err = err.max().item()
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

    cfg, params = build_model()
    users, prompts = serving_material(cfg)
    kernels.reset_launches()
    server, p_prefill = phase_prefill(cfg, params, prompts, kernels)
    run = phase_decode(cfg, params, users, server, p_prefill, kernels)
    launches = dict(kernels.LAUNCHES)
    want = {"windowed_attn": cfg.n_layers * (1 + run["n_prefill_calls"]),
            "decode_attn": cfg.n_layers * run["n_steps"]}
    log(f"  main path launches {launches}: kernel 1 in "
        f"{1 + run['n_prefill_calls']} prefill calls, kernel 4 in "
        f"{run['n_steps']} decode steps")
    if launches != want:
        fail(f"main path launches {launches}, want {want}")

    phase_full_width_checks(cfg, params, prompts, users, p_prefill, kernels)

    log("phase 6: times (CUDA events after warm-up)")
    t_prefill = cuda_ms(lambda: server.score(prompts), iters=3, warmup=1)
    t_decode = cuda_ms(lambda: run["decode"](params, run["cache"],
                                             *run["burst_args"]),
                       iters=5, warmup=1)
    log(f"  prefill call B=8 S=2048 32 layers: {t_prefill:.2f} ms; decode "
        f"burst step B=8 s=64 cap=2048: {t_decode:.2f} ms ({card})")
    times = time_kernels(real)
    src = {"windowed_attn": ("src/repro_torch/kernels/csrc/windowed_attn.cu",
                             "src/repro/kernels/windowed_attn/windowed_attn.py:79"),
           "decode_attn": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                           "src/repro/kernels/decode_attn/decode_attn.py:116")}
    rows = []
    for name in kernels.KERNELS:
        t = times[name]
        t_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = t["flops"] / BF16_FLOPS * 1e3
        row = dict(name=name, route="cuda", source=src[name][0],
                   replaces=src[name][1], launches=launches[name],
                   max_abs_err=real[name]["err"], ms=t["ms"],
                   plain_ms=t["plain_ms"], bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   library_ms=t["library_ms"])
        log(f"  {name}: {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, sdpa "
            f"{t['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}: {t['bytes'] / 1e6:.1f} MB, "
            f"{t['flops'] / 1e12:.4f} TFLOP; keys read per (row, kv head), "
            f"summed over rows, for K/K_nope/V: {t['keys']})")
        rows.append(row)
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
