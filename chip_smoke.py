#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # every phase, one card

Phases, each fatal on failure:

1. build  — compile the four CUDA sources from
   ``src/repro_torch/kernels/csrc`` (one nvcc each, started together) for
   sm_90a into the git-ignored ``build/``, and print the card's name and
   power limit.
2. kernels — each kernel against its plain PyTorch version on the card:
   small fp32 shapes over every flag (tolerance 1e-4), then the main
   path's real shapes in bf16 against the plain version in fp32 on the
   same bf16 inputs (a per-row tolerance, stated below). 2a/2c: the
   windowed-attention forward (kernel 1; 2a runs its flag sweep on bf16
   inputs too, held per row as 2c is); 2b/2c: decode attention
   (kernel 4); 2d: the backward kernels (dq, dk/dv) through the autograd
   Function, then at the training shape with [SUM] rows in each row's tail
   and with [SUM] rows every 7th slot, each case twice (the two calls must
   give the same bits), then cross-segment gradients, which must be
   exactly 0. 2e: decode attention's int8 mode
   (``decode_attn_q8``: int8 K/V codes, fp32 scales in one or two groups,
   RoPE and dequantization inside the kernel) over every flag in fp32,
   then at the decode shape with keys at positions up to 2047. 2f: the
   embedding bag (kernel 5, ``embedding_bag`` on fp32/bf16 tables and
   ``embedding_bag_q8`` on int8 codes with per-row scales) over
   ``tests/test_kernels.py``'s grid, the recsys row widths (10, 18, 50,
   64) and widths 1, 17 and 33, on the table and on its view ``[1:]``
   (int8: ``codes[1:]`` with ``scale[1:]``), so that every vector width
   and lane grouping of ``bag_plan`` runs, sum, mean and weighted, with
   masked out-of-range ids and an all-invalid bag (fp32 and int8 within
   1e-5, bf16 within 2^-8 |x| + 1e-6); then its op path, with the counts
   reset before it and read after it, at the real shapes: DIN's FULL item
   table (2^26 x 18, fp32 and its int8 codes) with 65,536 bags of 100
   slots and MIND's (2^24 x 64) with 512, sum and mean, each held to the
   plain version within 1e-5; then two calls at DIN's shape in each of
   fp32, bf16 and int8 must give the same bits. 2g: decode attention's
   absorbed-MLA mode (``decode_attention_mla``: ``decode_attn_mla``,
   ``decode_attn_mla_q8``) on latent operands, the cache's own tensors
   (ckv, the values too; the roped and raw rope spans; int8: their codes
   and a scale each per slot), in fp32 over every flag (window, segments
   of a commit=False burst, NoPE + ALiBi, latents and rope spans off the
   16-value k-step and off 16-byte rows, int8) within 1e-4, on bf16 inputs
   (and int8 codes) per row, then at minicpm3-4b's decode shape (B=8,
   cap=2048, s=64, 40 heads on one latent key, r 256, dr 32) in bf16 and
   on int8 codes with keys up to position 2047 at phase 2c's per-row
   tolerance, each twice (the same bits). 2h: the wide geometries
   deepseek-v2 brings, under launch keys of their own: kernel 1's Dqk-192
   class (``windowed_attn_192``) over 2a's flags at Dqk 192 and 136 in
   fp32 (1e-4) and bf16 (per row), then at deepseek-v2's prefill shape
   (B=8, S=2048, 128 heads, Dqk 192, Dv 128, window 1024, NoPE) against
   the fp32 plain version a batch row at a time; kernel 4's MLA mode at a
   latent of up to 512 and a rope span of up to 64
   (``decode_attn_mla_576``, ``_q8``) over 2g's flags at r 512 / dr 64,
   300 / 40, 264 / 48 and 392 / 56, then at deepseek-v2's decode shape
   (B=8, cap=2048, s=64, 128 heads, r 512, dr 64) in bf16 and on int8
   codes; each real shape twice (the same bits). 2i: kernels 2 and 3 at
   Dqk 192 / Dv 128 under launch keys of their own
   (``windowed_attn_dq_192``, ``windowed_attn_dkv_192``), as 2d holds the
   128 class: fp32 small shapes over every flag (NoPE, reset, packed
   segments, [SUM] isolation on and off, n_rep 1 and 2, Dqk 192 and 136)
   within 1e-4, bf16 small shapes per row and twice (the same bits), rows
   off 16-byte boundaries bit for bit those of aligned copies; then
   deepseek-v2's training shape (B=8, S=2048, 128 heads, NoPE + reset, a
   [SUM] tail of 20 rows, then every 7th slot) in bf16 against the fp32
   plain version a batch row at a time, twice; cross-segment gradients
   exactly 0.
11. recsys — DIN, MIND, SASRec and xDeepFM in fp32 before the dti-llama
   weights are loaded: (a) FULL widths with tables cut to 2^20 rows
   (xDeepFM: each field to min(v, 2^16)), the card against the CPU on the
   same params: ``recsys_serve_step`` at serve_p99 (512) within 1e-4
   max|logit| + 1e-5, 3 AdamW steps' losses within 1e-4; (b) the FULL
   configs with full tables: serve_p99, a train step at train_batch
   (65,536; xDeepFM 16,384, whose CIN tensors would take ~20 GB a layer at
   65,536), retrieval_cand (1 user x 1,000,000 candidates, chunks of
   8,000); finite, probabilities in (0, 1), timed, peak memory printed.
   serve_bulk (262,144) is not run. The models gather with plain lookups,
   as the reference's do: no kernel launches on this path.
12. minicpm3-4b — its ``FULL`` config (62 layers, d_model 2560, 40
   heads, MLA with kv_lora 256, random seeded bf16 weights) with
   ``attn_impl="cuda"``, before the dti-llama weights are loaded, the counts
   reset before it: phases 3 and 4 on it (``CTRServer.score`` of 8 prompts
   with kernel 1 once per layer at Dqk 96, Dv 64; the chunked context, the
   6-candidate burst held to per-candidate prefill, ring steps, kernel 4's
   MLA mode once per layer per step, no plain call), their times and
   profiles, then ``ServeScheduler`` over phase 9's stream on paged bf16
   and paged int8 latent KV (the MLA mode, ``decode_attn_mla_q8`` on int8,
   once per layer per step; every request finished; bf16 within 5e-2 of
   the naive oracle for 4 requests, int8 within 5e-2 of bf16), timed.
   12b: at FULL widths, 2 layers, fp32, the kernel path against the dense
   path within 1e-4 (prefill, every decode step, the first 6 scheduler
   requests), and one paged int8 step bit for bit equal to the same step
   on a contiguous latent cache; then at 1 layer the scheduler on paged
   int8 latent KV, kernel path against dense path within 1e-4, the two
   caches' codes and scales equal.
13. minicpm3-4b training — first kernels 2 and 3 at its training shape
   (B=8, S=2048, H = Hk = 40, Dqk 96, Dv 64, NoPE + reset, [SUM] rows in
   each row's tail) in bf16 against the fp32 plain version per row, each
   case twice (the same bits), and cross-segment gradients at these head
   dims exactly 0; then its ``FULL`` config (62 layers, MLA, random
   seeded bf16 weights) with ``attn_impl="cuda"``, LoRA rank 8,
   ``trainable="lora"``, remat, reset and ALiBi on, through phase 7's
   path with the counts set to 0 before it and read after it: per step
   kernel 1 124 times, kernels 2 and 3 62 times each, no plain version;
   losses finite, frozen leaves bit for bit unchanged, every LoRA leaf
   moved; its step timed and profiled. 13b: FULL widths, 2 layers, fp32,
   the loss and every LoRA gradient, kernel path against dense path, at
   phase 8's tolerances.
14. qwen2-moe-a2.7b serving — its ``FULL`` config (24 layers, 60 experts
   top-4 and 4 shared, random seeded bf16 weights, count_params printed)
   with ``attn_impl="cuda"``, the counts set to 0 before it: phases 3 and
   4 on it at capacity factor n_experts / top_k, where no choice can be
   dropped (kernel 1 24 times a prefill call, kernel 4's GQA mode 24
   times a step, no plain call, 0 dropped choices); then at the config's
   1.25 a timed, profiled prefill call and decode burst step, with their
   dropped choices and peak memory printed. 14b: FULL widths, 2 layers,
   fp32, the kernel path against the dense path for prefill and every
   decode step within 1e-3, on a run where no token's top-k set differs
   between the paths (the count printed; it fails if every seed of the
   serving material gives a nonzero count).
20. qwen2-moe-a2.7b training — its ``FULL`` config (24 layers, random
   seeded bf16 weights, LoRA rank 8, nonzero ``lora_b``) through phase 7's
   path at the config's capacity factor 1.25, the counts set to 0 before
   it: per step kernel 1 48 times, kernels 2 and 3 24 times each, no plain
   version; losses finite, frozen leaves unchanged, LoRA leaves moved; the
   share of dropped choices in one forward, the step timed and profiled,
   peak memory; two steps from one state give the same loss, grad norm
   and LoRA bits (the MoE backward's sums run in a fixed order). 20b: FULL
   widths, 2 layers, fp32, the no-drop factor, the kernel path against
   the dense path (loss within 1e-5, each LoRA gradient within 1e-4 of
   its leaf's largest), on the first batch where no token's top-k set
   differs between the paths (the count printed).
15. minicpm-2b and qwen2-1.5b — each ``FULL`` with ``attn_impl="cuda"``:
   phases 3 and 4 on it (kernel 1 once per layer per prefill call, kernel
   4's GQA mode at head dim 64 with n_rep 1, and at 128 with n_rep 6, once
   per layer per step, no plain call), one prefill call and one decode
   burst step timed; at 2 layers in fp32 the kernel path against the dense
   path within 1e-4, prefill and every decode step.
18. deepseek-v2-236b — its ``FULL`` config at full width (d_model 5120,
   128 heads, MLA kv_lora 512 and qk 128 + 64, 160 experts top-6 and 2
   shared, ``norm_topk=False``) with the depth cut to the dense first
   layer and two MoE layers (~9.3B parameters, ~18.7 GB of random seeded
   bf16 weights made on the card), ``attn_impl="cuda"``, the counts set to
   0 before it: at the no-drop capacity factor phases 3 and 4 on it
   (``CTRServer.score`` in calls of 2 prompts, kernel 1 at Dqk 192 / Dv
   128 once per layer a call; the chunked context, the 6-candidate burst
   held to per-candidate prefill, ring steps, kernel 4's MLA mode at 576 /
   512 once per layer a step) and the same decode path on int8 latent KV;
   no plain call, no dropped choice; then ``ServeScheduler`` over 8
   requests on paged bf16 latent KV (its launches added), held to the
   naive oracle in calls of 4 prompts within 5e-2. Off the main path:
   prefill against the blocked path, bf16 and int8 decode against the
   dense plain decode, int8 against bf16 KV, each within 5e-2; a paged
   step bit for bit equal to a contiguous one (bf16, int8). At the
   config's capacity factor 1.25: the prefill call (B=8, S=2048) and
   decode burst step timed and profiled, drops and peak memory printed.
   18b: the dense first layer alone in fp32, kernel path against dense
   path for prefill and every decode step within 1e-4, then the int8
   latent cache's one-layer check as in 12b. 19: on the same model, LoRA
   B made nonzero, phase 20's training path and checks at capacity 1.25,
   kernels 1-3 at Dqk 192 (per step ``windowed_attn_192`` 6 times,
   ``windowed_attn_dq_192`` and ``_dkv_192`` 3 times each); 19b: the dense
   first layer alone in fp32 on 2 rows, kernel path against dense path at
   20b's tolerances.
16. gin-tu — ``configs/gin_tu`` FULL per shape (``config_for_shape``: 5
   layers, d_hidden 64, sum, learnable eps, fp32, remat; random seeded
   weights) trained with the reference cell's AdamW (lr 1e-3, cosine over
   5,000 steps) at the four GNN shapes, nothing cut: full_graph_sm (a
   seeded 10,556 of a 2,708-node community graph's edges, padded to
   3,072 nodes and 10,752 edges), minibatch_lg (a 232,965-node graph of
   114.6M edges on the host, ``sample_neighbors`` of 1,024 seeds at
   fanouts (15, 10), padded to 180,224 nodes and 168,960 edges),
   ogb_products (2,449,029 nodes, 61.2M edges, padded to 2,449,408 and
   61,859,328) and molecule (128 graphs of 30 nodes, ``gin_graph_forward``).
   The two large host graphs are built in two worker processes from the
   start of the run. 16a: full_graph_sm, the card against the CPU on the
   same weights: logits within 1e-4 max|logit| + 1e-5, 3 AdamW losses
   within 1e-4. Each shape: two steps and two gradient passes from one
   state equal bit for bit, every layer's eps moved, the step timed
   (median after a warm-up), nodes/s, peak memory, the memory reckoning;
   the two large shapes profiled. No kernel of the five on this path (the
   counts are read: all 0).
17. multi-target — dti-llama FULL on phase 3's weights: the first 8
   requests of phase 9's stream (~960-token contexts, 16 candidates) as
   one ``build_multi_target_request`` row of max_len 2048 each through
   ``CTRServer.score_multi_target`` (dense path, no kernel launch), and
   the same 128 candidates as sliding-window prompts through
   ``CTRServer.score`` on kernel 1 (its launches counted). One
   candidate's tokens and length changed: every other score equal bit
   for bit; bf16 at full depth: the multi-target path's drift from fp32
   no more than twice the independent path's + 5e-3; fp32 at 2 layers
   (dti-llama, and minicpm3-4b for MLA): within 1e-3 of the independent
   prefills. Both paths timed (ms, candidates/s, peak memory), the
   multi-target call profiled.
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
9. scheduler — the third main path, with the counts reset before each
   run and read after it: ``ServeScheduler`` serves a seeded stream of 24
   requests (~960-token contexts, 16 candidates each, 30 % revisits) on
   8 rows of 2048 slots, pages of 16, buckets (16, 32, 64), prefill budget
   512, bf16 weights, ``attn_impl="cuda"``, four times: (a) paged bf16
   KV, (b) paged int8 KV, (c) contiguous bf16 KV, (d) paged int8 KV on
   half the default pool. Per step the layout's decode kernel runs once
   per layer (``decode_attn_q8`` for int8 KV) and the other and the plain
   version never; every request finishes, no watchdog; cross-row radix
   hits in (a) and (b), page evictions in (d); (a) within 5e-2 of the
   naive oracle (a sliding-window prefill per candidate, kernel 1) for 4
   requests, (b), (c), (d) within 5e-2 of (a).
10. scheduler checks — FULL widths, the first 6 requests: in fp32 the
   kernel path against the dense path within 1e-4 (fp32 KV at 2 layers;
   int8 KV at 1 layer, where both paths store the same codes, shown
   equal; the 2-layer int8 gap is printed), the stream paged against
   contiguous within 1e-5, int8 within 2e-2 of fp32 KV; in bf16 and int8
   KV at 2 layers one decode step on a paged cache whose pages lie out of
   order in the pool equal, bit for bit, to the same step on a contiguous
   cache holding the same KV.
6. times — prefill call, decode step and train step, peak memory, the
   frozen weight-gradient pass's cost, each scheduler run's ms per step,
   candidates/s, pages, KV bytes and host time per step, and each kernel
   beside its plain version and ``scaled_dot_product_attention`` (forward
   or backward, after dequantization and RoPE for the int8 mode, the
   backend it picks named for the MLA mode's operands; for
   kernel 5 ``F.embedding_bag``: the library yardstick, never used by the
   port), with CUDA events; kernel 1 also at the training shape, kernels
   2 and 3 also with [SUM] rows every 7th slot, kernel 4
   in both modes also at the scheduler's smallest bucket (s=16), where
   its split plan cuts the cache into ranges, kernel 5 (timed in phase
   2f) also on DIN's bf16 table and at MIND's shape in both modes (queued
   behind a sleep, so that host launch time does not count), beside its
   32-byte sector floor; kernel 4's MLA mode in both modes also at s=16,
   beside its yardsticks, and its instantiations' registers and spills
   (``-Xptxas -v``) and resident CTAs per SM on a line of their own, and
   at s=64 in three cache ranges, the cut its plan does not make; ``torch.profiler``
   breakdowns of one decode burst step, one prefill call, one train step
   and the 9a and 9b scheduler runs; kernels 2 and 3 also at minicpm3-4b's
   training shape (phase 13's operands) beside their bound and SDPA
   backward on the same mask; the wide geometries of 2h at deepseek-v2's
   shapes beside their plain versions (kernel 1's summed over calls of
   one batch row) and SDPA; kernels 2 and 3's Dqk-192 class at deepseek-
   v2's training shape (2i's operands) beside their plain version (summed
   over calls of one batch row), SDPA backward and their bound, and with
   [SUM] rows every 7th slot.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. With no card, or run
outside the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import re
import shutil
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
# bf16 inputs. Kernels 1 and 4 multiply on tensor cores into fp32: q.K^T of
# bf16 operands is exact; they round P to a pair of bf16 terms (hi + lo,
# ~2^-17 of p) before P.V, and kernel 4's int8 mode its roped, dequantized
# K likewise; their exponentials are ex2.approx (~2 ulp). So the two differ
# by the kernel's final rounding of o to bf16
# (half a step of its 8-bit significand, at most 2^-8 of |o|) and by
# terms of ~1e-6 of the row's scale. Each output element may differ by
# ROUND_TOL * |o| +
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


T_START = time.perf_counter()


def log(msg: str) -> None:
    """Print a line; a phase's header line with the run's seconds so far."""
    if msg.startswith("phase "):
        msg = f"{msg} [{time.perf_counter() - T_START:.0f}s]"
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check_close(name, got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    log(f"  {name}: max|err| {err:.3e} (tol {tol:g})")
    if not err <= tol:
        fail(f"{name}: max|err| {err} > {tol}")
    return err


def check_rows(name, got, want, quiet=False, floor=0.0, worst_of=None):
    """Hold a bf16 kernel output against the fp32 plain one, element by
    element, at ROUND_TOL * |want| + ROW_TOL * max|want| over its row
    (+ ``floor``). ``worst_of`` (a dict) keeps the worst err/tol under
    ``name``'s first word."""
    want = want.float()
    err = (got.float() - want).abs()
    tol = (ROUND_TOL * want.abs()
           + ROW_TOL * want.abs().amax(dim=-1, keepdim=True) + floor)
    bad = int((err > tol).sum())
    worst = (err / tol.clamp_min(1e-30)).max().item()
    max_err = err.max().item()
    if worst_of is not None:
        key = name.split()[0]
        worst_of[key] = max(worst_of.get(key, 0.0), worst)
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
    log("phase 2a: windowed_attn vs plain, bf16 inputs (the plain version "
        "in fp32 on them), the same flags")
    gen16 = torch.Generator(device="cuda")
    gen16.manual_seed(7)
    for window, nope, reset, packed, sum_iso, hk, dv, S, empty in cases:
        o = windowed_operands(gen16, B=2, S=S, H=8, Hk=hk, D=64, Dv=dv,
                              dtype=torch.bfloat16, packed=packed,
                              empty_row=empty)
        kw = windowed_kwargs(o, window=window, nope=nope, reset=reset,
                             packed=packed, sum_iso=sum_iso)
        got, lse = windowed_attention(o["q"], o["k"], o["v"],
                                      return_lse=True, **kw)
        torch.cuda.synchronize()
        args, kw32 = _f32(o["q"], o["k"], o["v"], **kw)
        want, lse_w = windowed_attention_plain(*args, **kw32)
        tag = (f"w={window} nope={nope} reset={reset} seg={packed} "
               f"iso={sum_iso} n_rep={8 // hk} Dv={dv} S={S} empty={empty}")
        check_rows(f"o   [{tag}]", got, want)
        check_close(f"lse [{tag}]", lse, lse_w, LSE_TOL)
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
# phases 2d and 2i: the backward kernels against their plain version
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


# the head geometries kernels 2 and 3 train at: dti-llama (phase 7) and
# minicpm3-4b's MLA (phase 13: q/k of qk_nope + qk_rope, v of v_head_dim)
LLAMA_HEADS = dict(H=32, Hk=8, D=128, Dv=128)
MLA_HEADS = dict(H=40, Hk=40, D=96, Dv=64)


def train_windowed(gen, spread=False, heads=LLAMA_HEADS):
    """Kernels 2 and 3 at a training shape: B=8, S=2048, ``heads`` (phase
    7's by default: H=32, Hk=8, D=128), window 1024, NoPE + reset + [SUM]
    isolation, padded tails of 8-60 slots, and [SUM] rows as streaming
    prompts place them, 20 in each row's tail; with ``spread``, every 7th
    slot of the whole row (the dk/dv pass's phase B then revisits every q
    tile)."""
    o = windowed_operands(gen, B=8, S=2048, dtype=torch.bfloat16, **heads)
    B, S = o["valid"].shape
    o["is_sum"] = torch.zeros(B, S, dtype=torch.bool, device="cuda")
    o["valid"] = torch.ones(B, S, dtype=torch.bool, device="cuda")
    for b in range(B):
        n = S - 8 - 7 * b
        o["valid"][b, n:] = False
        if spread:
            o["is_sum"][b, 6:n:7] = True
        else:
            o["is_sum"][b, n - 1 - 7 * torch.arange(20, device="cuda")] = True
    o["do"] = (torch.randn(B, S, heads["H"], heads["Dv"], generator=gen,
                           device="cuda").to(torch.bfloat16))
    kw = windowed_kwargs(o, window=1024, nope=True, reset=True,
                         packed=False, sum_iso=True)
    return o, kw


def hold_train_grads(o, kw, label):
    """Kernels 2 and 3 on ``train_windowed``'s operands, twice: the two
    calls must give the same bits, and the gradients are held to the plain
    version in fp32, row by row, given the kernels' delta (``check_rows``
    with GRAD_FLOOR). Returns the largest error per stream."""
    from repro_torch.kernels.windowed_attn import (
        windowed_attention, windowed_attention_bwd_plain,
        windowed_attention_plain)
    got = kernel_grads(o["q"], o["k"], o["v"], o["do"], **kw)
    again = kernel_grads(o["q"], o["k"], o["v"], o["do"], **kw)
    with torch.no_grad():
        o_k = windowed_attention(o["q"], o["k"], o["v"], **kw)
    torch.cuda.synchronize()
    for name, g, a in zip(GRADS, got, again):
        if (g is None) != (a is None) or (g is not None
                                          and not torch.equal(g, a)):
            fail(f"{name} [{label}]: two backward calls differ")
    log(f"  [{label}] two backward calls give the same bits")
    delta = lambda out, do: (out.float() * do.float()).sum(-1).transpose(1, 2)
    errs, worst = {}, {}
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
                f"{name:7s} [{label}] row {b}", g[b:b + 1], w, quiet=True,
                floor=GRAD_FLOOR * float(w.abs().max()), worst_of=worst))
    for name in errs:
        log(f"  [{label}] {name}: max|err| over {o['q'].shape[0]} rows "
            f"{errs[name]:.3e}, worst err/tol {worst[name]:.3f}")
    return errs


def card_leakage(lens, *, window, seed, with_sum, target_seg, D=8, Dv=8):
    """Largest |gradient| through kernels 2 and 3 of segment
    ``target_seg``'s summed output with respect to q, k and v at every
    other segment's positions (the layouts of the reference's
    ``tests/test_kernel_grads.py::_leakage_case``; 2 heads, head dims
    ``D`` for q and k, ``Dv`` for v)."""
    from repro_torch.core.windowed import ResetConfig
    H, S = 2, ((sum(lens) + 7) // 8) * 8
    n_pad = S - sum(lens)
    seg = np.concatenate([np.repeat(np.arange(len(lens)), lens),
                          np.full(n_pad, -1)]).astype(np.int32)
    pos = np.concatenate([np.concatenate([np.arange(n) for n in lens]),
                          np.zeros(n_pad)]).astype(np.int32)
    valid = seg >= 0
    r = np.random.default_rng(seed)
    is_sum = (r.random(S) < 0.25) & valid if with_sum else np.zeros(S, bool)
    x = _cuda(*[r.normal(size=(1, S, H, dim)).astype(np.float32)
                for dim in (D, D, Dv, D, D, Dv)])
    seg_t, pos_t, valid_t, sum_t = _cuda(seg[None], pos[None], valid[None],
                                         is_sum[None])
    kw = dict(pos_q=pos_t, pos_k=pos_t, window=window, seg_q=seg_t,
              seg_k=seg_t, valid_k=valid_t)
    if with_sum:
        kw.update(is_sum_q=sum_t, is_sum_k=sum_t, q_nope=x[3], k_nope=x[4],
                  alibi=torch.tensor([0.3, 0.1], device="cuda"), v0=x[5],
                  reset=ResetConfig(0.05, 0.3, window / 2))
    sel = torch.from_numpy(seg == target_seg).cuda()[None, :, None, None]
    do = sel.float().expand(1, S, H, Dv).contiguous()
    g = kernel_grads(x[0], x[1], x[2], do, **kw)[:3]
    torch.cuda.synchronize()
    others = torch.from_numpy((seg != target_seg) & valid).cuda()
    return max(float(t[0, others].abs().max()) for t in g)


# phases 2d and 2i: window, nope, reset, packed, sum_iso, Hk, D, Dv, S,
# empty_row over 8 query heads; 2d at kernels 2 and 3's 128 class, 2i at
# their Dqk-192 class (D 192 and 136)
BWD_CASES = [
    (48, False, False, False, False, 8, 64, 64, 256, False),
    (48, True, False, False, True, 4, 64, 64, 200, True),
    (48, True, True, False, True, 2, 64, 48, 200, False),
    (100, False, True, True, True, 2, 64, 48, 256, False),
    (300, True, True, True, False, 1, 64, 64, 200, True),   # window off
    (64, True, False, True, True, 2, 64, 64, 190, False),
]
WIDE_BWD_CASES = [
    (48, False, False, False, False, 8, 192, 128, 256, False),
    (48, True, False, False, True, 4, 192, 128, 200, True),
    (48, True, True, False, True, 8, 192, 128, 200, False),
    (100, False, True, True, True, 4, 192, 64, 256, False),
    (300, True, True, True, False, 8, 192, 128, 200, True),  # window off
    (64, True, False, True, True, 4, 136, 96, 190, False),
]


def _unaligned(t):
    """A copy of ``t`` whose base is one element past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def check_kernels_bwd(phase, cases, *, seed, heads=LLAMA_HEADS,
                      leak_dims=(8, 8), unaligned=False, keep=True):
    """Phases 2d and 2i: kernels 2 and 3 of one head-dim class through the
    autograd Function around kernel 1. fp32 small shapes over ``cases``
    within SMALL_TOL; with ``unaligned``, the cases past the first in bf16
    per row, twice (the same bits), and on rows that are not 16-byte
    aligned bit for bit those of aligned copies; the training shape at
    ``heads`` (``train_windowed``: [SUM] rows in each row's tail, then every
    7th slot) in bf16 against the fp32 plain version a batch row at a time,
    twice (``hold_train_grads``); cross-segment gradients at head dims
    ``leak_dims`` exactly 0; each launch counted under its class's key.
    Off the main path: the launches here are reset before phase 3. Returns,
    per pass, the largest bf16 error at the training shape, and with
    ``keep`` its operands (tail and spread) and the plain backward's ms on
    the tail (phase 6 reads them)."""
    from repro_torch import kernels
    from repro_torch.kernels.windowed_attn import (launch_key,
                                                   windowed_attention_bwd_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    fwd, dq, dkv = (launch_key(f"windowed_attn{k}", heads["D"])
                    for k in ("", "_dq", "_dkv"))
    before = dict(kernels.LAUNCHES)
    n_calls = n_fwd = 0      # calls of the autograd Function; forwards alone
    log(f"phase {phase}: {dq} / {dkv} vs plain, fp32, small shapes")
    for window, nope, reset, packed, sum_iso, hk, d, dv, S, empty in cases:
        o = windowed_operands(gen, B=2, S=S, H=8, Hk=hk, D=d, Dv=dv,
                              dtype=torch.float32, packed=packed,
                              empty_row=empty)
        kw = windowed_kwargs(o, window=window, nope=nope, reset=reset,
                             packed=packed, sum_iso=sum_iso)
        do = torch.randn(2, S, 8, dv, generator=gen, device="cuda")
        got = kernel_grads(o["q"], o["k"], o["v"], do, **kw)
        torch.cuda.synchronize()
        n_calls += 1
        want = windowed_attention_bwd_plain(o["q"], o["k"], o["v"], do, **kw)
        tag = (f"w={window} nope={nope} reset={reset} seg={packed} "
               f"iso={sum_iso} n_rep={8 // hk} D={d} Dv={dv} S={S} "
               f"empty={empty}")
        for name, g, w in zip(GRADS, got, want):
            if (g is None) != (w is None):
                fail(f"{name} [{tag}]: stream live on one side only")
            if g is not None:
                check_close(f"{name:7s} [{tag}]", g, w, SMALL_TOL)

    if unaligned:
        log(f"phase {phase}: bf16 inputs, small shapes, per row; twice (the "
            "same bits); rows off 16-byte boundaries bit for bit")
        for window, nope, reset, packed, sum_iso, hk, d, dv, S, empty in \
                cases[1:]:
            o = windowed_operands(gen, B=2, S=S, H=8, Hk=hk, D=d, Dv=dv,
                                  dtype=torch.bfloat16, packed=packed,
                                  empty_row=empty)
            o["do"] = torch.randn(2, S, 8, dv, generator=gen,
                                  device="cuda").to(torch.bfloat16)
            kw = windowed_kwargs(o, window=window, nope=nope, reset=reset,
                                 packed=packed, sum_iso=sum_iso)
            tag = f"bf16 w={window} n_rep={8 // hk} D={d} Dv={dv}"
            hold_train_grads(o, kw, tag)
            names = [n for n in ("q_nope", "k_nope", "v0") if n in kw]
            kw2 = dict(kw, **{n: _unaligned(kw[n]) for n in names})
            a = kernel_grads(o["q"], o["k"], o["v"], o["do"], **kw)
            b = kernel_grads(_unaligned(o["q"]), _unaligned(o["k"]),
                             _unaligned(o["v"]), _unaligned(o["do"]), **kw2)
            torch.cuda.synchronize()
            n_calls, n_fwd = n_calls + 4, n_fwd + 1
            if not all((x is None and y is None) or torch.equal(x, y)
                       for x, y in zip(a, b)):
                fail(f"[{tag}] unaligned rows give other gradients")
        log("  rows off 16-byte boundaries (the conversion pass) give the "
            "aligned copies' gradients bit for bit")

    shape = "H{H} Hk{Hk} D{D} Dv{Dv}".format(**heads)
    log(f"phase {phase}: training shape B=8 S=2048 {shape}, bf16 kernels vs "
        "the fp32 plain version; [SUM] rows in each row's tail, then every "
        "7th slot")
    o, kw = train_windowed(gen, heads=heads)
    errs = hold_train_grads(o, kw, f"{shape} tail")
    spread = train_windowed(gen, spread=True, heads=heads)
    for name, err in hold_train_grads(*spread, f"{shape} spread").items():
        errs[name] = max(errs[name], err)
    n_calls, n_fwd = n_calls + 4, n_fwd + 2
    res = {key: dict(err=max(errs[g] for g in grads))
           for key, grads in zip((dq, dkv), PASS_GRADS.values())}
    if keep:
        t0 = time.perf_counter()
        plain_ms = cuda_ms(lambda: windowed_attention_bwd_plain(
            o["q"], o["k"], o["v"], o["do"], **kw), iters=1, warmup=1)
        log(f"  plain backward at B=8 (bf16 inputs, fp32 scores): "
            f"{plain_ms:.2f} ms ({time.perf_counter() - t0:.1f}s)")
        for r in res.values():
            r.update(ops=(o, kw), spread=spread, plain_ms=plain_ms)
    del o, kw, spread
    torch.cuda.empty_cache()

    log(f"phase {phase}: cross-segment gradients through the kernels, D "
        f"{leak_dims[0]} Dv {leak_dims[1]}")
    for lens, window, seed, with_sum, target in (([12, 9, 7], 8, 0, True, 1),
                                                 ([5, 17], 4, 1, False, 0)):
        leak = card_leakage(lens, window=window, seed=seed,
                            with_sum=with_sum, target_seg=target,
                            D=leak_dims[0], Dv=leak_dims[1])
        n_calls += 1
        log(f"  segments {lens} window {window} [SUM] {with_sum}: largest "
            f"cross-segment |grad| {leak}")
        if leak != 0.0:
            fail(f"gradient leaks across segments: {leak}")
    launched = {k: n - before[k] for k, n in kernels.LAUNCHES.items()
                if n != before[k]}
    want = {fwd: n_calls + n_fwd, dq: n_calls, dkv: n_calls}
    if launched != want:
        fail(f"phase {phase} launched {launched}, want {want}")
    log(f"  phase {phase} launches {launched}")
    return res


# ---------------------------------------------------------------------------
# phases 3 and 4: the serving path at full width
# ---------------------------------------------------------------------------

def build_model():
    from repro_torch.configs.dti_llama import FULL
    from repro_torch.models.transformer import init_params
    t0 = time.perf_counter()
    params = init_params(FULL, seed=0)
    nonzero_lora(params, seed=3)
    torch.cuda.synchronize()
    n = sum(p.numel() for lp in params["layers"] for p in _leaves(lp))
    log(f"  FULL params on card: {n / 1e9:.2f}B per-layer weights + embed/"
        f"head, {torch.cuda.memory_allocated() / 2**30:.1f} GiB, "
        f"{time.perf_counter() - t0:.1f}s")
    return FULL, params


def nonzero_lora(params, seed):
    """Nonzero LoRA B (zero at init), so that the adapters take part."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def lora(t):
        for k, v in t.items():
            if k == "lora_b":
                v.copy_(torch.randn(v.shape, generator=gen, device="cuda") * 0.01)
            elif isinstance(v, dict):
                lora(v)
    for lp in params["layers"]:
        lora(lp)


def _leaves(t):
    for v in t.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


N_CTX, MAX_LEN, N_CAND = 260, 2048, 6


def serving_material(cfg, seed=0):
    from repro_torch.core.dti import build_sliding_prompts
    from repro_torch.data.synthetic import make_ctr_dataset
    ds = make_ctr_dataset(n_users=8, n_items=400, seq_len=N_CTX + N_CAND + 1,
                          vocab_size=cfg.vocab_size, seed=seed)
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


class ChunkedServer:
    """A ``CTRServer`` whose ``score`` runs at most ``per_call`` prompts a
    call (an MoE model at the no-drop capacity factor holds E x T x d of
    expert buffers a call); ``calls`` counts the calls."""

    def __init__(self, server, per_call):
        self.server, self.per_call, self.calls = server, per_call, 0

    def score(self, prompts):
        out = []
        for i in range(0, len(prompts), self.per_call):
            out += self.server.score(prompts[i:i + self.per_call])
            self.calls += 1
        return out


def prefill_kernel(cfg):
    """Kernel 1's launch key for ``cfg``'s q/k head dim."""
    return train_keys(cfg)[0]


def phase_prefill(cfg, params, prompts, kernels, per_call=None):
    """The main path's prefill: ``CTRServer.score`` in bf16 on kernel 1
    (in calls of ``per_call`` prompts when given: a ``ChunkedServer``)."""
    from repro_torch.serve.engine import CTRServer
    log("phase 3: prefill, CTRServer.score on 8 sliding-window prompts")
    lens = [int(p["valid"].sum()) for p in prompts]
    log(f"  prompt lengths {lens} (window {cfg.window})")
    server = CTRServer(params, cfg, max_len=MAX_LEN)
    if per_call:
        server = ChunkedServer(server, per_call)
    key = prefill_kernel(cfg)
    before = kernels.LAUNCHES[key]
    p = np.asarray(server.score(prompts))
    n = kernels.LAUNCHES[key] - before
    calls = -(-len(prompts) // per_call) if per_call else 1
    if n != cfg.n_layers * calls:
        fail(f"windowed kernel ran {n} times in {calls} prefill calls, want "
             f"{cfg.n_layers * calls}")
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


def drive_decode(cfg, params, users, kernels, kv_dtype=None):
    """The decode steps of phase 4 on ``cfg.attn_impl``: commit each user's
    context into a contiguous cache in valid-padded chunks of CHUNK, score
    the slate as one ``commit=False`` burst, then stream context + first
    target through a window+64-slot ring in steps of BURST (both caches
    int8 with ``kv_dtype="int8"``). Each step must launch the decode
    kernel once per layer on the kernel path and never on the dense
    path. Returns the p_click of every valid token of every
    step, in step order, and what phase 4 checks and phase 6 times."""
    from repro_torch.core.dti import SpecialTokens
    from repro_torch.serve.cache import init_lm_cache
    from repro_torch.serve.engine import make_decode_fn
    sp = SpecialTokens()
    per_step = cfg.n_layers if cfg.attn_impl == "cuda" else 0
    key = decode_kernel(cfg, kv_dtype)

    def step(fn, *args):
        before = kernels.LAUNCHES[key]
        p, cache = fn(params, *args)
        n = kernels.LAUNCHES[key] - before
        if n != per_step:
            fail(f"decode kernel ran {n} times in one step, want {per_step}")
        return p.float().cpu().numpy(), cache

    ctx_rows = [[sp.bos] + [t for it in toks[:N_CTX] for t in it]
                for toks, _ in users]
    cache = init_lm_cache(cfg, 8, MAX_LEN, dtype=cfg.cdtype,
                          kv_dtype=kv_dtype)
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

    ring = init_lm_cache(cfg, 8, cfg.window + 64, dtype=cfg.cdtype,
                         kv_dtype=kv_dtype)
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


def decode_kernel(cfg, kv_dtype):
    """The decode kernel's launch key for ``cfg``'s attention (the MLA
    mode's geometry) and KV."""
    from repro_torch.kernels.decode_attn import MLA_KEYS, mla_geometry
    name = "decode_attn"
    if cfg.attn_type == "mla":
        name = MLA_KEYS[mla_geometry(cfg.kv_lora_rank, cfg.qk_rope_dim)]
    return f"{name}_q8" if kv_dtype == "int8" else name


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
    """Counts calls of the attention's plain versions while installed:
    ``targets`` lists (module, name) pairs, by default the training path's
    windowed-attention plain versions."""

    def __init__(self, targets=None):
        import repro_torch.core.windowed as cw
        import repro_torch.kernels.windowed_attn as wa
        self.n = 0
        self._orig = targets or [(wa, "windowed_attention_plain"),
                                 (wa, "attention_dense"),
                                 (cw, "attention_dense")]
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


def train_keys(cfg):
    """The launch keys of kernels 1, 2 and 3 at ``cfg``'s q/k head dim
    (``launch_key``)."""
    from repro_torch.kernels.windowed_attn import launch_key
    d = (cfg.qk_nope_dim + cfg.qk_rope_dim if cfg.attn_type == "mla"
         else cfg.hd)
    return tuple(launch_key(f"windowed_attn{k}", d)
                 for k in ("", "_dq", "_dkv"))


def phase_train(cfg, params, mat, kernels, phase="7"):
    """The training path: ``make_train_step`` + ``Trainer`` with LoRA rank
    8, ``trainable="lora"``, remat, reset and ALiBi, on ``params`` (bf16).
    Per step: kernel 1 once per layer in the forward and once in the remat
    recompute, kernels 2 and 3 once per layer (under ``train_keys``), no
    plain attention."""
    from repro_torch.launch.train import evaluate_lm, make_lm_loss_fn
    from repro_torch.models.transformer import named_leaves
    from repro_torch.train.optimizer import OptimizerConfig, is_trainable
    from repro_torch.train.trainer import (Trainer, init_train_state,
                                           make_train_step)
    b0 = mat["batches"][0]
    log(f"phase {phase}: {cfg.name} training, {TRAIN_STEPS} steps of "
        f"{TRAIN_ROWS} DTI "
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
    want = {k: 0 for k in kernels.KERNELS}
    fwd, dq, dkv = train_keys(cfg)
    want.update({fwd: 2 * cfg.n_layers, dq: cfg.n_layers,
                 dkv: cfg.n_layers})
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


def phase_fp32_train_check(cfg, params, mat, phase="8", n_layers=2,
                           rows=TRAIN_ROWS // 2):
    """Off the main path. ``n_layers`` layers at FULL widths in fp32 (so
    the dense path's score tensors fit), on the first ``rows`` rows of
    batch 1: the kernel path and the dense path must give the same loss
    and LoRA gradients."""
    log(f"phase {phase}: {cfg.name} fp32 at {n_layers} layer(s), {rows} "
        "rows, kernel path vs dense path: loss and every LoRA gradient")
    cfg2 = dataclasses.replace(cfg, n_layers=n_layers, param_dtype="float32",
                               compute_dtype="float32")
    p32 = _layers(params, n_layers, torch.float32)
    dev = params["embed"].device
    batch = {k: torch.from_numpy(v[:rows]).to(dev)
             for k, v in mat["batches"][0].items()}
    got = {impl: _lora_grads(dataclasses.replace(cfg2, attn_impl=impl), p32,
                             batch, mat["window"])
           for impl in ("cuda", "dense")}
    out = hold_lora_grads(got)
    del p32, got
    torch.cuda.empty_cache()
    return out


def hold_lora_grads(got):
    """``got`` maps "cuda" and "dense" to ``_lora_grads``'s (loss,
    gradients): the losses within LOSS32_TOL, each LoRA leaf's gradient
    within GRAD32_TOL of its largest |gradient|."""
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
    return dict(loss_diff=abs(lc - ld), grad_rel=worst_rel)


# ---------------------------------------------------------------------------
# phase 2e: the int8 mode of the decode kernel against its plain version
# ---------------------------------------------------------------------------

def quantize_kv(o, *, rope_start, G, gen):
    """Replace ``o``'s K and V by int8 codes and fp32 scales
    (``repro_torch.core.quant``): one scale group per (slot, kv head), or
    two split at ``rope_start``. Empty slots get arbitrary scales (a paged
    gather reads arbitrary pool slots there)."""
    from repro_torch.core.quant import quantize_q8
    kf, vf = o["k"].float(), o["v"].float()
    if G == 2:
        c_q, c_s = quantize_q8(kf[..., :rope_start])
        p_q, p_s = quantize_q8(kf[..., rope_start:])
        k8, ks = torch.cat([c_q, p_q], -1), torch.stack([c_s, p_s], -1)
    else:
        k8, ks = quantize_q8(kf)
        ks = ks[..., None]
    v8, vs = quantize_q8(vf)
    empty = o["pos_k"] < 0
    dev = kf.device
    ks[empty] = 1e3 * torch.rand(ks[empty].shape, generator=gen, device=dev)
    vs[empty] = 1e3 * torch.rand(vs[empty].shape, generator=gen, device=dev)
    return dict(k=k8, v=v8, k_scale=ks, v_scale=vs)


def q8_kwargs(o, q8, *, window, nope, seg, rope_start, theta):
    kw = dict(window=window, k_scale=q8["k_scale"], v_scale=q8["v_scale"],
              rope_start=rope_start, rope_theta=theta)
    if nope:
        kw.update(is_sum_q=o["is_sum"], q_nope=o["qn"], alibi=o["alibi"])
    if seg:
        kw.update(seg_q=o["seg_q"], seg_k=o["seg_k"])
    return kw


def check_kernels_q8():
    """Kernel 4's int8 mode: small fp32 shapes over every flag, then the
    decode shape in bf16 against the plain version in fp32 on the same
    codes. Returns what phase 6 times and the JSON line reports."""
    from repro_torch.kernels.decode_attn import (decode_attention,
                                                 decode_attention_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    log("phase 2e: decode_attn_q8 (int8 KV) vs plain, fp32, small shapes")
    cases = [  # window, nope, seg, Hk, D, Dv, rope_start, G, s, cap, skip, n_seg, base
        (0, True, True, 2, 64, 64, 0, 1, 12, 200, False, 3, 1800),
        (40, True, False, 8, 128, 128, 0, 1, 5, 190, True, 0, 0),
        (30, False, True, 2, 64, 48, 0, 1, 12, 200, False, 4, 900),
        (0, True, True, 1, 12, 8, 8, 2, 12, 130, False, 3, 1800),
        (20, False, False, 1, 12, 8, 8, 2, 5, 100, True, 0, 0),
        (0, True, True, 2, 64, 64, 8, 2, 70, 300, False, 5, 1500),  # 2 passes
    ]
    for (window, nope, seg, hk, d, dv, rs, g, s, cap, skip, n_seg,
         base) in cases:
        o = decode_operands(gen, B=3, s=s, H=8, Hk=hk, D=d, Dv=dv, cap=cap,
                            dtype=torch.float32, fills=(120, 150, 0),
                            skip_block=skip, n_seg=n_seg)
        o["pos_k"] = torch.where(o["pos_k"] >= 0, o["pos_k"] + base, -1)
        o["pos_q"] = o["pos_q"] + base
        q8 = quantize_kv(o, rope_start=rs, G=g, gen=gen)
        kw = q8_kwargs(o, q8, window=window, nope=nope, seg=seg,
                       rope_start=rs, theta=10000.0)
        got = decode_attention(o["q"], q8["k"], q8["v"], o["pos_q"],
                               o["pos_k"], **kw)
        torch.cuda.synchronize()
        want = decode_attention_plain(o["q"], q8["k"], q8["v"], o["pos_q"],
                                      o["pos_k"], **kw)
        tag = (f"w={window} nope={nope} seg={seg} n_rep={8 // hk} D={d} "
               f"Dv={dv} rope_start={rs} G={g} s={s} cap={cap} skip={skip} "
               f"pos<{int(o['pos_k'].max()) + 1}")
        check_close(f"o [{tag}]", got, want, SMALL_TOL)
        if not (got[2] == 0).all():
            fail("empty cache row did not give 0 (int8 mode)")

    log("phase 2e: decode shape, bf16 queries on int8 codes vs the fp32 "
        "plain version")
    o, _ = real_decode(gen)
    B, s, cap = o["q"].shape[0], o["q"].shape[1], o["pos_k"].shape[1]
    n = cap - s             # row 7: keys at positions up to cap - 1
    ar = torch.arange(cap, device="cuda", dtype=torch.int32)
    o["pos_k"][7] = ar
    o["pos_q"][7] = ar[n:]
    o["seg_k"][7, :n] = -1
    o["seg_k"][7, n:] = o["seg_q"][7]
    q8 = quantize_kv(o, rope_start=0, G=1, gen=gen)
    kw = q8_kwargs(o, q8, window=1024, nope=True, seg=True, rope_start=0,
                   theta=500000.0)
    got = decode_attention(o["q"], q8["k"], q8["v"], o["pos_q"], o["pos_k"],
                           **kw)
    torch.cuda.synchronize()
    args, kw32 = _f32(o["q"], q8["k"], q8["v"], o["pos_q"], o["pos_k"], **kw)
    want = decode_attention_plain(*args, **kw32)
    del args, kw32
    err = check_rows(f"decode_attn_q8 o B{B} cap{cap} s{s} H32 Hk8 D128 "
                     f"w1024, keys at positions up to "
                     f"{int(o['pos_k'].max())}", got, want)
    return dict(err=err, ops=(o, q8, kw))


# ---------------------------------------------------------------------------
# phase 2g: kernel 4's absorbed-MLA mode against its plain version
# ---------------------------------------------------------------------------

def latent_operands(gen, *, B, s, H, r, dr, cap, dtype, fills,
                    skip_block=False, n_seg=0, theta=10000.0):
    """``decode_operands`` at Hk=1, D = r + dr, Dv = r, as the latent cache
    holds them: ``ckv`` (B, cap, r) the latent and the values, ``kpe``
    (B, cap, dr) the raw rope span and ``kpe_rope`` its roped view (the
    engine's ``_rope_read``): K = [ckv | kpe_rope], V = ckv and K_nope =
    [ckv | kpe] differ only where they must."""
    o = decode_operands(gen, B=B, s=s, H=H, Hk=1, D=r + dr, Dv=r, cap=cap,
                        dtype=dtype, fills=fills, skip_block=skip_block,
                        n_seg=n_seg)
    lat = o.pop("k")[:, :, 0]
    del o["v"], o["kn"]
    o["ckv"] = lat[..., :r].contiguous()
    o["kpe"] = lat[..., r:].contiguous()
    o["theta"] = theta
    rope_latent(o)
    return o


def rope_latent(o):
    """``o``'s roped rope span from its positions (after they change)."""
    from repro_torch.models.layers import apply_rope
    o["kpe_rope"] = apply_rope(o["kpe"][:, :, None], o["pos_k"].clamp(min=0),
                               o["theta"])[:, :, 0].contiguous()


def quantize_latent(o, gen):
    """int8 codes of ``o``'s latent and rope span, a scale each per slot
    (``repro_torch.core.quant``, as the engine writes them); empty slots
    get arbitrary scales (a paged gather reads arbitrary pool slots)."""
    from repro_torch.core.quant import quantize_q8
    c8, cs = quantize_q8(o["ckv"].float())
    p8, ps = quantize_q8(o["kpe"].float())
    empty = o["pos_k"] < 0
    for sc in (cs, ps):
        sc[empty] = 1e3 * torch.rand(sc[empty].shape, generator=gen,
                                     device=sc.device)
    return dict(ckv=c8, kpe=p8, ckv_scale=cs, kpe_scale=ps)


def mla_kwargs(o, *, window, nope, seg, q8=None):
    """``decode_attention_mla``'s keyword operands: the roped span (bf16 /
    fp32) or the scales (``q8``, from ``quantize_latent``)."""
    kw = dict(window=window)
    if q8 is None:
        kw["kpe_rope"] = o["kpe_rope"]
    else:
        kw.update(ckv_scale=q8["ckv_scale"], kpe_scale=q8["kpe_scale"],
                  rope_theta=o["theta"])
    if nope:
        kw.update(is_sum_q=o["is_sum"], q_nope=o["qn"], alibi=o["alibi"])
    if seg:
        kw.update(seg_q=o["seg_q"], seg_k=o["seg_k"])
    return kw


def mla_args(o, q8=None):
    src = o if q8 is None else q8
    return (o["q"], src["ckv"], src["kpe"], o["pos_q"], o["pos_k"])


def real_mla(gen, *, s=64, dtype=torch.bfloat16, H=40, r=256, dr=32):
    """Kernel 4's MLA mode at minicpm3-4b's decode shape: B=8, cap=2048,
    s=64 (or a scheduler bucket), 40 heads on one latent key, r 256, dr 32
    (Dqk 288, Dv 256), window 1024, a burst of 6 candidates (4 at a
    smaller bucket) over contexts of 1.4k-1.9k, NoPE stream on; or at
    deepseek-v2's (H 128, r 512, dr 64)."""
    fills = [1400 + 70 * b for b in range(8)]
    o = latent_operands(gen, B=8, s=s, H=H, r=r, dr=dr, cap=2048,
                        dtype=dtype, fills=fills, n_seg=6 if s == 64 else 4)
    return o, mla_kwargs(o, window=1024, nope=True, seg=True)


def keys_to_cap(o):
    """Row 7 of ``o`` (as ``decode_operands`` makes it) holds keys at every
    position up to cap - 1, its burst in the last s slots."""
    s, cap = o["q"].shape[1], o["pos_k"].shape[1]
    n = cap - s
    ar = torch.arange(cap, device="cuda", dtype=torch.int32)
    o["pos_k"][7] = ar
    o["pos_q"][7] = ar[n:]
    o["seg_k"][7, :n] = -1
    o["seg_k"][7, n:] = o["seg_q"][7]


def check_same_bits(name, fn):
    a, b = fn(), fn()
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        fail(f"{name}: two calls gave different bits")
    log(f"  {name}: two calls give the same bits")


def real_mla_q8(gen, *, s=64, **geo):
    """``real_mla``'s shape on int8 codes, row 7's keys at every position
    up to 2047."""
    o, _ = real_mla(gen, s=s, **geo)
    keys_to_cap(o)
    rope_latent(o)
    q8 = quantize_latent(o, gen)
    return o, q8, mla_kwargs(o, window=1024, nope=True, seg=True, q8=q8)


def check_kernels_mla():
    """Kernel 4's MLA mode (``decode_attn_mla``, ``decode_attn_mla_q8``) on
    latent operands (V is the latent, K_nope differs from K only in the
    rope span): small fp32 shapes over every flag (window, segments of a
    commit=False burst, NoPE + ALiBi, latents and rope spans off the
    16-value k-step and off 16-byte rows, int8) within SMALL_TOL, small
    bf16 shapes (bf16 and int8) per row, then the MLA decode shape in bf16
    and on int8 codes (keys up to position 2047) against the plain version
    in fp32 at phase 2c's per-row tolerance, each twice (the same bits).
    Returns what phase 6 times."""
    from repro_torch import kernels
    from repro_torch.kernels.decode_attn import (decode_attention_mla,
                                                 decode_attention_mla_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    log("phase 2g: decode_attn_mla (kernel 4's MLA mode, the latent cache "
        "in place) vs plain, fp32, small shapes")
    # window, nope, seg, r, dr, s, cap, skip, n_seg, int8 position base
    cases = [
        (0, False, False, 256, 32, 5, 200, False, 0, None),
        (40, True, False, 256, 32, 5, 200, True, 0, None),
        (0, True, True, 256, 32, 12, 200, False, 3, None),
        (40, True, True, 136, 24, 12, 190, True, 4, None),
        (0, True, True, 72, 16, 70, 300, False, 5, None),   # 9 row blocks
        (0, True, True, 200, 30, 5, 130, False, 0, None),
        (0, True, True, 256, 32, 12, 200, False, 3, 1800),
        (20, False, False, 256, 32, 5, 100, True, 0, 0),
        (0, True, True, 128, 16, 12, 200, False, 4, 900),
        (30, True, False, 168, 32, 5, 190, False, 0, 1500),  # codes from memory
    ]
    before = dict(kernels.LAUNCHES)
    for (window, nope, seg, r, dr, s, cap, skip, n_seg, base) in cases:
        o = latent_operands(gen, B=3, s=s, H=8, r=r, dr=dr, cap=cap,
                            dtype=torch.float32, fills=(120, 150, 0),
                            skip_block=skip, n_seg=n_seg)
        q8 = None
        if base is not None:
            o["pos_k"] = torch.where(o["pos_k"] >= 0, o["pos_k"] + base, -1)
            o["pos_q"] = o["pos_q"] + base
            q8 = quantize_latent(o, gen)
        kw = mla_kwargs(o, window=window, nope=nope, seg=seg, q8=q8)
        got = decode_attention_mla(*mla_args(o, q8), **kw)
        torch.cuda.synchronize()
        want = decode_attention_mla_plain(*mla_args(o, q8), **kw)
        tag = (f"w={window} nope={nope} seg={seg} r={r} dr={dr} s={s} "
               f"cap={cap} skip={skip}"
               + ("" if q8 is None else f" int8 pos<{int(o['pos_k'].max()) + 1}"))
        check_close(f"o [{tag}]", got, want, SMALL_TOL)
        if not (got[2] == 0).all():
            fail("empty cache row did not give 0 (MLA mode)")
    n_q8 = sum(c[-1] is not None for c in cases)

    log("phase 2g: bf16 inputs, small shapes (aligned rows by cp.async, "
        "r=196 and dr=20 through the conversion pass, int8), per row")
    for r, dr, quant in ((256, 32, False), (196, 20, False), (136, 24, False),
                         (256, 32, True), (128, 16, True)):
        o = latent_operands(gen, B=3, s=12, H=8, r=r, dr=dr, cap=200,
                            dtype=torch.bfloat16, fills=(120, 150, 0),
                            n_seg=3)
        q8 = quantize_latent(o, gen) if quant else None
        kw = mla_kwargs(o, window=40, nope=True, seg=True, q8=q8)
        got = decode_attention_mla(*mla_args(o, q8), **kw)
        torch.cuda.synchronize()
        args, kw32 = _f32(*mla_args(o, q8), **kw)
        check_rows(f"o [bf16 r={r} dr={dr}{' int8' if quant else ''}]", got,
                   decode_attention_mla_plain(*args, **kw32))
        n_q8 += quant
    launched = {k: n - before[k] for k, n in kernels.LAUNCHES.items()
                if n != before[k]}
    if launched != {"decode_attn_mla": len(cases) + 5 - n_q8,
                    "decode_attn_mla_q8": n_q8}:
        fail(f"phase 2g small shapes launched {launched}")

    log("phase 2g: the MLA decode shape, bf16 kernel vs the fp32 plain "
        "version")
    res = {}
    o, kw = real_mla(gen)
    args = mla_args(o)
    got = decode_attention_mla(*args, **kw)
    torch.cuda.synchronize()
    a32, kw32 = _f32(*args, **kw)
    err = check_rows("decode_attn_mla o B8 cap2048 s64 H40 r256 dr32 w1024",
                     got, decode_attention_mla_plain(*a32, **kw32))
    del a32, kw32, got
    check_same_bits("decode_attn_mla at the MLA decode shape",
                    lambda: decode_attention_mla(*args, **kw))
    res["decode_attn_mla"] = dict(err=err, ops=(o, None, kw))

    o, q8, kw = real_mla_q8(gen)
    args = mla_args(o, q8)
    got = decode_attention_mla(*args, **kw)
    torch.cuda.synchronize()
    a32, kw32 = _f32(*args, **kw)
    err = check_rows("decode_attn_mla_q8 o B8 cap2048 s64 H40 r256 dr32 "
                     "w1024, int8 latent and rope codes, keys at positions "
                     f"up to {int(o['pos_k'].max())}", got,
                     decode_attention_mla_plain(*a32, **kw32))
    del a32, kw32, got
    check_same_bits("decode_attn_mla_q8 at the MLA decode shape",
                    lambda: decode_attention_mla(*args, **kw))
    res["decode_attn_mla_q8"] = dict(err=err, ops=(o, q8, kw))
    return res


# ---------------------------------------------------------------------------
# phases 9 and 10: the scheduler
# ---------------------------------------------------------------------------

SCHED = dict(n_slots=8, capacity=2048, page_size=16, buckets=(16, 32, 64),
             prefill_budget=512)
STREAM = dict(k=16, n_ctx=160, repeat_frac=0.3, seed=4)
N_REQ, N_REQ_SHORT, N_ORACLE = 24, 6, 4
# phase 9 (bf16 at 32 layers): the scheduler's scores against the naive
# oracle (one sliding-window prefill per candidate on kernel 1) and int8
# against bf16 KV within SCHED_TOL, serve_bench's own bound: bf16
# rounding through 32 random-weight layers, and int8 KV's quantization,
# are of the order of 1e-2 (PERF.md). Phase 10 (fp32 at 2 layers): the
# kernel path against the dense path within SCHED32_TOL (summation order),
# paged against contiguous over a whole stream within PAGED_TOL (the two
# runs batch rows differently, so products of other shapes), one step on
# a paged cache bit for bit equal to the same step on a contiguous one
# holding the same KV, and int8 KV within INT8_TOL of fp32 KV
# (tests/test_kv_quant.py's bound).
SCHED_TOL = 5e-2
SCHED32_TOL = 1e-4
PAGED_TOL = 1e-5
INT8_TOL = 2e-2


def sched_stream(cfg, n_requests):
    from repro_torch.data.requests import make_request_stream
    from repro_torch.data.synthetic import make_ctr_dataset
    ds = make_ctr_dataset(n_users=16, n_items=400, seq_len=200,
                          vocab_size=cfg.vocab_size, seed=0)
    return make_request_stream(ds, n_requests=n_requests, **STREAM)


def run_sched(cfg, params, reqs, kernels, *, kv_dtype, paged, n_pages=None,
              attn_impl="cuda", cache_dtype=None, dev="cuda", label=""):
    """One ``ServeScheduler`` over ``reqs``: warmup, then the counts set to
    0, ``run()`` timed to a device sync, and the counts read. Returns the
    scores, telemetry, per-step launches, plain-version calls and the
    host spans of the run."""
    import repro_torch.serve.engine as engine
    from repro_torch.obs.trace import SpanTracer
    from repro_torch.serve.scheduler import ServeScheduler
    tracer = SpanTracer()
    sched = ServeScheduler(params, cfg, **SCHED, kv_dtype=kv_dtype,
                           paged=paged, n_pages=n_pages, attn_impl=attn_impl,
                           cache_dtype=cache_dtype or cfg.cdtype,
                           tracer=tracer, device=dev)
    sched.warmup()
    sched.reset_stats()
    tracer.clear()
    per_step = []
    decode = sched._decode

    def counted(*args, **kw):
        before = dict(kernels.LAUNCHES)
        out = decode(*args, **kw)
        per_step.append({k: kernels.LAUNCHES[k] - before[k]
                         for k in kernels.LAUNCHES})
        return out
    sched._decode = counted
    rids = [sched.submit(r["context"], r["candidates"]) for r in reqs]
    plain = _PlainCalls([(engine, "decode_attention_plain"),
                         (engine, "decode_attention_mla_plain")])
    sync = (torch.cuda.synchronize if dev == "cuda" else lambda: None)
    try:
        sync()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = sched.run()
        sync()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    finally:
        plain.close()
    spans = {}
    for ev in tracer.events():
        if ev["ph"] == "X":
            spans.setdefault(ev["name"], []).append(ev["dur"] / 1e3)
    tel = sched.telemetry()
    done = [r for r in rids if r in out
            and all(p is not None for p in out[r].scores)]
    res = dict(scores=np.asarray([out[r].scores for r in done]),
               tel=tel, launches=launches, per_step=per_step,
               plain=plain.n, wall=wall, spans=spans, finished=len(done),
               n_req=len(reqs), kv_bytes=tel["kv_bytes"],
               candidates=sum(len(r["candidates"]) for r in reqs),
               jit=sched.jit_stats(), sched=sched)
    med = lambda name: float(np.median(spans.get(name, [0.0])))
    res["host_ms"] = med("dispatch") + med("build_wave")
    res["step_ms_median"] = med("scheduler.step")
    log(f"  [{label}] {tel['steps']} steps {tel['bucket_steps']}, "
        f"{wall * 1e3:.1f} ms ({wall * 1e3 / max(tel['steps'], 1):.2f} ms "
        f"per step, median step span {med('scheduler.step'):.2f} ms), "
        f"{res['candidates'] / wall:.1f} candidates/s; host per step: "
        f"dispatch {med('dispatch'):.3f} ms + build_wave "
        f"{med('build_wave'):.3f} ms; shared admissions "
        f"{sched.shared_admissions}, cross-row hits {tel['cross_row_hits']} "
        f"({tel['cross_row_tokens']} tokens), pages in use "
        f"{tel.get('pages_in_use')}, evictions {tel.get('page_evictions')}, "
        f"KV bytes {tel['kv_bytes']}, watchdog {tel['watchdog_fired']}")
    return res


DECODE_KERNELS = ("decode_attn", "decode_attn_q8", "decode_attn_mla",
                  "decode_attn_mla_q8", "decode_attn_mla_576",
                  "decode_attn_mla_576_q8")


def check_sched_run(res, cfg, kernel, label):
    """Every request finished, no watchdog, the kernel of the KV layout once
    per layer in every step and no other decode kernel or plain call."""
    others = [k for k in DECODE_KERNELS if k != kernel]
    steps = res["tel"]["steps"]
    bad = [d for d in res["per_step"]
           if d[kernel] != cfg.n_layers or any(d[k] for k in others)]
    if bad or len(res["per_step"]) != steps:
        fail(f"{label}: per-step launches {bad[:3]} (want {kernel} = "
             f"{cfg.n_layers}, the other decode kernels 0) over {steps} "
             "steps")
    if res["launches"][kernel] != cfg.n_layers * steps:
        fail(f"{label}: {kernel} ran {res['launches'][kernel]} times in "
             f"{steps} steps")
    if res["plain"]:
        fail(f"{label}: the plain decode attention ran {res['plain']} times")
    if res["finished"] != res["n_req"] or res["tel"]["watchdog_fired"]:
        fail(f"{label}: {res['finished']} of {res['n_req']} requests "
             f"finished, watchdog {res['tel']['watchdog_fired']}")


def sched_oracle(cfg, params, reqs, per_call=8):
    """The paper's procedure taken literally: one sliding-window prompt
    per candidate through ``CTRServer.score`` (kernel 1), ``per_call``
    prompts a call."""
    from repro_torch.core.dti import build_sliding_prompts
    from repro_torch.serve.engine import CTRServer
    n = max(1 + sum(len(t) for t in r["context"])
            + max(len(c) for c in r["candidates"]) + 1 for r in reqs)
    max_len = -(-n // 64) * 64
    server = CTRServer(params, cfg, max_len=max_len)
    out = []
    for r in reqs:
        prompts = []
        for cand in r["candidates"]:
            prompts += build_sliding_prompts(
                r["context"] + [cand], [0] * (len(r["context"]) + 1),
                n_ctx=len(r["context"]), max_len=max_len)
        out.append([p for i in range(0, len(prompts), per_call)
                    for p in server.score(prompts[i:i + per_call])])
    return np.asarray(out), max_len


def phase_sched(cfg, params, kernels):
    """The scheduler at full width, bf16, on the kernels: (a) paged bf16
    KV, (b) paged int8 KV, (c) contiguous bf16 KV, (d) paged int8 KV on
    half the default page pool."""
    reqs = sched_stream(cfg, N_REQ)
    ctx = [1 + sum(len(t) for t in r["context"]) for r in reqs]
    log(f"phase 9: ServeScheduler, {N_REQ} requests (context {min(ctx)}-"
        f"{max(ctx)} tokens, {STREAM['k']} candidates each, repeat_frac "
        f"{STREAM['repeat_frac']}), {SCHED}, attn_impl cuda, bf16")
    default_pages = SCHED["n_slots"] * SCHED["capacity"] // SCHED["page_size"]
    runs = {}
    for key, kv, paged, n_pages in (
            ("a", None, True, None), ("b", "int8", True, None),
            ("c", None, False, None), ("d", "int8", True, default_pages // 2)):
        label = (f"9{key} {'paged' if paged else 'contiguous'} "
                 f"{kv or 'bf16'} KV"
                 + (f", {n_pages} pages" if n_pages else ""))
        res = run_sched(cfg, params, reqs, kernels, kv_dtype=kv, paged=paged,
                        n_pages=n_pages, label=label)
        res.pop("sched")
        check_sched_run(res, cfg, "decode_attn_q8" if kv else "decode_attn",
                        label)
        runs[key] = res
        torch.cuda.empty_cache()
    for key in ("a", "b"):
        if not runs[key]["tel"]["cross_row_hits"] > 0:
            fail(f"9{key}: no cross-row hit")
    if not runs["d"]["tel"]["page_evictions"] > 0:
        fail("9d: the half-size pool evicted no page")
    oracle, max_len = sched_oracle(cfg, params, reqs[:N_ORACLE])
    errs = {"a vs oracle": float(np.abs(runs["a"]["scores"][:N_ORACLE]
                                        - oracle).max())}
    for key in ("b", "c", "d"):
        errs[f"{key} vs a"] = float(np.abs(runs[key]["scores"]
                                           - runs["a"]["scores"]).max())
    log(f"  max |score diff|: {errs} (tol {SCHED_TOL}; oracle: "
        f"{len(oracle) * len(oracle[0])} sliding-window prompts of max_len "
        f"{max_len})")
    for name, err in errs.items():
        if not err <= SCHED_TOL:
            fail(f"phase 9 scores {name} differ by {err}")
    return runs, errs


def _layers(params, n, dtype):
    """The first ``n`` layers of ``params`` (and embed, norm, head) in
    ``dtype``."""
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = params["layers"][:n]
    return _map_tensors(out, lambda t: t.to(dtype))


def step_paged_vs_contiguous(cfg, params, kv_dtype, dev="cuda", seed=0):
    """One decode step (a committed chunk, then a ``commit=False``
    segmented burst) on a contiguous cache and on a paged cache holding
    the same KV with its pages placed out of order in the pool: p_click,
    the written KV and the bookkeeping must be equal bit for bit. Returns
    the number of values compared."""
    from repro_torch.serve.cache import init_lm_cache, kv_keys
    from repro_torch.serve.engine import make_decode_fn
    B, cap, ps, s = SCHED["n_slots"], SCHED["capacity"], SCHED["page_size"], 64
    rng = np.random.default_rng(seed)
    contig = init_lm_cache(cfg, B, cap, dtype=cfg.cdtype, kv_dtype=kv_dtype,
                           device=dev)
    decode = make_decode_fn(cfg, window=cfg.window, ring=False)
    lens = rng.integers(100, 300, B)
    for lo in range(0, int(lens.max()), s):          # fill the rows
        toks = rng.integers(5, cfg.vocab_size, (B, s)).astype(np.int32)
        pos = np.tile(np.arange(lo, lo + s, dtype=np.int32), (B, 1))
        valid = pos < lens[:, None]
        t = [torch.from_numpy(a).to(dev) for a in (toks, pos, valid)]
        decode(params, contig, t[0], t[1], torch.zeros_like(t[2]), t[2])
    n_pages = B * cap // ps
    perm = rng.permutation(n_pages)
    paged = init_lm_cache(cfg, B, cap, dtype=cfg.cdtype, kv_dtype=kv_dtype,
                          page_size=ps, n_pages=n_pages, device=dev)
    table = np.full((B, cap // ps), -1, np.int32)
    for b in range(B):
        need = -(-(int(lens[b]) + 2 * s) // ps)      # two more chunks
        table[b, :need] = perm[b * (cap // ps): b * (cap // ps) + need]
        for j in range(need):
            src, dst = slice(j * ps, (j + 1) * ps), int(table[b, j]) * ps
            for key in kv_keys(contig):
                paged[key][:, dst:dst + ps] = contig[key][:, b, src]
    paged["page_table"].copy_(torch.from_numpy(table))
    for key in ("pos", "cursor", "ref"):
        paged[key].copy_(contig[key])
    n_cmp = 0
    for commit in (True, False):
        toks = rng.integers(5, cfg.vocab_size, (B, s)).astype(np.int32)
        cur = contig["cursor"].cpu().numpy()
        pos = (cur[:, None] + np.arange(s)).astype(np.int32)
        valid = np.arange(s)[None] < rng.integers(s // 2, s + 1, B)[:, None]
        seg = (np.arange(s)[None] * 4 // s).repeat(B, 0).astype(np.int32)
        is_sum = np.zeros((B, s), bool)
        is_sum[:, s // 4 - 1::s // 4] = not commit
        args = [torch.from_numpy(a).to(dev) for a in
                (toks, pos, is_sum, valid, np.full(B, commit),
                 seg if not commit else np.full((B, s), -1, np.int32))]
        p_c, _ = decode(params, contig, *args)
        p_p, _ = decode(params, paged, *args)
        if not torch.equal(p_c, p_p):
            fail(f"{kv_dtype or 'native'} KV, commit={commit}: paged step "
                 f"differs from contiguous by "
                 f"{(p_c - p_p).abs().max().item()}")
        n_cmp += p_c.numel()
        for key in ("pos", "cursor", "ref"):
            if not torch.equal(contig[key], paged[key]):
                fail(f"paged step changed {key} differently")
        flat = torch.from_numpy(table).to(dev).long()
        idx = (flat[:, :, None] * ps + torch.arange(ps, device=dev)).reshape(B, -1)
        for key in kv_keys(contig):
            view = paged[key][:, idx.clamp(min=0)]
            mapped = (flat >= 0).repeat_interleave(ps, 1)
            a, b_ = contig[key][:, mapped], view[:, mapped]
            if not torch.equal(a, b_):
                fail(f"{key}: the KV a paged step wrote differs from the "
                     f"contiguous step's")
            n_cmp += a.numel()
    return n_cmp


def phase_sched32(cfg, params, kernels):
    """fp32 at FULL widths: the scheduler's kernel path against its dense
    path (fp32 KV at 2 layers; int8 KV at 1 layer, see below), the whole
    stream paged against contiguous, int8 against fp32 KV; then in bf16 and
    int8 KV a paged step bit for bit against a contiguous one."""
    log(f"phase 10: the scheduler at FULL widths in fp32: kernel path vs "
        f"dense path, paged vs contiguous, int8 vs fp32 KV")
    reqs = sched_stream(cfg, N_REQ_SHORT)
    got, caches = {}, {}
    for key, layers, kv, paged, impl in (
            ("cuda", 2, None, True, "cuda"), ("dense", 2, None, True, "dense"),
            ("cuda_contig", 2, None, False, "cuda"),
            ("cuda_q8", 2, "int8", True, "cuda"),
            ("dense_q8", 2, "int8", True, "dense"),
            ("cuda_q8_1", 1, "int8", True, "cuda"),
            ("dense_q8_1", 1, "int8", True, "dense")):
        c = dataclasses.replace(cfg, n_layers=layers, param_dtype="float32",
                                compute_dtype="float32")
        res = run_sched(c, _layers(params, layers, torch.float32), reqs,
                        kernels, kv_dtype=kv, paged=paged, attn_impl=impl,
                        label=f"10 {key}, {layers} layers")
        if res["finished"] != len(reqs):
            fail(f"phase 10 {key}: {res['finished']} requests finished")
        got[key] = res["scores"]
        if layers == 1:
            caches[key] = res["sched"].cache
    # With one layer the K/V an int8 cache stores depend on the token
    # embeddings alone, so both paths hold the same codes and differ only
    # in the attention's summation order. From the second layer on, K/V
    # come from the first layer's output, whose last bits differ between
    # the paths, and a value on a rounding boundary then takes the
    # neighbouring code: one quantization step, which a summation-order
    # tolerance cannot hold. So int8's kernel-vs-dense check runs at one
    # layer, on codes shown equal; at two layers the gap is reported.
    for key in ("k", "v", "k_scale", "v_scale"):
        if not torch.equal(caches["cuda_q8_1"][key], caches["dense_q8_1"][key]):
            fail(f"phase 10: the 1-layer int8 caches differ in {key}")
    checks = {"fp32 KV cuda vs dense, 2 layers": ("cuda", "dense",
                                                  SCHED32_TOL),
              "int8 KV cuda vs dense, 1 layer": ("cuda_q8_1", "dense_q8_1",
                                                 SCHED32_TOL),
              "paged vs contiguous": ("cuda", "cuda_contig", PAGED_TOL),
              "int8 vs fp32 KV": ("cuda_q8", "cuda", INT8_TOL)}
    out = {}
    for name, (a, b, tol) in checks.items():
        out[name] = err = float(np.abs(got[a] - got[b]).max())
        log(f"  {name}: max|diff| {err:.3e} (tol {tol:g})")
        if not err <= tol:
            fail(f"phase 10 {name}: {err} > {tol}")
    err = float(np.abs(got["cuda_q8"] - got["dense_q8"]).max())
    out["int8 KV cuda vs dense, 2 layers"] = err
    log(f"  int8 KV cuda vs dense, 2 layers: max|diff| {err:.3e} (codes "
        f"of the second layer may differ by one step; not held to "
        f"{SCHED32_TOL:g})")
    del caches
    cfg16 = dataclasses.replace(cfg, n_layers=2)
    p16 = _layers(params, 2, torch.bfloat16)
    for kv in (None, "int8"):
        n = step_paged_vs_contiguous(cfg16, p16, kv)
        log(f"  one step on a paged cache (pages out of order) == the same "
            f"step on a contiguous cache, {kv or 'bf16'} KV: {n} values "
            f"equal bit for bit")
    return out


# ---------------------------------------------------------------------------
# phases 12 and 12b: minicpm3-4b (MLA) at full width
# ---------------------------------------------------------------------------

def build_mla_model():
    """minicpm3-4b ``FULL`` with random seeded bf16 weights, on the kernels
    (``attn_impl="cuda"``; its config's own default is the blocked path)."""
    from repro_torch.configs.minicpm3_4b import FULL
    from repro_torch.models.transformer import init_params
    t0 = time.perf_counter()
    cfg = dataclasses.replace(FULL, attn_impl="cuda")
    params = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    n = sum(p.numel() for lp in params["layers"] for p in _leaves(lp))
    log(f"  minicpm3-4b FULL params on card: {n / 1e9:.2f}B per-layer "
        f"weights + {params['embed'].numel() / 1e6:.1f}M tied embedding, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB, "
        f"{time.perf_counter() - t0:.1f}s")
    return cfg, params


def phase_mla(kernels):
    """minicpm3-4b FULL on the kernels, bf16: prefill (kernel 1 at Dqk 96,
    Dv 64 over 40 kv heads), the decode path of phase 4 (kernel 4's MLA
    mode), the scheduler of phase 9 on paged bf16 and paged int8 latent KV,
    then the fp32 checks at 2 layers (12b). Returns the launches of its
    main paths and its times; frees its weights."""
    log("phase 12: minicpm3-4b (MLA) FULL, bf16, attn_impl cuda")
    cfg, params = build_mla_model()
    users, prompts = serving_material(cfg)
    kernels.reset_launches()
    server, p_prefill = phase_prefill(cfg, params, prompts, kernels)
    run = phase_decode(cfg, params, users, server, p_prefill, kernels)
    launches = dict(kernels.LAUNCHES)
    want = {k: 0 for k in kernels.KERNELS}
    want.update(windowed_attn=cfg.n_layers * (1 + run["n_prefill_calls"]),
                decode_attn_mla=cfg.n_layers * run["n_steps"])
    log(f"  MLA serving path launches {launches}: kernel 1 in "
        f"{1 + run['n_prefill_calls']} prefill calls, kernel 4's MLA mode "
        f"in {run['n_steps']} decode steps")
    if launches != want:
        fail(f"MLA serving path launches {launches}, want {want}")

    times = dict(prefill_ms=cuda_ms(lambda: server.score(prompts), iters=3,
                                    warmup=1),
                 decode_ms=cuda_ms(lambda: run["decode"](
                     params, run["cache"], *run["burst_args"]), iters=5,
                     warmup=1))
    card = card_line()
    log(f"  minicpm3-4b prefill call B=8 S=2048 62 layers: "
        f"{times['prefill_ms']:.2f} ms; decode burst step B=8 s=64 "
        f"cap=2048: {times['decode_ms']:.2f} ms ({card})")
    profile_call(lambda: run["decode"](params, run["cache"],
                                       *run["burst_args"]),
                 "minicpm3-4b decode burst step B=8 s=64 cap=2048")
    profile_call(lambda: server.score(prompts),
                 "minicpm3-4b prefill call B=8 S=2048 62 layers")
    del run, server
    torch.cuda.empty_cache()

    reqs = sched_stream(cfg, N_REQ)
    log(f"phase 12: ServeScheduler on the latent cache, phase 9's stream "
        f"({N_REQ} requests), {SCHED}")
    sched = {}
    for key, kv in (("bf16", None), ("int8", "int8")):
        label = f"12 scheduler, paged {key} MLA KV"
        res = run_sched(cfg, params, reqs, kernels, kv_dtype=kv, paged=True,
                        label=label)
        res.pop("sched")
        check_sched_run(res, cfg, decode_kernel(cfg, kv), label)
        for name, n in res["launches"].items():
            launches[name] += n
        sched[key] = res
        torch.cuda.empty_cache()
    oracle, max_len = sched_oracle(cfg, params, reqs[:N_ORACLE])
    errs = {"bf16 vs oracle": float(np.abs(sched["bf16"]["scores"][:N_ORACLE]
                                           - oracle).max()),
            "int8 vs bf16": float(np.abs(sched["int8"]["scores"]
                                         - sched["bf16"]["scores"]).max())}
    log(f"  max |score diff|: {errs} (tol {SCHED_TOL}; oracle: "
        f"{len(oracle) * len(oracle[0])} sliding-window prompts of max_len "
        f"{max_len})")
    for name, err in errs.items():
        if not err <= SCHED_TOL:
            fail(f"phase 12 scores {name} differ by {err}")
    for key, res in sched.items():
        tel = res["tel"]
        times[f"sched_{key}"] = (res["wall"] * 1e3 / tel["steps"],
                                 res["candidates"] / res["wall"])
        log(f"  scheduler, {key} KV: {times[f'sched_{key}'][0]:.2f} ms per "
            f"step over {tel['steps']} steps, "
            f"{times[f'sched_{key}'][1]:.1f} candidates/s, KV bytes "
            f"{res['kv_bytes']}, host per step {res['host_ms']:.3f} ms "
            f"({card})")
    checks = phase_mla32(cfg, params, users, prompts, kernels)
    del params
    torch.cuda.empty_cache()
    return dict(launches=launches, times=times, errs=errs, checks=checks)


def phase_mla32(cfg, params, users, prompts, kernels):
    """12b: minicpm3-4b at FULL widths, 2 layers, fp32: the kernel path
    against the dense path (prefill, every decode step of phase 4's path,
    the first 6 scheduler requests on paged fp32 latent KV) within
    SCHED32_TOL (summation order); then, in bf16, one decode step on a
    paged int8 latent cache (pages out of order) equal bit for bit to the
    same step on a contiguous one."""
    log("phase 12b: minicpm3-4b FULL widths, 2 layers, fp32: kernel path vs "
        "dense path")
    c32 = dataclasses.replace(cfg, n_layers=2, param_dtype="float32",
                              compute_dtype="float32")
    p32 = _layers(params, 2, torch.float32)
    out = {"prefill": float(np.abs(_score(c32, p32, prompts, "cuda")
                                   - _score(c32, p32, prompts, "dense",
                                            batch=4)).max())}
    dec = drive_decode(c32, p32, users, kernels)["valid_p"]
    dec_dense = drive_decode(dataclasses.replace(c32, attn_impl="dense"),
                             p32, users, kernels)["valid_p"]
    out["decode"] = float(np.abs(dec - dec_dense).max())
    reqs = sched_stream(cfg, N_REQ_SHORT)
    got = {impl: run_sched(c32, p32, reqs, kernels, kv_dtype=None,
                           paged=True, attn_impl=impl,
                           label=f"12b {impl}, 2 layers")
           for impl in ("cuda", "dense")}
    for impl, res in got.items():
        if res["finished"] != len(reqs):
            fail(f"phase 12b {impl}: {res['finished']} requests finished")
    out["scheduler"] = float(np.abs(got["cuda"]["scores"]
                                    - got["dense"]["scores"]).max())
    del got, p32
    for name, err in out.items():
        log(f"  fp32 {name}: max|p_cuda - p_dense| {err:.3e} (tol "
            f"{SCHED32_TOL:g})")
        if not err <= SCHED32_TOL:
            fail(f"phase 12b {name}: kernel path differs from dense by {err}")
    n = step_paged_vs_contiguous(dataclasses.replace(cfg, n_layers=2),
                                 _layers(params, 2, cfg.pdtype), "int8")
    log(f"  one step on a paged int8 latent cache (pages out of order) == "
        f"the same step on a contiguous cache: {n} values equal bit for bit")
    out["int8 1 layer"] = int8_one_layer_check(cfg, params, kernels, "12b")
    return out


# ---------------------------------------------------------------------------
# phases 13 and 13b: minicpm3-4b (MLA) training at full width
# ---------------------------------------------------------------------------

def check_mla_train_kernels():
    """Phase 13's first part, off the main path: kernels 2 and 3 at
    minicpm3-4b's training shape (B=8, S=2048, H = Hk = 40, Dqk 96, Dv 64,
    NoPE + reset, [SUM] rows in each row's tail) in bf16, twice (the same
    bits), held to the fp32 plain version row by row as phase 2d holds
    them (``hold_train_grads``); then cross-segment gradients at these
    head dims, which must be exactly 0. Returns what phase 6 times."""
    from repro_torch.kernels.windowed_attn import windowed_attention_bwd_plain
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    log("phase 13: windowed_attn_dq / windowed_attn_dkv at minicpm3-4b's "
        "training shape (B=8 S=2048 H=Hk=40 Dqk 96 Dv 64 window 1024, NoPE "
        "+ reset, 20 [SUM] rows in each row's tail), bf16 kernels vs the "
        "fp32 plain version")
    o, kw = train_windowed(gen, heads=MLA_HEADS)
    errs = hold_train_grads(o, kw, "MLA tail")
    plain_ms = cuda_ms(lambda: windowed_attention_bwd_plain(
        o["q"], o["k"], o["v"], o["do"], **kw), iters=1, warmup=1)
    for lens, window, seed, with_sum, target in (([12, 9, 7], 8, 0, True, 1),
                                                 ([5, 17], 4, 1, False, 0)):
        leak = card_leakage(lens, window=window, seed=seed,
                            with_sum=with_sum, target_seg=target,
                            D=MLA_HEADS["D"], Dv=MLA_HEADS["Dv"])
        log(f"  segments {lens} window {window} [SUM] {with_sum}, Dqk 96 Dv "
            f"64: largest cross-segment |grad| {leak}")
        if leak != 0.0:
            fail(f"gradient leaks across segments at Dqk 96, Dv 64: {leak}")
    return dict(ops=(o, kw), plain_ms=plain_ms, errs=errs)


def phase_mla_train(kernels):
    """Phases 13 and 13b: minicpm3-4b ``FULL`` (62 layers, MLA, random
    seeded bf16 weights with LoRA rank 8, nonzero ``lora_b``) trains on
    kernels 1-3 at Dqk 96, Dv 64 through phase 7's path (remat, reset and
    ALiBi on, ``trainable="lora"``); then 13b, at 2 layers in fp32, the
    kernel path against the dense path. Returns the training path's
    launches, its times, 13b's diffs and what phase 6 times; frees its
    weights."""
    from repro_torch.configs.minicpm3_4b import FULL
    from repro_torch.models.transformer import count_params, init_params
    bwd = check_mla_train_kernels()
    cfg = dataclasses.replace(FULL, attn_impl="cuda", lora_rank=8)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=1)
    nonzero_lora(params, seed=4)
    torch.cuda.synchronize()
    log(f"  {cfg.name} FULL with LoRA rank {cfg.lora_rank}: "
        f"{count_params(params) / 1e9:.3f}B parameters, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on card, "
        f"{time.perf_counter() - t0:.1f}s")
    mat = training_material(cfg)
    train = phase_train(cfg, params, mat, kernels, phase="13")
    times = time_train(cfg, params, mat, train)
    state = {"s": train["state"]}

    def one_step():   # two more LoRA steps; every check ran before
        state["s"] = train["step_fn"](state["s"], mat["batches"][0])[0]
    profile_call(one_step, f"{cfg.name} train step B={TRAIN_ROWS} "
                 f"S={TRAIN_LEN} {cfg.n_layers} layers")
    launches = train["launches"]
    del train, state
    torch.cuda.empty_cache()
    check = phase_fp32_train_check(cfg, params, mat, phase="13b")
    del params
    torch.cuda.empty_cache()
    return dict(launches=launches, times=times, check=check, bwd=bwd)


# ---------------------------------------------------------------------------
# phases 14 and 14b: qwen2-moe-a2.7b (MoE) serving at full width
# ---------------------------------------------------------------------------

class _MoeRouting:
    """While installed over the MoE FFN the model calls
    (``repro_torch.models.transformer.moe_ffn``, through which prefill and
    decode reach it), records per call the number of dropped (token,
    expert) choices and each token's top-k set (sorted expert ids, (B, S,
    k) on the host). The routing is computed once more for the record."""

    def __init__(self):
        import repro_torch.models.transformer as tr
        from repro_torch.models.moe import route
        self.calls = []
        self._tr, self._orig = tr, tr.moe_ffn

        def recorded(p, x, **kw):
            b, s, d = x.shape
            _, _, ids, _, keep, _ = route(p, x.reshape(-1, d), **{
                k: kw[k] for k in ("n_experts", "top_k", "capacity_factor",
                                   "norm_topk")})
            self.calls.append((int((~keep).sum()), int(keep.numel()),
                               torch.sort(ids, -1).values.reshape(b, s, -1)
                               .cpu()))
            return self._orig(p, x, **kw)
        tr.moe_ffn = recorded

    def dropped(self):
        """(dropped choices, all choices) over the recorded calls."""
        return (sum(c[0] for c in self.calls), sum(c[1] for c in self.calls))

    def close(self):
        self._tr.moe_ffn = self._orig


def no_drop(cfg):
    """``cfg`` at the capacity factor n_experts / top_k, where an expert's
    capacity is every token of a call: no choice can be dropped, and a
    token's route does not depend on the other tokens of its call (the
    reference's own decode-equals-prefill test raises the factor for the
    same reason, ``tests/test_serve.py:17-18``)."""
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


def build_moe_model():
    """qwen2-moe-a2.7b ``FULL`` with random seeded bf16 weights, on the
    kernels (``attn_impl="cuda"``; its config's own default is the blocked
    path)."""
    from repro_torch.configs.qwen2_moe_a2_7b import FULL
    from repro_torch.models.transformer import count_params, init_params
    t0 = time.perf_counter()
    cfg = dataclasses.replace(FULL, attn_impl="cuda")
    params = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    lp = params["layers"][0]
    part = lambda t: sum(x.numel() for x in _leaves(t))
    log(f"  qwen2-moe-a2.7b FULL params on card: count_params "
        f"{count_params(params)} ({count_params(params) / 1e9:.2f}B; per "
        f"layer experts {part({k: lp['ffn'][k] for k in ('w_gate', 'w_up', 'w_down')}) / 1e6:.1f}M, "
        f"shared {part(lp['ffn']['shared']) / 1e6:.1f}M, attention "
        f"{part(lp['attn']) / 1e6:.1f}M; embed and lm_head "
        f"{params['embed'].numel() / 1e6:.1f}M each), "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB, "
        f"{time.perf_counter() - t0:.1f}s")
    return cfg, params


def serve_plain_calls():
    """A counter of the serving path's attention plain versions (prefill's
    and decode's)."""
    import repro_torch.core.windowed as cw
    import repro_torch.kernels.windowed_attn as wa
    from repro_torch.serve import engine
    return _PlainCalls([(wa, "windowed_attention_plain"),
                        (wa, "attention_dense"), (cw, "attention_dense"),
                        (engine, "decode_attention_plain"),
                        (engine, "decode_attention_mla_plain")])


def phase_moe(kernels):
    """Phase 14: qwen2-moe-a2.7b FULL on the kernels, bf16, the counts set
    to 0 before it and read after it: phases 3 and 4 on it at ``no_drop``
    capacity (``CTRServer.score`` with kernel 1 once per layer, the
    chunked context, the 6-candidate burst held to per-candidate prefill,
    ring steps, kernel 4's GQA mode once per layer per step, no plain
    call, no dropped choice); then at the config's capacity factor 1.25
    the timed prefill call and decode burst step, their profiles and
    drops, and peak memory; then 14b. Returns the launches, times and
    checks; frees its weights."""
    from repro_torch.serve.engine import CTRServer, make_decode_fn
    log("phase 14: qwen2-moe-a2.7b (MoE) FULL, bf16, attn_impl cuda")
    cfg, params = build_moe_model()
    users, prompts = serving_material(cfg)
    nd = no_drop(cfg)
    log(f"  serving logic checks at capacity factor {nd.capacity_factor:g} "
        f"(n_experts / top_k: no choice can drop)")
    torch.cuda.reset_peak_memory_stats()
    routing, plain = _MoeRouting(), serve_plain_calls()
    kernels.reset_launches()
    try:
        server, p_prefill = phase_prefill(nd, params, prompts, kernels)
        run = phase_decode(nd, params, users, server, p_prefill, kernels)
    finally:
        plain.close()
        routing.close()
    launches = dict(kernels.LAUNCHES)
    want = {k: 0 for k in kernels.KERNELS}
    want.update(windowed_attn=cfg.n_layers * (1 + run["n_prefill_calls"]),
                decode_attn=cfg.n_layers * run["n_steps"])
    dropped, choices = routing.dropped()
    log(f"  MoE serving path launches {launches}: kernel 1 in "
        f"{1 + run['n_prefill_calls']} prefill calls, kernel 4 in "
        f"{run['n_steps']} decode steps; plain attention calls {plain.n}; "
        f"dropped choices {dropped} of {choices}")
    if launches != want:
        fail(f"MoE serving path launches {launches}, want {want}")
    if plain.n:
        fail(f"the plain attention ran {plain.n} times on the MoE path")
    if dropped:
        fail(f"{dropped} choices dropped at capacity factor "
             f"{nd.capacity_factor}")
    del server, routing

    server = CTRServer(params, cfg, max_len=MAX_LEN)
    decode = make_decode_fn(cfg, window=cfg.window, ring=False)
    burst = lambda: decode(params, run["cache"], *run["burst_args"])
    times = dict(prefill_ms=cuda_ms(lambda: server.score(prompts), iters=3,
                                    warmup=1),
                 decode_ms=cuda_ms(burst, iters=5, warmup=1))
    times["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    card = card_line()
    log(f"  qwen2-moe-a2.7b at capacity factor {cfg.capacity_factor}: "
        f"prefill call B=8 S=2048 24 layers {times['prefill_ms']:.2f} ms; "
        f"decode burst step B=8 s=64 cap=2048 {times['decode_ms']:.2f} ms; "
        f"peak memory {times['peak_gib']:.2f} GiB ({card})")
    routing = _MoeRouting()
    try:
        server.score(prompts)
        n_pre = routing.dropped()
        burst()
    finally:
        routing.close()
    d_all = routing.dropped()
    times["drops"] = dict(prefill=n_pre, burst=(d_all[0] - n_pre[0],
                                                d_all[1] - n_pre[1]))
    log(f"  dropped (token, expert) choices at capacity factor "
        f"{cfg.capacity_factor}: prefill call {n_pre[0]} of {n_pre[1]}, "
        f"burst step {times['drops']['burst'][0]} of "
        f"{times['drops']['burst'][1]}")
    profile_call(burst, "qwen2-moe-a2.7b decode burst step B=8 s=64 "
                 "cap=2048")
    profile_call(lambda: server.score(prompts),
                 "qwen2-moe-a2.7b prefill call B=8 S=2048 24 layers")
    del run, server
    torch.cuda.empty_cache()
    checks = phase_moe32(cfg, params, kernels)
    del params
    torch.cuda.empty_cache()
    return dict(launches=launches, times=times, checks=checks)


def phase_moe32(cfg, params, kernels, seeds=(0, 1, 2)):
    """14b: qwen2-moe-a2.7b at FULL widths, 2 layers, fp32, ``no_drop``
    capacity: the kernel path against the dense path, prefill and every
    decode step of phase 4's path, within P32_TOL. A token whose top-k set
    differs between the two paths (a router near-tie broken the other way
    by a rounding) changes its FFN output by far more than summation
    order, so the scores are held only on a run where no token's set
    differs; each run prints the count, and the phase fails when every
    seed of the serving material gives a nonzero count."""
    log("phase 14b: qwen2-moe-a2.7b FULL widths, 2 layers, fp32: kernel "
        "path vs dense path")
    c32 = no_drop(dataclasses.replace(cfg, n_layers=2, param_dtype="float32",
                                      compute_dtype="float32"))
    p32 = _layers(params, 2, torch.float32)
    for seed in seeds:
        users, prompts = serving_material(c32, seed=seed)
        got = {}
        for impl in ("cuda", "dense"):
            routing = _MoeRouting()
            try:
                pre = _score(c32, p32, prompts, impl)
                dec = drive_decode(dataclasses.replace(c32, attn_impl=impl),
                                   p32, users, kernels)["valid_p"]
            finally:
                routing.close()
            got[impl] = (pre, dec, routing.calls)
        calls = list(zip(got["cuda"][2], got["dense"][2]))
        if len(got["cuda"][2]) != len(got["dense"][2]) or any(
                a[2].shape != b[2].shape for a, b in calls):
            fail("phase 14b: the two paths made different MoE calls")
        flips = sum(int((a[2] != b[2]).any(-1).sum()) for a, b in calls)
        tokens = sum(a[2].shape[0] * a[2].shape[1] for a, _ in calls)
        out = {"prefill": float(np.abs(got["cuda"][0] - got["dense"][0]).max()),
               "decode": float(np.abs(got["cuda"][1] - got["dense"][1]).max())}
        log(f"  seed {seed}: tokens whose top-k set differs between the "
            f"paths {flips} of {tokens} routed; max|p_cuda - p_dense| "
            f"prefill {out['prefill']:.3e}, decode over "
            f"{got['cuda'][1].size} tokens {out['decode']:.3e} (tol "
            f"{P32_TOL}{'' if flips == 0 else ', not held: a route differs'})")
        if flips == 0:
            for name, err in out.items():
                if not err <= P32_TOL:
                    fail(f"phase 14b {name}: kernel path differs from dense "
                         f"by {err}")
            del p32
            torch.cuda.empty_cache()
            return dict(out, seed=seed)
    fail(f"phase 14b: a token's top-k set differs between the paths on "
         f"every seed {seeds}")


# ---------------------------------------------------------------------------
# phase 15: minicpm-2b and qwen2-1.5b (GQA) serving at full width
# ---------------------------------------------------------------------------

def phase_gqa_archs(kernels):
    """Phase 15: minicpm-2b (36/36 heads, head dim 64) and qwen2-1.5b
    (12/2 heads, head dim 128) FULL on the kernels, bf16: phases 3 and 4
    on each (kernel 1 once per layer per prefill call, kernel 4's GQA mode
    once per layer per step, no plain call), one prefill call and one
    decode burst step timed; then at 2 layers in fp32 the kernel path
    against the dense path, prefill and every decode step, within
    SCHED32_TOL. Returns the launches, times and diffs; frees the
    weights."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import count_params, init_params
    out = dict(launches={k: 0 for k in kernels.KERNELS}, times={},
               checks={})
    for name in ("minicpm-2b", "qwen2-1.5b"):
        log(f"phase 15: {name} FULL, bf16, attn_impl cuda")
        cfg = dataclasses.replace(get_arch(name).config, attn_impl="cuda")
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0)
        torch.cuda.synchronize()
        log(f"  {name} FULL params on card: {count_params(params) / 1e9:.3f}B"
            f", {torch.cuda.memory_allocated() / 2**30:.1f} GiB, "
            f"{time.perf_counter() - t0:.1f}s")
        users, prompts = serving_material(cfg)
        plain = serve_plain_calls()
        kernels.reset_launches()
        try:
            server, p_prefill = phase_prefill(cfg, params, prompts, kernels)
            run = phase_decode(cfg, params, users, server, p_prefill,
                               kernels)
        finally:
            plain.close()
        launches = dict(kernels.LAUNCHES)
        want = {k: 0 for k in kernels.KERNELS}
        want.update(windowed_attn=cfg.n_layers * (1 + run["n_prefill_calls"]),
                    decode_attn=cfg.n_layers * run["n_steps"])
        log(f"  {name} serving path launches {launches}; plain attention "
            f"calls {plain.n}")
        if launches != want:
            fail(f"{name} serving path launches {launches}, want {want}")
        if plain.n:
            fail(f"the plain attention ran {plain.n} times on {name}")
        for k, n in launches.items():
            out["launches"][k] += n
        t = dict(prefill_ms=cuda_ms(lambda: server.score(prompts), iters=3,
                                    warmup=1),
                 decode_ms=cuda_ms(lambda: run["decode"](
                     params, run["cache"], *run["burst_args"]), iters=5,
                     warmup=1))
        log(f"  {name} prefill call B=8 S=2048 {cfg.n_layers} layers: "
            f"{t['prefill_ms']:.2f} ms; decode burst step B=8 s=64 cap=2048: "
            f"{t['decode_ms']:.2f} ms ({card_line()})")
        out["times"][name] = t
        del run, server
        c32 = dataclasses.replace(cfg, n_layers=2, param_dtype="float32",
                                  compute_dtype="float32")
        p32 = _layers(params, 2, torch.float32)
        del params
        torch.cuda.empty_cache()
        diffs = {"prefill": float(np.abs(
            _score(c32, p32, prompts, "cuda")
            - _score(c32, p32, prompts, "dense", batch=4)).max())}
        dec = drive_decode(c32, p32, users, kernels)["valid_p"]
        dec_dense = drive_decode(dataclasses.replace(c32, attn_impl="dense"),
                                 p32, users, kernels)["valid_p"]
        diffs["decode"] = float(np.abs(dec - dec_dense).max())
        del p32
        torch.cuda.empty_cache()
        for part, err in diffs.items():
            log(f"  {name} fp32, 2 layers, {part}: max|p_cuda - p_dense| "
                f"{err:.3e} (tol {SCHED32_TOL:g})")
            if not err <= SCHED32_TOL:
                fail(f"phase 15 {name} {part}: kernel path differs from "
                     f"dense by {err}")
        out["checks"][name] = diffs
    return out


# ---------------------------------------------------------------------------
# phase 16: gin-tu (GNN) training at the four GNN shapes
# ---------------------------------------------------------------------------

# (a) full_graph_sm, the card against the CPU in fp32 on the same weights:
# summation order only, phase 11a's tolerances (REC_*). Every shape: two
# steps from one state give equal bits (loss, gradients, params).
GNN_CHECK_STEPS = 3
GNN_TIMED = {"full_graph_sm": 10, "minibatch_lg": 5, "ogb_products": 3,
             "molecule": 10}
# the reference cell's optimizer (repro/launch/steps.py::_gnn_cell)
GNN_OPT = dict(lr=1e-3, schedule="cosine", total_steps=5_000)


def _pad_edges(es, ed, n_edges):
    """Edges padded to ``n_edges`` with invalid (0, 0) pad edges."""
    ev = np.zeros(n_edges, bool)
    ev[:len(es)] = True
    pad = lambda a: np.concatenate([a, np.zeros(n_edges - len(a), np.int32)])
    return pad(es), pad(ed), ev


def _pad_nodes(x, y, n_nodes):
    xp = np.zeros((n_nodes, x.shape[1]), np.float32)
    xp[:len(x)] = x
    yp = np.zeros(n_nodes, np.int32)
    yp[:len(y)] = y
    mask = np.arange(n_nodes) < len(x)
    return xp, yp, mask


def gnn_host_graph(shape_name):
    """Host material of one GNN shape (run in a worker process while the
    card serves the earlier phases): node features, labels, the label
    mask, padded edges with their valid mask; ``host_s`` the seconds the
    generator and sampler took."""
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.data.sampler import (make_community_graph,
                                          make_molecule_batch,
                                          sample_neighbors)
    p = GNN_SHAPES[shape_name].params
    t0 = time.perf_counter()
    out = {}
    if shape_name == "full_graph_sm":
        # 2708 x 4 draws 10,832 edges: a seeded subset of the literature's
        # 10,556, padded to the cell's counts
        g = make_community_graph(p["n_nodes_raw"], 4, p["d_feat"],
                                 p["n_classes"], seed=0)
        es, ed = g.edge_list()
        keep = np.sort(np.random.default_rng(1).choice(
            len(es), p["n_edges_raw"], replace=False))
        out["x"], out["labels"], out["label_mask"] = _pad_nodes(
            g.x, g.y, p["n_nodes"])
        out["edges"] = _pad_edges(es[keep], ed[keep], p["n_edges"])
        out["graph"] = f"{g.n_nodes} nodes, {g.n_edges} edges drawn"
    elif shape_name == "minibatch_lg":
        g = make_community_graph(p["n_nodes"], round(p["n_edges"]
                                                     / p["n_nodes"]),
                                 p["d_feat"], p["n_classes"], seed=0)
        out["graph_s"] = time.perf_counter() - t0
        seeds = np.random.default_rng(2).choice(g.n_nodes, p["batch_nodes"],
                                                replace=False)
        sg = sample_neighbors(g, seeds, p["fanouts"],
                              rng=np.random.default_rng(3))
        ok = sg.node_valid
        x = np.zeros((len(ok), g.x.shape[1]), np.float32)
        x[ok] = g.x[sg.node_ids[ok]]
        y = np.zeros(len(ok), np.int32)
        y[ok] = g.y[sg.node_ids[ok]]
        out["x"], out["labels"] = x, y
        out["label_mask"] = np.zeros(len(ok), bool)
        out["label_mask"][sg.seed_local] = True
        out["edges"] = (sg.edge_src, sg.edge_dst, sg.edge_valid)
        out["graph"] = (f"{g.n_nodes} nodes, {g.n_edges} edges on the host; "
                        f"sampled {int(ok.sum())} nodes, "
                        f"{int(sg.edge_valid.sum())} edges")
    elif shape_name == "ogb_products":
        g = make_community_graph(p["n_nodes_raw"], 25, p["d_feat"],
                                 p["n_classes"], seed=0)
        es, ed = g.edge_list()
        out["x"], out["labels"], out["label_mask"] = _pad_nodes(
            g.x, g.y, p["n_nodes"])
        out["edges"] = _pad_edges(es, ed, p["n_edges"])
        out["graph"] = f"{g.n_nodes} nodes, {g.n_edges} edges drawn"
    else:
        x, es, ed, gid, y = make_molecule_batch(
            p["batch"], p["n_nodes"], p["n_edges"], p["d_feat"],
            p["n_classes"], seed=0)
        out.update(x=x, labels=y, graph_ids=gid, n_graphs=p["batch"],
                   edges=(es, ed, np.ones(len(es), bool)))
        out["graph"] = f"{p['batch']} graphs, {len(x)} nodes, {len(es)} edges"
    out["host_s"] = time.perf_counter() - t0
    return out


GRAPH_DIR = ROOT / "build" / "gnn_graphs"


def gnn_graph_file(shape_name, path):
    """Worker: build the shape's host graph and save its arrays to
    ``path`` (.npz); returns the rest. Gigabytes of arrays through the
    executor's pipe would be unpickled by a thread of the main process,
    which then takes the interpreter lock from the phases driving the
    card for minutes."""
    mat = gnn_host_graph(shape_name)
    es, ed, ev = mat.pop("edges")
    arrays = {k: v for k, v in mat.items() if isinstance(v, np.ndarray)}
    np.savez(path, es=es, ed=ed, ev=ev, **arrays)
    return {k: v for k, v in mat.items() if k not in arrays}


def start_gnn_graphs():
    """The two large graphs (114.6M and 61.2M edges) take minutes of host
    time: build them in two worker processes while the card runs the
    earlier phases. Returns (executor, {shape: (future, file)})."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    GRAPH_DIR.mkdir(parents=True, exist_ok=True)
    ex = ProcessPoolExecutor(max_workers=2,
                             mp_context=multiprocessing.get_context("spawn"))
    jobs = {}
    for s in ("minibatch_lg", "ogb_products"):
        path = GRAPH_DIR / f"{s}.npz"
        jobs[s] = (ex.submit(gnn_graph_file, s, path), path)
    return ex, jobs


def load_gnn_graph(job):
    fut, path = job
    meta = fut.result()
    with np.load(path) as z:
        mat = {k: z[k] for k in z.files}
    path.unlink()
    mat["edges"] = (mat.pop("es"), mat.pop("ed"), mat.pop("ev"))
    mat.update(meta)
    return mat


def _gnn_loss(cfg, plan, readout=None):
    from repro_torch.launch.smoke import _ce
    from repro_torch.models.gnn import gin_forward, gin_graph_forward

    def loss_fn(p, b, _gen):
        if readout is not None:
            logits = gin_graph_forward(p, cfg, b["x"], plan=plan,
                                       readout=readout)
            return _ce(logits, b["labels"]), {}
        logits = gin_forward(p, cfg, b["x"], plan=plan)
        return _ce(logits, b["labels"], b["label_mask"]), {}
    return loss_fn


def _gnn_setup(cfg, mat, device, seed=0):
    """Params, plans, the step function and its batch on ``device``."""
    from repro_torch.device import resolve_device
    from repro_torch.models.gnn import (init_gin, make_edge_plan,
                                        make_readout_plan)
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import make_train_step
    device = resolve_device(device)
    es, ed, ev = mat["edges"]
    n = len(mat["x"])
    plan = make_edge_plan(es, ed, n, ev, device=device)
    readout = (make_readout_plan(mat["graph_ids"], mat["n_graphs"],
                                 device=device)
               if "graph_ids" in mat else None)
    batch = {k: torch.from_numpy(np.asarray(mat[k])).to(device)
             for k in ("x", "labels", "label_mask") if k in mat}
    params = init_gin(cfg, seed=seed, device=device)
    ocfg = OptimizerConfig(**GNN_OPT)
    step = make_train_step(_gnn_loss(cfg, plan, readout), ocfg)
    return dict(params=params, plan=plan, readout=readout, batch=batch,
                ocfg=ocfg, step=step, loss_fn=_gnn_loss(cfg, plan, readout))


def _gnn_grads(s):
    from repro_torch.models.transformer import differentiable
    with differentiable(s["params"]) as leaves:
        loss, _ = s["loss_fn"](s["params"], s["batch"], None)
        loss.backward()
        return loss.detach(), [t.grad.clone() for t in leaves]


def phase_gnn_cut(cfg, mat):
    """16a: full_graph_sm, the card against the CPU on the same fp32
    weights: logits, then GNN_CHECK_STEPS AdamW losses."""
    from repro_torch.models.gnn import gin_forward
    from repro_torch.train.trainer import init_train_state
    cpu, card = _gnn_setup(cfg, mat, "cpu"), _gnn_setup(cfg, mat, "cuda")
    card["params"] = _tree_to(cpu["params"], "cuda")
    with torch.no_grad():
        z_cpu = gin_forward(cpu["params"], cfg, cpu["batch"]["x"],
                            plan=cpu["plan"])
        z_card = gin_forward(card["params"], cfg, card["batch"]["x"],
                             plan=card["plan"])
    tol = REC_TOL * z_cpu.abs().max().item() + REC_FLOOR
    check_close("gin-tu full_graph_sm logits, card vs CPU", z_card.cpu(),
                z_cpu, tol)
    losses = []
    for s in (cpu, card):
        state, ls = init_train_state(s["params"], s["ocfg"]), []
        for _ in range(GNN_CHECK_STEPS):
            state, m = s["step"](state, s["batch"])
            ls.append(float(m["loss"]))
        losses.append(ls)
    diff = max(abs(a - c) for a, c in zip(*losses))
    log(f"  gin-tu full_graph_sm {GNN_CHECK_STEPS} AdamW steps: losses card "
        f"{[round(x, 6) for x in losses[1]]}, max |card - CPU| {diff:.3e} "
        f"(tol {REC_LOSS_TOL:g})")
    if not diff <= REC_LOSS_TOL:
        fail(f"gin-tu full_graph_sm: AdamW losses differ by {diff}")
    return diff


def gnn_bound(cfg, n_nodes, n_edges, chunk_edges):
    """Device memory reckoning for one shape in fp32 (bytes): x, h per
    layer, the (E, d) messages a layer would hold if materialised, and
    the chunked plan's transient."""
    f = 4
    return dict(x=n_nodes * cfg.d_feat * f, h_layer=n_nodes * cfg.d_hidden * f,
                msgs_layer=n_edges * cfg.d_hidden * f,
                chunk=min(n_edges, chunk_edges) * cfg.d_hidden * f,
                plan=n_edges * (8 * 4 + 4 * 2))


def phase_gnn_shape(shape_name, mat):
    """One GNN shape on the card: train steps timed (median after a
    warm-up step), nodes per second, peak memory; two steps and two
    gradient passes from one state equal bit for bit; every layer's eps
    moved."""
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.configs.gin_tu import config_for_shape
    from repro_torch.models.gnn import CHUNK_EDGES
    from repro_torch.models.transformer import named_leaves
    from repro_torch.train.trainer import init_train_state
    cfg = config_for_shape(GNN_SHAPES[shape_name].params)
    n_nodes, n_edges = len(mat["x"]), len(mat["edges"][0])
    b = gnn_bound(cfg, n_nodes, n_edges, CHUNK_EDGES)
    log(f"  {shape_name}: {mat['graph']}; padded {n_nodes} nodes, {n_edges} "
        f"edges; host {mat['host_s']:.1f} s"
        + (f" (graph {mat['graph_s']:.1f} s)" if "graph_s" in mat else "")
        + f"; reckoning (fp32): x {b['x'] / 1e9:.3f} GB, h {b['h_layer'] / 1e9:.3f}"
        f" GB a layer, whole messages would be {b['msgs_layer'] / 1e9:.2f} GB "
        f"a layer, one chunk {b['chunk'] / 1e9:.3f} GB, plan "
        f"{b['plan'] / 1e9:.2f} GB")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()      # what earlier phases keep
    t0 = time.perf_counter()
    s = _gnn_setup(cfg, mat, "cuda")
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    state0 = init_train_state(s["params"], s["ocfg"])
    (s1, m1), (s2, m2) = (s["step"](state0, s["batch"]),
                          s["step"](state0, s["batch"]))
    (l1, g1), (l2, g2) = _gnn_grads(s), _gnn_grads(s)
    p1 = [t for _, t in named_leaves(s1.params)]
    p2 = [t for _, t in named_leaves(s2.params)]
    same = (torch.equal(m1["loss"], m2["loss"]) and torch.equal(l1, l2)
            and all(torch.equal(a, c) for a, c in zip(g1, g2))
            and all(torch.equal(a, c) for a, c in zip(p1, p2)))
    if not same:
        fail(f"gin-tu {shape_name}: two steps from one state differ")
    if not (np.isfinite(float(m1["loss"])) and all(
            bool(torch.isfinite(g).all()) for g in g1)):
        fail(f"gin-tu {shape_name}: non-finite loss or gradient")
    del s1, s2, g1, g2, p1, p2
    state = state0
    times, losses = [], []
    for i in range(1 + GNN_TIMED[shape_name]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = s["step"](state, s["batch"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated() - held
    eps = [float(state.params[f"layer{i}"]["eps"]) for i in range(cfg.n_layers)]
    if not all(e != 0.0 for e in eps):
        fail(f"gin-tu {shape_name}: eps did not move in every layer: {eps}")
    if not all(np.isfinite(losses)):
        fail(f"gin-tu {shape_name}: non-finite losses {losses}")
    step_ms = float(np.median(times[1:])) * 1e3
    out = dict(step_ms=step_ms, nodes_per_s=n_nodes / step_ms * 1e3,
               peak_gib=peak / 2**30, plan_s=plan_s, host_s=mat["host_s"],
               first_s=times[0], losses=(losses[0], losses[-1]))
    log(f"  {shape_name}: train step median {step_ms:.2f} ms over "
        f"{len(times) - 1} steps (first {times[0] * 1e3:.1f} ms; plan and "
        f"params {plan_s:.2f} s), {out['nodes_per_s']:.0f} nodes/s, peak "
        f"{out['peak_gib']:.2f} GiB above the {held / 2**30:.2f} GiB earlier "
        f"phases hold; loss {losses[0]:.4f} -> {losses[-1]:.4f};"
        f" two steps and two gradient passes from one state equal bit for "
        f"bit; eps {[round(e, 6) for e in eps]} ({card_line()})")
    if shape_name in ("minibatch_lg", "ogb_products"):
        st = {"s": state}

        def one():
            st["s"] = s["step"](st["s"], s["batch"])[0]
        out["busy_ms"] = profile_call(one, f"gin-tu {shape_name} train step")
    return out


def phase_gnn(kernels, graphs):
    """Phase 16: gin-tu FULL (5 layers, d_hidden 64, sum, learnable eps,
    fp32, remat) at the four GNN shapes, nothing cut; no kernel of the
    five on this path (the counts are read)."""
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.configs.gin_tu import config_for_shape
    log("phase 16: gin-tu (GIN) training at the four GNN shapes")
    ex, jobs = graphs
    kernels.reset_launches()
    out = {"times": {}}
    small = gnn_host_graph("full_graph_sm")
    out["cut"] = phase_gnn_cut(config_for_shape(
        GNN_SHAPES["full_graph_sm"].params), small)
    out["times"]["full_graph_sm"] = phase_gnn_shape("full_graph_sm", small)
    out["times"]["molecule"] = phase_gnn_shape("molecule",
                                               gnn_host_graph("molecule"))
    t0 = time.perf_counter()
    for name in ("minibatch_lg", "ogb_products"):
        mat = load_gnn_graph(jobs[name])
        log(f"  {name}: host graph ready after {time.perf_counter() - t0:.1f}"
            f" s of waiting in phase 16")
        out["times"][name] = phase_gnn_shape(name, mat)
        del mat
        torch.cuda.empty_cache()
    ex.shutdown()
    launches = dict(kernels.LAUNCHES)
    log(f"  gin-tu path launches {launches} (none of the five kernels is on "
        f"it)")
    if any(launches.values()):
        fail(f"gin-tu path launched {launches}")
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# phase 17: multi-target serving at dti-llama FULL width
# ---------------------------------------------------------------------------

MT_REQUESTS, MT_MAX_LEN = 8, 2048


def mt_requests(cfg):
    """The first MT_REQUESTS requests of phase 9's stream, as (context,
    candidates) pairs."""
    reqs = sched_stream(cfg, N_REQ)[:MT_REQUESTS]
    return reqs, [(r["context"], r["candidates"]) for r in reqs]


def mt_scores(cfg, params, pairs, per_call=MT_REQUESTS):
    from repro_torch.serve.engine import CTRServer
    server = CTRServer(params, cfg, max_len=MT_MAX_LEN)
    return np.asarray([s for i in range(0, len(pairs), per_call)
                       for s in server.score_multi_target(
                           pairs[i:i + per_call])])


def mt_fp32_check(cfg, params, reqs, pairs, label):
    """fp32 at 2 layers, FULL widths: multi-target scores (dense path)
    against the independent sliding-window prefills (kernel 1)."""
    got = mt_scores(cfg, params, pairs)
    want, _ = sched_oracle(cfg, params, reqs)
    err = float(np.abs(got - want).max())
    log(f"  {label} fp32, 2 layers: max|multi-target - independent| "
        f"{err:.3e} over {got.size} candidates (tol {P32_TOL:g})")
    if not err <= P32_TOL:
        fail(f"phase 17 {label}: multi-target differs from independent "
             f"prefills by {err}")
    return err


def phase_multi_target(cfg, params, kernels):
    """Phase 17: ``CTRServer.score_multi_target`` at dti-llama FULL width
    on phase 3's weights: the first 8 requests of phase 9's stream, one
    row of max_len 2048 each, the dense path (no kernel launch); against
    ``CTRServer.score`` over the 128 sliding-window prompts on kernel 1
    (its launches counted for kernel 1). Checks: bit-equal scores of the
    other candidates when one candidate's tokens and length change;
    bf16 at full depth within phase 5's drift rule against fp32; fp32 at
    2 layers within P32_TOL for GQA (dti-llama) and MLA (minicpm3-4b)."""
    from repro_torch.configs.minicpm3_4b import FULL as MLA_FULL
    from repro_torch.models.transformer import init_params
    log("phase 17: multi-target serving, dti-llama FULL, "
        f"{MT_REQUESTS} requests x 16 candidates, max_len {MT_MAX_LEN}")
    reqs, pairs = mt_requests(cfg)
    n_cand = sum(len(c) for _, c in pairs)
    lens = [1 + sum(map(len, ctx)) + sum(len(c) + 1 for c in cands)
            for ctx, cands in pairs]
    log(f"  row lengths {lens}, {n_cand} candidates")
    out = {}
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    base = mt_scores(cfg, params, pairs)
    out["mt_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if any(kernels.LAUNCHES.values()):
        fail(f"multi-target path launched {dict(kernels.LAUNCHES)}")
    if not (np.isfinite(base).all() and ((base > 0) & (base < 1)).all()):
        fail(f"multi-target p_click not in (0, 1): {base}")
    # one candidate changed (tokens and length): the rest keep their bits
    ctx0, cands0 = pairs[0]
    mutated = [list(c) for c in cands0]
    mutated[1] = [int(t) + 1 for t in cands0[1][1:]] + [7, 8]
    got = mt_scores(cfg, params, [(ctx0, mutated)] + pairs[1:])
    keep = np.ones(base.shape, bool)
    keep[0, 1] = False
    if not np.array_equal(got[keep], base[keep]):
        fail(f"multi-target leakage: {int((got[keep] != base[keep]).sum())} "
             f"other candidates' scores changed")
    if got[0, 1] == base[0, 1]:
        fail("multi-target: the changed candidate kept its score")
    log(f"  candidate 1 of request 0 changed ({len(cands0[1])} -> "
        f"{len(mutated[1])} tokens): the other {int(keep.sum())} scores "
        f"equal bit for bit, its own {base[0, 1]:.6f} -> {got[0, 1]:.6f}")
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    ind, ind_len = sched_oracle(cfg, params, reqs)
    out["ind_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["launches"] = dict(kernels.LAUNCHES)
    n_calls = sum(-(-len(c) // 8) for _, c in pairs)
    want = {k: 0 for k in kernels.KERNELS}
    want["windowed_attn"] = cfg.n_layers * n_calls
    log(f"  independent path: {n_cand} prompts of max_len {ind_len} in "
        f"{n_calls} CTRServer.score calls, launches {out['launches']}")
    if out["launches"] != want:
        fail(f"independent path launches {out['launches']}, want {want}")
    # bf16 at full depth: drift from fp32 (multi-target in fp32, 4
    # requests a call) no more than phase 5's rule allows against the
    # independent path's
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    params32 = _map_tensors(params, lambda t: t.float())
    p32 = mt_scores(cfg32, params32, pairs, per_call=4)
    del params32
    torch.cuda.empty_cache()
    drift_mt = float(np.abs(base - p32).max())
    drift_ind = float(np.abs(ind - p32).max())
    log(f"  bf16, {cfg.n_layers} layers: drift from fp32 multi-target: multi-target "
        f"{drift_mt:.3e}, independent {drift_ind:.3e} (allowed: 2 x "
        f"independent + {DRIFT_SLACK}); max|multi-target - independent| "
        f"{float(np.abs(base - ind).max()):.3e}")
    if not drift_mt <= 2 * drift_ind + DRIFT_SLACK:
        fail(f"multi-target bf16 drifts {drift_mt} from fp32, independent "
             f"path {drift_ind}")
    out["drift"] = (drift_mt, drift_ind)
    # times: one score_multi_target call of the 8 requests against the
    # same 128 candidates through score
    mt_s = _wall(lambda: mt_scores(cfg, params, pairs), 3)
    ind_s = _wall(lambda: sched_oracle(cfg, params, reqs), 2)
    out.update(mt_ms=mt_s * 1e3, ind_ms=ind_s * 1e3,
               mt_cand_s=n_cand / mt_s, ind_cand_s=n_cand / ind_s)
    log(f"  score_multi_target: {out['mt_ms']:.2f} ms a call of "
        f"{MT_REQUESTS} requests ({out['mt_cand_s']:.1f} candidates/s, peak "
        f"{out['mt_peak_gib']:.2f} GiB); score over the same {n_cand} "
        f"candidates: {out['ind_ms']:.2f} ms ({out['ind_cand_s']:.1f} "
        f"candidates/s, peak {out['ind_peak_gib']:.2f} GiB); "
        f"{out['ind_ms'] / out['mt_ms']:.2f}x ({card_line()})")
    out["profile_busy_ms"] = profile_call(
        lambda: mt_scores(cfg, params, pairs),
        f"score_multi_target {MT_REQUESTS} x {MT_MAX_LEN}")
    # fp32, 2 layers: GQA on these weights, MLA on minicpm3-4b's
    c32 = dataclasses.replace(cfg, n_layers=2, param_dtype="float32",
                              compute_dtype="float32")
    out["fp32"] = {"dti-llama": mt_fp32_check(
        c32, _layers(params, 2, torch.float32), reqs, pairs, "dti-llama")}
    m32 = dataclasses.replace(MLA_FULL, n_layers=2, attn_impl="cuda",
                              param_dtype="float32", compute_dtype="float32")
    mp = init_params(m32, seed=0)
    mreqs, mpairs = mt_requests(m32)
    out["fp32"]["minicpm3-4b"] = mt_fp32_check(m32, mp, mreqs, mpairs,
                                               "minicpm3-4b")
    del mp
    torch.cuda.empty_cache()
    return out


def _wall(fn, iters):
    """Median host seconds of ``fn`` (each call ends in a host copy of its
    result), after one warm-up call."""
    fn()
    ts = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


# ---------------------------------------------------------------------------
# phase 18: deepseek-v2-236b (MLA + MoE) serving at full width
# ---------------------------------------------------------------------------

DS_LAYERS = 3        # the dense first layer and two MoE layers
DS_PER_CALL = 2      # prompts a prefill call at the no-drop factor (4,096 tokens)
DS_REQ = 8           # the scheduler's requests


def build_deepseek_model():
    """deepseek-v2-236b ``FULL`` at full width (d_model 5120, 128 heads,
    kv_lora 512, qk 128 + 64, 160 experts top-6 and 2 shared) with its
    depth cut to the dense first layer and two MoE layers, random seeded
    bf16 weights made on the card, on the kernels (``attn_impl="cuda"``;
    the config's own default is the blocked path). Its LoRA B leaves stay
    zero, so that the absorbed decode, which leaves ``kv_up``'s adapter
    out as the reference does, computes what the prefill computes."""
    from repro_torch.configs.deepseek_v2_236b import FULL
    from repro_torch.models.transformer import count_params, init_params
    t0 = time.perf_counter()
    cfg = dataclasses.replace(FULL, n_layers=DS_LAYERS, attn_impl="cuda")
    params = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    part = lambda t: sum(x.numel() for x in _leaves(t))
    lp0, lp1 = params["layers"][0], params["layers"][1]
    experts = {k: lp1["ffn"][k] for k in ("w_gate", "w_up", "w_down")}
    log(f"  deepseek-v2-236b FULL widths, {DS_LAYERS} layers, on card: "
        f"count_params {count_params(params)} "
        f"({count_params(params) / 1e9:.2f}B; MLA block "
        f"{part(lp0['attn']) / 1e6:.1f}M, dense SwiGLU "
        f"{part(lp0['ffn']) / 1e6:.1f}M, one MoE FFN "
        f"{part(lp1['ffn']) / 1e9:.3f}B of which routed experts "
        f"{part(experts) / 1e9:.3f}B and shared "
        f"{part(lp1['ffn']['shared']) / 1e6:.1f}M; embed and lm_head "
        f"{params['embed'].numel() / 1e6:.1f}M each), "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB, "
        f"{time.perf_counter() - t0:.1f}s")
    return cfg, params


def int8_one_layer_check(cfg, params, kernels, label):
    """The int8 latent cache's kernel-vs-dense check at one layer, as
    phase 10 makes it for GQA: ``ServeScheduler`` over phase 10's first 6
    requests on paged int8 latent KV in fp32 at FULL widths, kernel path
    against dense path. With one layer the codes the two paths write
    depend on the embeddings alone and are shown equal; the scores differ
    in summation order only, within SCHED32_TOL. Returns the max diff."""
    from repro_torch.serve.cache import kv_keys
    reqs = sched_stream(cfg, N_REQ_SHORT)
    c1 = dataclasses.replace(cfg, n_layers=1, param_dtype="float32",
                             compute_dtype="float32")
    p1 = _layers(params, 1, torch.float32)
    got, caches = {}, {}
    for impl in ("cuda", "dense"):
        res = run_sched(c1, p1, reqs, kernels, kv_dtype="int8", paged=True,
                        attn_impl=impl, label=f"{label} int8 {impl}, 1 layer")
        if res["finished"] != len(reqs):
            fail(f"{label} int8 {impl}: {res['finished']} requests finished")
        if impl == "cuda":
            check_sched_run(res, c1, decode_kernel(c1, "int8"),
                            f"{label} int8 cuda")
        got[impl], caches[impl] = res["scores"], res["sched"].cache
    for key in kv_keys(caches["cuda"]):
        if not torch.equal(caches["cuda"][key], caches["dense"][key]):
            fail(f"{label}: the 1-layer int8 latent caches differ in {key}")
    err = float(np.abs(got["cuda"] - got["dense"]).max())
    log(f"  {label}: int8 latent KV, 1 layer, fp32, kernel path vs dense "
        f"path: max|diff| {err:.3e} (tol {SCHED32_TOL:g}) over "
        f"{got['cuda'].size} scores; the caches' codes and scales equal")
    if not err <= SCHED32_TOL:
        fail(f"{label}: int8 latent KV at 1 layer, kernel path differs from "
             f"dense by {err}")
    del caches
    return err


def phase_deepseek(kernels):
    """Phase 18: deepseek-v2-236b at FULL widths over its dense first
    layer and two MoE layers, bf16, on the kernels. The counts are set to
    0 before its main path and read after it: at the no-drop capacity
    factor (n_experts / top_k), phases 3 and 4 on it (``CTRServer.score``
    in calls of 2 prompts, kernel 1 at Dqk 192 / Dv 128 once per layer a
    call; the chunked context, the 6-candidate burst held to
    per-candidate prefill, ring steps, kernel 4's MLA mode at 576 / 512
    once per layer a step) and the same decode path on int8 latent KV
    (``decode_attn_mla_576_q8``); no plain call, no dropped choice. Then
    ``ServeScheduler`` over 8 requests on paged bf16 latent KV, its
    launches added, held to the naive oracle (calls of 4 prompts of 1,024
    tokens). Off the main path: the prefill held to the blocked path (the
    config's default), both decode runs to the dense plain decode, int8
    to bf16 KV, a paged step to a contiguous one bit for bit (bf16 and
    int8); then at the config's capacity factor 1.25 the timed prefill
    call (B=8, S=2048) and decode burst step, their drops and profiles,
    peak memory; then 18b, the dense first layer alone in fp32. Returns
    the launches, times, errors and checks; frees its weights."""
    from repro_torch.serve.engine import CTRServer, make_decode_fn
    log("phase 18: deepseek-v2-236b (MLA + MoE) FULL widths, "
        f"{DS_LAYERS} layers, bf16, attn_impl cuda")
    cfg, params = build_deepseek_model()
    users, prompts = serving_material(cfg)
    nd = no_drop(cfg)
    log(f"  serving logic checks at capacity factor {nd.capacity_factor:g} "
        f"(n_experts / top_k: no choice can drop), prefill calls of "
        f"{DS_PER_CALL} prompts")
    torch.cuda.reset_peak_memory_stats()
    routing, plain = _MoeRouting(), serve_plain_calls()
    kernels.reset_launches()
    try:
        server, p_prefill = phase_prefill(nd, params, prompts, kernels,
                                          per_call=DS_PER_CALL)
        run = phase_decode(nd, params, users, server, p_prefill, kernels)
        run8 = drive_decode(nd, params, users, kernels, kv_dtype="int8")
    finally:
        plain.close()
        routing.close()
    launches = dict(kernels.LAUNCHES)
    want = {k: 0 for k in kernels.KERNELS}
    want.update(windowed_attn_192=cfg.n_layers * server.calls,
                decode_attn_mla_576=cfg.n_layers * run["n_steps"],
                decode_attn_mla_576_q8=cfg.n_layers * run8["n_steps"])
    dropped, choices = routing.dropped()
    log(f"  deepseek serving path launches {launches}: kernel 1 in "
        f"{server.calls} prefill calls, kernel 4's MLA mode in "
        f"{run['n_steps']} bf16 and {run8['n_steps']} int8 decode steps; "
        f"plain attention calls {plain.n}; dropped choices {dropped} of "
        f"{choices}")
    if launches != want:
        fail(f"deepseek serving path launches {launches}, want {want}")
    if plain.n:
        fail(f"the plain attention ran {plain.n} times on the deepseek path")
    if dropped:
        fail(f"{dropped} choices dropped at capacity factor "
             f"{nd.capacity_factor}")
    del routing

    errs = {}
    dense = dataclasses.replace(nd, attn_impl="dense")
    for name, a, b in (
            ("bf16 decode vs dense plain decode", run["valid_p"],
             drive_decode(dense, params, users, kernels)["valid_p"]),
            ("int8 decode vs dense plain decode", run8["valid_p"],
             drive_decode(dense, params, users, kernels,
                          kv_dtype="int8")["valid_p"]),
            ("int8 vs bf16 KV, burst and ring",
             np.concatenate([run8["burst"].ravel(), run8["ring"]]),
             np.concatenate([run["burst"].ravel(), run["ring"]]))):
        errs[name] = float(np.abs(a - b).max())
    blocked = ChunkedServer(CTRServer(params, dataclasses.replace(
        nd, attn_impl="blocked"), max_len=MAX_LEN), DS_PER_CALL)
    errs["prefill vs blocked"] = float(np.abs(
        np.asarray(blocked.score(prompts)) - p_prefill).max())
    del blocked, run8
    log(f"  bf16 max|diff|: {errs} (tol {P_TOL}: both sides round to bf16 "
        f"at other places)")
    for name, err in errs.items():
        if not err <= P_TOL:
            fail(f"phase 18 {name}: {err} > {P_TOL}")
    for kv in (None, "int8"):
        n = step_paged_vs_contiguous(nd, params, kv)
        log(f"  one step on a paged cache (pages out of order) == the same "
            f"step on a contiguous cache, {kv or 'bf16'} latent KV: {n} "
            f"values equal bit for bit")

    reqs = sched_stream(cfg, DS_REQ)
    label = "18 scheduler, paged bf16 latent KV, no-drop"
    res = run_sched(nd, params, reqs, kernels, kv_dtype=None, paged=True,
                    label=label)
    res.pop("sched")
    check_sched_run(res, nd, "decode_attn_mla_576", label)
    for name, n in res["launches"].items():
        launches[name] += n
    oracle, max_len = sched_oracle(nd, params, reqs[:N_ORACLE], per_call=4)
    errs["scheduler vs oracle"] = err = float(np.abs(
        res["scores"][:N_ORACLE] - oracle).max())
    log(f"  scheduler vs naive oracle: max|diff| {err:.3e} (tol "
        f"{SCHED_TOL}; {oracle.size} sliding-window prompts of max_len "
        f"{max_len}, 4 a call)")
    if not err <= SCHED_TOL:
        fail(f"phase 18 scheduler differs from the oracle by {err}")
    tel = res["tel"]
    times = dict(sched=(res["wall"] * 1e3 / tel["steps"],
                        res["candidates"] / res["wall"]))
    del res
    torch.cuda.empty_cache()

    server = CTRServer(params, cfg, max_len=MAX_LEN)
    decode = make_decode_fn(cfg, window=cfg.window, ring=False)
    burst = lambda: decode(params, run["cache"], *run["burst_args"])
    times.update(prefill_ms=cuda_ms(lambda: server.score(prompts), iters=3,
                                    warmup=1),
                 decode_ms=cuda_ms(burst, iters=5, warmup=1))
    times["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    card = card_line()
    log(f"  deepseek-v2-236b ({DS_LAYERS} layers) at capacity factor "
        f"{cfg.capacity_factor}: prefill call B=8 S=2048 "
        f"{times['prefill_ms']:.2f} ms; decode burst step B=8 s=64 "
        f"cap=2048 {times['decode_ms']:.2f} ms; scheduler (no-drop) "
        f"{times['sched'][0]:.2f} ms per step, {times['sched'][1]:.1f} "
        f"candidates/s; peak memory {times['peak_gib']:.2f} GiB ({card})")
    routing = _MoeRouting()
    try:
        server.score(prompts)
        n_pre = routing.dropped()
        burst()
    finally:
        routing.close()
    d_all = routing.dropped()
    times["drops"] = dict(prefill=n_pre, burst=(d_all[0] - n_pre[0],
                                                d_all[1] - n_pre[1]))
    log(f"  dropped (token, expert) choices at capacity factor "
        f"{cfg.capacity_factor}: prefill call {n_pre[0]} of {n_pre[1]}, "
        f"burst step {times['drops']['burst'][0]} of "
        f"{times['drops']['burst'][1]}")
    times["decode_busy_ms"] = profile_call(
        burst, f"deepseek-v2-236b decode burst step B=8 s=64 cap=2048 "
        f"{DS_LAYERS} layers")
    times["prefill_busy_ms"] = profile_call(
        lambda: server.score(prompts),
        f"deepseek-v2-236b prefill call B=8 S=2048 {DS_LAYERS} layers")
    del run, server, burst, decode
    torch.cuda.empty_cache()
    checks = phase_deepseek32(cfg, params, users, prompts, kernels)
    train = phase_deepseek_train(cfg, params, kernels)
    del params
    torch.cuda.empty_cache()
    return dict(launches=launches, times=times, errs=errs, checks=checks,
                train=train)


def phase_deepseek32(cfg, params, users, prompts, kernels):
    """18b: the dense first layer alone (its MLA block at full width and
    its SwiGLU, with the embedding and head: ~5.5 GB) in fp32, the kernel
    path against the dense path: prefill (kernel 1 at Dqk 192) and every
    decode step of phase 4's path (kernel 4 at 576 / 512) within
    SCHED32_TOL; then the int8 latent cache's one-layer check."""
    log("phase 18b: deepseek-v2-236b's dense first layer, FULL widths, "
        "fp32: kernel path vs dense path")
    c32 = dataclasses.replace(cfg, n_layers=1, param_dtype="float32",
                              compute_dtype="float32")
    p32 = _layers(params, 1, torch.float32)
    out = {"prefill": float(np.abs(_score(c32, p32, prompts, "cuda")
                                   - _score(c32, p32, prompts, "dense",
                                            batch=2)).max())}
    dec = drive_decode(c32, p32, users, kernels)["valid_p"]
    dec_dense = drive_decode(dataclasses.replace(c32, attn_impl="dense"),
                             p32, users, kernels)["valid_p"]
    out["decode"] = float(np.abs(dec - dec_dense).max())
    del p32
    torch.cuda.empty_cache()
    for name, err in out.items():
        log(f"  fp32 {name}: max|p_cuda - p_dense| {err:.3e} (tol "
            f"{SCHED32_TOL:g})")
        if not err <= SCHED32_TOL:
            fail(f"phase 18b {name}: kernel path differs from dense by {err}")
    out["int8 1 layer"] = int8_one_layer_check(cfg, params, kernels, "18b")
    return out


# ---------------------------------------------------------------------------
# phases 19, 19b, 20 and 20b: MoE LoRA training at full width
# ---------------------------------------------------------------------------

DS_TRAIN_ROWS32 = 2    # 19b's rows: the dense path's fp32 score planes at 128 heads


def moe_drops(cfg, params, mat):
    """(dropped, all) (token, expert) choices of one forward of batch 1 at
    ``cfg``'s capacity factor, under no_grad (``_MoeRouting`` would sync
    the host in every MoE call of a timed step)."""
    from repro_torch.launch.train import make_lm_loss_fn
    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in mat["batches"][0].items()}
    routing = _MoeRouting()
    try:
        with torch.no_grad():
            make_lm_loss_fn(cfg, mat["window"])(params, batch)
    finally:
        routing.close()
    return routing.dropped()


def repeat_step_bits(train, mat):
    """Two steps from the state ``phase_train`` ended in, on batch 1: the
    same loss and grad norm, and every LoRA leaf (its bf16 param and its
    fp32 master) bit for bit equal. Returns the LoRA leaves compared."""
    from repro_torch.models.transformer import named_leaves
    state, b = train["state"], mat["batches"][0]
    (s1, m1), (s2, m2) = (train["step_fn"](state, b),
                          train["step_fn"](state, b))
    pairs = [(p, a, c) for (p, a), (_, c) in
             zip(list(named_leaves(s1.params))
                 + list(named_leaves(s1.opt.master)),
                 list(named_leaves(s2.params))
                 + list(named_leaves(s2.opt.master)))
             if "lora" in str(p)]
    differ = [p for p, a, c in pairs if not torch.equal(a, c)]
    if not (torch.equal(m1["loss"], m2["loss"])
            and torch.equal(m1["grad_norm"], m2["grad_norm"])) or differ:
        fail(f"two steps from one state differ: loss {float(m1['loss'])} / "
             f"{float(m2['loss'])}, LoRA leaves {differ[:3]}")
    return len(pairs)


def moe_train_tail(cfg, params, mat, train, phase):
    """What phases 19 and 20 measure after ``phase_train``: the share of
    dropped choices, the step's time and peak memory (``time_train``), a
    profiled step, and two steps from one state bit for bit."""
    drops = moe_drops(cfg, params, mat)
    times = time_train(cfg, params, mat, train)
    times["drops"] = drops
    state = {"s": train["state"]}

    def one_step():   # two more LoRA steps; every check ran before
        state["s"] = train["step_fn"](state["s"], mat["batches"][0])[0]
    times["busy_ms"] = profile_call(
        one_step, f"{cfg.name} train step B={TRAIN_ROWS} S={TRAIN_LEN} "
        f"{cfg.n_layers} layers")
    del state
    n = repeat_step_bits(train, mat)
    log(f"  phase {phase}: dropped (token, expert) choices at capacity "
        f"factor {cfg.capacity_factor} in one forward of batch 1: "
        f"{drops[0]} of {drops[1]} ({drops[0] / max(drops[1], 1):.3f}); "
        f"two steps from one state: equal loss, grad norm and {n} LoRA "
        f"leaves (params and fp32 masters) bit for bit ({card_line()})")
    return times


def phase_deepseek_train(cfg, params, kernels):
    """Phases 19 and 19b on phase 18's model (deepseek-v2-236b at FULL
    widths over its dense first layer and two MoE layers, bf16, LoRA rank
    8, ``lora_b`` made nonzero): phase 7's path (remat, reset and ALiBi,
    ``trainable="lora"``) at the config's capacity factor 1.25, on kernel
    1's and kernels 2 and 3's Dqk-192 classes (each once per layer a step,
    kernel 1 once more in the remat recompute; no plain call); then
    ``moe_train_tail``; then 19b, the dense first layer alone in fp32 on
    DS_TRAIN_ROWS32 rows, kernel path against dense path."""
    log(f"phase 19: deepseek-v2-236b LoRA training, FULL widths, "
        f"{cfg.n_layers} layers, bf16, attn_impl cuda, capacity factor "
        f"{cfg.capacity_factor}")
    nonzero_lora(params, seed=4)
    mat = training_material(cfg)
    train = phase_train(cfg, params, mat, kernels, phase="19")
    times = moe_train_tail(cfg, params, mat, train, "19")
    launches = train["launches"]
    del train
    torch.cuda.empty_cache()
    check = phase_fp32_train_check(cfg, params, mat, phase="19b", n_layers=1,
                                   rows=DS_TRAIN_ROWS32)
    return dict(launches=launches, times=times, check=check)


def phase_moe_train(kernels):
    """Phases 20 and 20b: qwen2-moe-a2.7b ``FULL`` (24 layers, 16/16 heads
    of 128, 60 experts top-4 + 4 shared; random seeded bf16 weights with
    LoRA rank 8, nonzero ``lora_b``) through phase 7's path at the config's
    capacity factor 1.25, kernels 1-3 at head dim 128; then
    ``moe_train_tail`` (two steps from one state bit for bit: the MoE
    backward's sums run in a fixed order); then 20b. Returns the launches,
    times and 20b's diffs; frees its weights."""
    from repro_torch.configs.qwen2_moe_a2_7b import FULL
    from repro_torch.models.transformer import count_params, init_params
    log("phase 20: qwen2-moe-a2.7b LoRA training, FULL, bf16, attn_impl cuda")
    cfg = dataclasses.replace(FULL, attn_impl="cuda", lora_rank=8)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    nonzero_lora(params, seed=4)
    torch.cuda.synchronize()
    log(f"  {cfg.name} FULL with LoRA rank {cfg.lora_rank}: "
        f"{count_params(params) / 1e9:.3f}B parameters, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on card, "
        f"{time.perf_counter() - t0:.1f}s")
    mat = training_material(cfg)
    train = phase_train(cfg, params, mat, kernels, phase="20")
    times = moe_train_tail(cfg, params, mat, train, "20")
    launches = train["launches"]
    del train
    torch.cuda.empty_cache()
    check = phase_moe_train32(cfg, params, mat)
    del params
    torch.cuda.empty_cache()
    return dict(launches=launches, times=times, check=check)


def phase_moe_train32(cfg, params, mat):
    """20b: qwen2-moe-a2.7b at FULL widths, 2 layers, fp32, ``no_drop``
    capacity, on half of a batch: the kernel path against the dense path,
    the loss within LOSS32_TOL and each LoRA gradient within GRAD32_TOL
    (``hold_lora_grads``), on the first batch where no token's top-k set
    differs between the paths (as 14b; each batch's count printed)."""
    log("phase 20b: qwen2-moe-a2.7b FULL widths, 2 layers, fp32, no-drop "
        "capacity: kernel path vs dense path, loss and every LoRA gradient")
    c32 = no_drop(dataclasses.replace(cfg, n_layers=2, param_dtype="float32",
                                      compute_dtype="float32"))
    p32 = _layers(params, 2, torch.float32)
    for i, b in enumerate(mat["batches"]):
        batch = {k: torch.from_numpy(v[:TRAIN_ROWS // 2]).to("cuda")
                 for k, v in b.items()}
        got, calls = {}, {}
        for impl in ("cuda", "dense"):
            routing = _MoeRouting()
            try:
                got[impl] = _lora_grads(dataclasses.replace(
                    c32, attn_impl=impl), p32, batch, mat["window"])
            finally:
                routing.close()
            calls[impl] = routing.calls
        pairs = list(zip(calls["cuda"], calls["dense"]))
        if len(calls["cuda"]) != len(calls["dense"]) or any(
                a[2].shape != c[2].shape for a, c in pairs):
            fail("phase 20b: the two paths made different MoE calls")
        flips = sum(int((a[2] != c[2]).any(-1).sum()) for a, c in pairs)
        tokens = sum(a[2].shape[0] * a[2].shape[1] for a, _ in pairs)
        log(f"  batch {i + 1}: tokens whose top-k set differs between the "
            f"paths {flips} of {tokens} routed (forward and remat "
            f"recompute){'' if flips == 0 else '; not held: a route differs'}")
        if flips == 0:
            out = hold_lora_grads(got)
            del p32, got
            torch.cuda.empty_cache()
            return dict(out, batch=i + 1, flips=flips)
    fail("phase 20b: a token's top-k set differs between the paths in every "
         "batch")


# ---------------------------------------------------------------------------
# phase 2h: the wide geometries of kernels 1 and 4 (deepseek-v2-236b)
# ---------------------------------------------------------------------------

DS_HEADS = dict(H=128, Hk=128, D=192, Dv=128)   # deepseek-v2's prefill heads
DS_LATENT = dict(H=128, r=512, dr=64)           # its absorbed decode


def _rows(t, i, n, f32):
    """Batch rows [i, i + n) of a tensor operand of two or more dims (all
    batch-major here; one-dim ones, the ALiBi slopes, are shared), in
    fp32 where it is floating point and ``f32``."""
    if not torch.is_tensor(t):
        return t
    if t.dim() >= 2:
        t = t[i:i + n]
    return t.float() if f32 and t.is_floating_point() else t


def row_slices(args, kw, n=1, f32=True):
    """``(args, kw)`` of each slice of ``n`` batch rows (in fp32 with
    ``f32``): the plain versions' (B, H, S, S) score planes of a whole
    batch at 128 heads would take tens of GB."""
    B = args[0].shape[0]
    return [([_rows(t, i, n, f32) for t in args],
             {k: _rows(v, i, n, f32) for k, v in kw.items()})
            for i in range(0, B, n)]


def plain_by_rows(fn, args, kw, n=1):
    """``fn`` over ``row_slices``, its outputs concatenated along the
    batch."""
    outs = [fn(*a, **k) for a, k in row_slices(args, kw, n)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(x) for x in zip(*outs))
    return torch.cat(outs)


def real_windowed_192(gen):
    """Kernel 1 at deepseek-v2's prefill shape: B=8, S=2048, 128 heads
    (n_rep 1), Dqk 192 (nope 128 + rope 64), Dv 128, window 1024, NoPE +
    SUM isolation on, a [SUM] every ~200 tokens."""
    o = windowed_operands(gen, B=8, S=2048, **DS_HEADS, dtype=torch.bfloat16,
                          sum_every=197)
    kw = windowed_kwargs(o, window=1024, nope=True, reset=False,
                         packed=False, sum_iso=True)
    return o, kw


def check_kernels_wide():
    """Kernels 1 and 4 at the wide geometries deepseek-v2 brings, each
    under its own launch key. Kernel 1's Dqk-192 class
    (``windowed_attn_192``) over phase 2a's flags at Dqk 192 and 136, in
    fp32 within SMALL_TOL and on bf16 inputs per row, then at deepseek-v2's
    prefill shape (``real_windowed_192``) in bf16 against the fp32 plain
    version (a batch row at a time), twice (the same bits). Kernel 4's MLA
    mode at a latent of up to 512 and a rope span of up to 64
    (``decode_attn_mla_576``, ``decode_attn_mla_576_q8``) over phase 2g's
    flags at r 512 / dr 64, r 300 / dr 40 (a second value chunk of 44
    columns), r 264 / dr 48 and, on int8 codes, r 392 / dr 56 (codes
    converted from memory), in fp32 within SMALL_TOL and on bf16 inputs
    per row, then at deepseek-v2's decode shape (B=8, cap=2048, s=64, 128
    heads on one latent key, r 512, dr 64) in bf16 and on int8 codes
    (keys up to position 2047) per row, each twice. Returns the errors
    at the real shapes."""
    from repro_torch import kernels
    from repro_torch.kernels.decode_attn import (decode_attention_mla,
                                                 decode_attention_mla_plain)
    from repro_torch.kernels.windowed_attn import (windowed_attention,
                                                   windowed_attention_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(18)
    before = dict(kernels.LAUNCHES)
    log("phase 2h: windowed_attn_192 (kernel 1's Dqk-192 class) vs plain, "
        "fp32 and bf16 inputs, small shapes")
    cases = [  # window, nope, reset, packed, sum_iso, Hk, D, Dv, S, empty
        (48, True, False, False, True, 8, 192, 128, 256, True),
        (100, False, True, True, True, 2, 192, 128, 200, False),
        (300, True, True, True, False, 1, 192, 64, 190, True),
        (64, True, False, True, True, 2, 136, 96, 190, False),
    ]
    n_win = 0
    for dtype in (torch.float32, torch.bfloat16):
        for window, nope, reset, packed, sum_iso, hk, d, dv, S, empty in cases:
            o = windowed_operands(gen, B=2, S=S, H=8, Hk=hk, D=d, Dv=dv,
                                  dtype=dtype, packed=packed, empty_row=empty)
            kw = windowed_kwargs(o, window=window, nope=nope, reset=reset,
                                 packed=packed, sum_iso=sum_iso)
            got, lse = windowed_attention(o["q"], o["k"], o["v"],
                                          return_lse=True, **kw)
            torch.cuda.synchronize()
            args, kw32 = _f32(o["q"], o["k"], o["v"], **kw)
            want, lse_w = windowed_attention_plain(*args, **kw32)
            tag = (f"{'fp32' if dtype == torch.float32 else 'bf16'} "
                   f"w={window} nope={nope} reset={reset} seg={packed} "
                   f"iso={sum_iso} n_rep={8 // hk} D={d} Dv={dv} S={S} "
                   f"empty={empty}")
            if dtype == torch.float32:
                check_close(f"o   [{tag}]", got, want, SMALL_TOL)
                check_close(f"lse [{tag}]", lse, lse_w, SMALL_TOL)
            else:
                check_rows(f"o   [{tag}]", got, want)
                check_close(f"lse [{tag}]", lse, lse_w, LSE_TOL)
            if empty and not (got[-1] == 0).all():
                fail("empty row did not give 0 (Dqk-192 class)")
            n_win += 1

    log("phase 2h: deepseek-v2's prefill shape, bf16 kernel vs the fp32 "
        "plain version (a batch row at a time)")
    errs = {}
    o, kw = real_windowed_192(gen)
    run = lambda: windowed_attention(o["q"], o["k"], o["v"],
                                     return_lse=True, **kw)
    got, lse = run()
    torch.cuda.synchronize()
    want, lse_w = plain_by_rows(windowed_attention_plain,
                                (o["q"], o["k"], o["v"]), kw)
    errs["windowed_attn_192"] = check_rows(
        "windowed_attn_192 o   B8 S2048 H128 Dqk192 Dv128 w1024", got, want)
    check_close("windowed_attn_192 lse", lse, lse_w, LSE_TOL)
    del got, lse, want, lse_w
    check_same_bits("windowed_attn_192 at deepseek-v2's prefill shape",
                    lambda: run()[0])
    n_win += 3
    del o, kw, run

    log("phase 2h: decode_attn_mla_576 (kernel 4's MLA mode, latent 512, "
        "rope span 64) vs plain, fp32, small shapes")
    cases = [  # window, nope, seg, r, dr, s, cap, skip, n_seg, int8 base
        (0, False, False, 512, 64, 5, 200, False, 0, None),
        (40, True, True, 512, 64, 12, 200, True, 3, None),
        (0, True, True, 300, 40, 70, 300, False, 5, None),   # 9 row blocks
        (30, True, False, 264, 48, 5, 190, False, 0, None),
        (0, True, True, 512, 64, 12, 200, False, 3, 1800),
        (20, False, False, 512, 64, 5, 100, True, 0, 0),
        (30, True, True, 392, 56, 12, 190, False, 4, 1500),  # codes from memory
    ]
    n_bf, n_q8 = 0, 0
    for (window, nope, seg, r, dr, s, cap, skip, n_seg, base) in cases:
        o = latent_operands(gen, B=3, s=s, H=8, r=r, dr=dr, cap=cap,
                            dtype=torch.float32, fills=(120, 150, 0),
                            skip_block=skip, n_seg=n_seg)
        q8 = None
        if base is not None:
            o["pos_k"] = torch.where(o["pos_k"] >= 0, o["pos_k"] + base, -1)
            o["pos_q"] = o["pos_q"] + base
            q8 = quantize_latent(o, gen)
        kw = mla_kwargs(o, window=window, nope=nope, seg=seg, q8=q8)
        got = decode_attention_mla(*mla_args(o, q8), **kw)
        torch.cuda.synchronize()
        want = decode_attention_mla_plain(*mla_args(o, q8), **kw)
        tag = (f"w={window} nope={nope} seg={seg} r={r} dr={dr} s={s} "
               f"cap={cap} skip={skip}"
               + ("" if q8 is None else f" int8 pos<{int(o['pos_k'].max()) + 1}"))
        check_close(f"o [{tag}]", got, want, SMALL_TOL)
        if not (got[2] == 0).all():
            fail("empty cache row did not give 0 (MLA mode, latent 512)")
        n_q8 += q8 is not None
        n_bf += q8 is None
    log("phase 2h: bf16 inputs (and int8 codes), small shapes, per row")
    for r, dr, quant in ((512, 64, False), (300, 40, False), (512, 64, True),
                         (392, 56, True)):
        o = latent_operands(gen, B=3, s=12, H=8, r=r, dr=dr, cap=200,
                            dtype=torch.bfloat16, fills=(120, 150, 0),
                            n_seg=3)
        q8 = quantize_latent(o, gen) if quant else None
        kw = mla_kwargs(o, window=40, nope=True, seg=True, q8=q8)
        got = decode_attention_mla(*mla_args(o, q8), **kw)
        torch.cuda.synchronize()
        args, kw32 = _f32(*mla_args(o, q8), **kw)
        check_rows(f"o [bf16 r={r} dr={dr}{' int8' if quant else ''}]", got,
                   decode_attention_mla_plain(*args, **kw32))
        n_q8 += quant
        n_bf += not quant

    log("phase 2h: deepseek-v2's decode shape, bf16 kernel vs the fp32 "
        "plain version")
    for name, (o, q8, kw) in (
            ("decode_attn_mla_576", (*real_mla(gen, **DS_LATENT)[:1], None,
                                     None)),
            ("decode_attn_mla_576_q8", real_mla_q8(gen, **DS_LATENT))):
        if q8 is None:
            kw = mla_kwargs(o, window=1024, nope=True, seg=True)
        args = mla_args(o, q8)
        got = decode_attention_mla(*args, **kw)
        torch.cuda.synchronize()
        a32, kw32 = _f32(*args, **kw)
        errs[name] = check_rows(
            f"{name} o B8 cap2048 s64 H128 r512 dr64 w1024"
            + ("" if q8 is None else ", int8 latent and rope codes, keys at "
               f"positions up to {int(o['pos_k'].max())}"),
            got, decode_attention_mla_plain(*a32, **kw32))
        del a32, kw32, got
        check_same_bits(f"{name} at deepseek-v2's decode shape",
                        lambda: decode_attention_mla(*args, **kw))
        if q8 is None:
            n_bf += 3
        else:
            n_q8 += 3
    launched = {k: n - before[k] for k, n in kernels.LAUNCHES.items()
                if n != before[k]}
    want = {"windowed_attn_192": n_win, "decode_attn_mla_576": n_bf,
            "decode_attn_mla_576_q8": n_q8}
    if launched != want:
        fail(f"phase 2h launched {launched}, want {want}")
    return errs


# ---------------------------------------------------------------------------
# phase 2f: the embedding bag (kernel 5) against its plain version
# ---------------------------------------------------------------------------

# fp32 and int8: summation order only (the int8 scale folds exactly into
# the slot weights). bf16 tables: the op rounds its fp32 sum to bf16, half
# a step of the 8-bit significand, plus the fp32 sum's own order.
BAG_TOL = 1e-5
BAG_BF16_ROUND, BAG_BF16_FLOOR = 2.0 ** -8, 1e-6
FP32_FLOPS = 67e12             # fp32 outside the tensor cores, same source
DIN_BAGS, MIND_BAGS, BAG_SLOTS = 65_536, 512, 100


def bag_operands(gen, table, B, H, *, lengths=False):
    """ids (B, H) int32 with random valid slots (or, with ``lengths``, a
    valid prefix of 1..H slots per bag, as a history is); masked slots
    hold ids below 0 or past the table's end; bag 0 all invalid unless
    ``lengths``."""
    V = table.shape[0]
    ids = torch.randint(0, V, (B, H), generator=gen, device="cuda",
                        dtype=torch.int32)
    if lengths:
        n = torch.randint(1, H + 1, (B, 1), generator=gen, device="cuda")
        valid = torch.arange(H, device="cuda")[None] < n
    else:
        valid = torch.rand(B, H, generator=gen, device="cuda") < 0.8
        valid[0] = False
    junk = torch.randint(-2 * V, 3 * V, (B, H), generator=gen,
                         device="cuda", dtype=torch.int32)
    return torch.where(valid, ids, junk), valid


def check_bf16_bag(name, got, want):
    err = (got.float() - want).abs()
    tol = BAG_BF16_ROUND * want.abs() + BAG_BF16_FLOOR
    worst = (err / tol).max().item()
    log(f"  {name}: max|err| {err.max().item():.3e}, worst err/tol "
        f"{worst:.3f} (tol {BAG_BF16_ROUND:g}|x| + {BAG_BF16_FLOOR:g})")
    if not worst <= 1.0:
        fail(f"{name}: worst err/tol {worst}")


def check_kernels_bag(kernels):
    """Kernel 5 in both modes: small shapes in fp32, bf16 and int8 over
    ``tests/test_kernels.py``'s grid, the recsys row widths and widths 1,
    17 and 33, each on the table and on its view ``[1:]`` (every vector
    width and lane grouping ``bag_plan`` can choose), then the op path at
    the real shapes, with the counts reset before it and read after it,
    then two calls in each mode at DIN's shape, which must give the same
    bits. Returns the op path's launches, the real shapes' errors and
    phase 6's times."""
    from repro_torch.core.quant import dequantize_q8, quantize_q8
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels.embedding_bag import (bag_weights, embedding_bag,
                                                   embedding_bag_plain)
    from repro_torch.sparse.embedding import init_table
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    log("phase 2f: embedding_bag vs plain, small shapes (fp32, bf16, int8)")
    grid = [(64, 8, 4, 3), (512, 32, 16, 8), (1000, 128, 8, 20),
            (37, 16, 5, 7), (300, 10, 9, 20), (300, 18, 9, 20),
            (300, 50, 6, 12), (300, 64, 6, 12), (300, 200, 3, 33),
            (300, 1, 7, 40), (300, 17, 5, 37), (300, 33, 4, 21)]
    for V, D, B, H in grid:
        # V + 1 rows: the table is its first V, the offset view its last V
        full = torch.randn(V + 1, D, generator=gen, device="cuda")
        ids, valid = bag_operands(gen, full[:V], B, H)
        weights = torch.randn(B, H, generator=gen, device="cuda")
        fcodes, fscale = quantize_q8(full)
        fhalf = full.bfloat16()
        for view, sl in (("", slice(0, V)), (" [1:]", slice(1, V + 1))):
            table, half = full[sl], fhalf[sl]
            codes, scale = fcodes[sl], fscale[sl]
            deq = dequantize_q8(codes, scale)
            for mode, wts in (("sum", None), ("mean", None),
                              ("sum", weights)):
                tag = (f"V{V} D{D} B{B} H{H} {mode}"
                       + (" weighted" if wts is not None else "") + view)
                w = bag_weights(ids, valid, mode=mode, weights=wts)
                got = embedding_bag(table, ids, valid, mode=mode,
                                    weights=wts)
                torch.cuda.synchronize()
                check_close(f"fp32 [{tag}]", got,
                            embedding_bag_plain(table, ids, w), BAG_TOL)
                if not (got[0] == 0).all():
                    fail("an all-invalid bag did not give 0")
                got = embedding_bag(half, ids, valid, mode=mode, weights=wts)
                check_bf16_bag(f"bf16 [{tag}]", got,
                               embedding_bag_plain(half, ids, w))
                got = embedding_bag(codes, ids, valid, mode=mode,
                                    weights=wts, table_scale=scale)
                torch.cuda.synchronize()
                check_close(f"int8 [{tag}]", got,
                            embedding_bag_plain(deq, ids, w), BAG_TOL)

    log(f"phase 2f: the op path at the real shapes: DIN's FULL item table "
        f"(2^26 x 18, fp32 and int8 codes) with {DIN_BAGS} bags of "
        f"{BAG_SLOTS} (valid lengths 1..{BAG_SLOTS}), MIND's (2^24 x 64) "
        f"with {MIND_BAGS}")
    din = init_table(gen, 1 << 26, 18, device="cuda")
    codes, scale = quantize_q8(din)
    din_ids, din_valid = bag_operands(gen, din, DIN_BAGS, BAG_SLOTS,
                                      lengths=True)
    mind = init_table(gen, 1 << 24, 64, device="cuda")
    mind_ids, mind_valid = bag_operands(gen, mind, MIND_BAGS, BAG_SLOTS,
                                        lengths=True)
    runs = [("embedding_bag", "DIN fp32", din, None, din_ids, din_valid),
            ("embedding_bag_q8", "DIN int8", codes, scale, din_ids,
             din_valid),
            ("embedding_bag", "MIND fp32", mind, None, mind_ids, mind_valid)]
    kernels.reset_launches()
    outs = [embedding_bag(t, i, v, mode=mode, table_scale=s)
            for _, _, t, s, i, v in runs for mode in ("sum", "mean")]
    torch.cuda.synchronize()
    launches = {k: n for k, n in kernels.LAUNCHES.items() if n}
    log(f"  op path launches {launches}")
    if launches != {"embedding_bag": 4, "embedding_bag_q8": 2}:
        fail(f"the bag op path launched {launches}")
    errs = {"embedding_bag": 0.0, "embedding_bag_q8": 0.0}
    for k, (name, tag, t, s, i, v) in enumerate(runs):
        ref = t if s is None else dequantize_q8(t, s)
        for j, mode in enumerate(("sum", "mean")):
            want = embedding_bag_plain(ref, i, bag_weights(i, v, mode=mode))
            errs[name] = max(errs[name], check_close(
                f"{tag} {mode} B{i.shape[0]} H{i.shape[1]}",
                outs[2 * k + j], want, BAG_TOL))
        del ref
    del outs
    din_bf16 = din.bfloat16()
    w = bag_weights(din_ids, din_valid)
    for tag, t, s in (("fp32", din, None), ("bf16", din_bf16, None),
                      ("int8", codes, scale)):
        a = eb._launch(t, din_ids, w, s)
        b = eb._launch(t, din_ids, w, s)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            fail(f"two calls at DIN's shape ({tag}) differ")
        log(f"  two calls at DIN's shape, {tag}: {a.numel()} values equal "
            f"bit for bit")
        del a, b
    times = time_bag(
        (din_ids, din_valid, {"fp32": (din, None), "bf16": (din_bf16, None),
                              "int8": (codes, scale)}),
        (mind_ids, mind_valid, {"fp32": (mind, None),
                                "int8": quantize_q8(mind)}))
    del mind, din_bf16
    return dict(launches=launches, errs=errs, times=times)


def bag_costs(table, scale, ids, w):
    """What a call at these inputs must move. ``bytes``: each distinct row
    of a slot (clamped ids) once, masked and zero-weight slots too (the
    kernel adds row * w for every slot, as the reference does; masked ids
    are clamped, so most of them land on the table's first or last row),
    its int8 scale, the ids and weights, the fp32 output. ``floor``: the
    same with each row and scale counted as the 32-byte sectors it spans
    (the sector floor). ``lines``: the 128-byte lines fetched at random
    places, those each distinct row spans plus, in int8, one scale line
    per distinct row (a scale line's next use mostly comes after L2 has
    let it go: DIN's scales are 268 MB)."""
    V, D = table.shape
    rb = D * table.element_size()
    rows = torch.unique(ids.long().clamp(0, V - 1))
    n = int(rows.numel())
    first, last = rows * rb, rows * rb + rb - 1
    sectors = int((last // 32 - first // 32 + 1).sum())
    lines = int((last // 128 - first // 128 + 1).sum())
    side = ids.numel() * 4 + w.numel() * 4 + ids.shape[0] * D * 4
    nbytes = n * rb + side
    if scale is not None:
        sectors += int(torch.unique(rows * 4 // 32).numel())
        lines += n
        nbytes += n * 4
    return dict(rows=n, slots=int(ids.numel()), bytes=nbytes,
                floor=sectors * 32 + side, lines=lines)


def log_bag(shape, name, ms, c, more=""):
    B, H = c["shape"]
    log(f"  kernel 5 at {shape}'s shape ({name}, B{B} H{H} D{c['D']}): "
        f"{ms:.4f} ms{more}; byte bound "
        f"{c['bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms "
        f"({c['bytes'] / 1e6:.1f} MB), 32-byte sector floor "
        f"{c['floor'] / HBM_BYTES_PER_S * 1e3:.4f} ms "
        f"({c['floor'] / 1e6:.1f} MB); {c['rows']} distinct rows, "
        f"{c['lines']} 128-byte line fetches, "
        f"{c['lines'] / ms / 1e6:.2f} G lines/s")


def cuda_ms_queued(fn, iters=20, warmup=3):
    """Device time per call of a short kernel: the launches are queued
    behind a sleep on the stream, so the host's launch time is hidden."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_bag(din, mind):
    """Kernel 5 at DIN's real shape (sum, the valid mask as weights) on
    the fp32 table, its bf16 copy and its int8 codes, beside its plain
    version and ``F.embedding_bag(..., mode="sum", per_sample_weights=w)``
    (the library yardstick, never called by the port; it asserts on the
    masked slots' out-of-range ids, so it is handed them clamped, outside
    the timed call; for int8 codes it is handed the codes widened to fp32
    and the scales folded into the weights, as a PyTorch user must); then
    at MIND's shape in fp32 and int8, queued. Each beside ``bag_costs``
    (bound: its bytes at 3.35 TB/s, or 2 D fp32 operations per slot at
    67 TFLOP/s). ``din`` and ``mind``: (ids, valid, {mode: (table,
    scale)}). Returns the fp32 and int8 rows at DIN's shape."""
    import torch.nn.functional as F
    from repro_torch.kernels import embedding_bag as eb
    ids, valid, tables = din
    w = eb.bag_weights(ids, valid)
    ids_c = ids.clamp(0, tables["fp32"][0].shape[0] - 1)
    res = {}
    for mode, (t, s) in tables.items():
        c = dict(bag_costs(t, s, ids, w), shape=ids.shape, D=t.shape[1])
        ms = cuda_ms(lambda: eb._launch(t, ids, w, s), iters=20)
        plain = cuda_ms(lambda: eb.embedding_bag_plain(t, ids, w, s),
                        iters=5, warmup=1)
        if s is None:
            lib = cuda_ms(lambda: F.embedding_bag(
                ids_c, t, mode="sum", per_sample_weights=w.to(t.dtype)),
                iters=20)
        else:
            lib = cuda_ms(lambda: F.embedding_bag(
                ids_c, t.float(), mode="sum",
                per_sample_weights=w * s[ids_c]), iters=5, warmup=1)
        log_bag("DIN", mode, ms, c, f", plain {plain:.4f} ms, library "
                f"{lib:.4f} ms")
        name = {"fp32": "embedding_bag", "int8": "embedding_bag_q8"}.get(mode)
        if name:
            res[name] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                             bytes=c["bytes"], flops=2 * c["D"] * c["slots"],
                             peak=FP32_FLOPS, keys=(c["rows"], c["slots"]),
                             floor=c["floor"])
    ids, valid, tables = mind
    w = eb.bag_weights(ids, valid)
    for mode, (t, s) in tables.items():
        c = dict(bag_costs(t, s, ids, w), shape=ids.shape, D=t.shape[1])
        plan = eb.bag_plan(*ids.shape, t.shape[1], t.element_size(),
                           t.data_ptr(), torch.cuda.get_device_properties(0)
                           .multi_processor_count)
        log_bag("MIND", mode, cuda_ms_queued(lambda: eb._launch(t, ids, w, s)),
                c, f" (queued; {plan})")
    return res


# ---------------------------------------------------------------------------
# phase 11: the recsys family (DIN, MIND, SASRec, xDeepFM)
# ---------------------------------------------------------------------------

RECSYS_ARCHS = ("din", "mind", "sasrec", "xdeepfm")
RECSYS_SERVE = 512             # serve_p99
RECSYS_CHECK_STEPS = 3
N_CANDIDATES = 1_000_000       # retrieval_cand: one user
# (a): the card against the CPU in fp32 on the same params and batches:
# summation order only. Logits and probabilities within
# REC_TOL * max|logit| + REC_FLOOR; AdamW losses within REC_LOSS_TOL.
REC_TOL, REC_FLOOR, REC_LOSS_TOL = 1e-4, 1e-5, 1e-4


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def recsys_batch(cfg, b, seed, device):
    """A batch of the repro's generator (labels included), on ``device``."""
    from repro_torch.data.recsys_gen import RecsysGenerator
    gen = RecsysGenerator(cfg.n_items, seed=seed)
    rng = np.random.default_rng(seed)
    out = (gen.field_batch(b, cfg.field_vocabs, rng=rng)
           if cfg.kind == "xdeepfm" else gen.seq_batch(b, cfg.seq_len,
                                                       rng=rng))
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def recsys_loss_fn(cfg):
    from repro_torch.models.recsys import bce_loss, recsys_logits
    return lambda p, b, _g: (bce_loss(recsys_logits(p, cfg, b),
                                      b["labels"]), {})


def phase_recsys_cut(arch):
    """(a) FULL widths, tables cut (2^20 item rows; xDeepFM each field to
    min(v, 2^16)): the card against the CPU on the same fp32 params."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import recsys_serve_step
    from repro_torch.models.recsys import init_recsys, recsys_logits
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import init_train_state, make_train_step
    cfg = get_arch(arch).config
    cfg = (dataclasses.replace(cfg, field_vocabs=tuple(
        min(v, 1 << 16) for v in cfg.field_vocabs))
           if cfg.kind == "xdeepfm" else dataclasses.replace(cfg,
                                                             n_items=1 << 20))
    cpu = init_recsys(cfg, seed=11, device="cpu")
    card = _tree_to(cpu, "cuda")
    b_cpu = recsys_batch(cfg, RECSYS_SERVE, 12, "cpu")
    b_card = {k: v.cuda() for k, v in b_cpu.items()}
    z_cpu = recsys_logits(cpu, cfg, b_cpu)
    tol = REC_TOL * z_cpu.abs().max().item() + REC_FLOOR
    check_close(f"{arch} logits B{RECSYS_SERVE}, card vs CPU",
                recsys_logits(card, cfg, b_card).cpu(), z_cpu, tol)
    check_close(f"{arch} recsys_serve_step B{RECSYS_SERVE}, card vs CPU",
                recsys_serve_step(card, cfg, b_card).cpu(),
                recsys_serve_step(cpu, cfg, b_cpu), tol)
    ocfg = OptimizerConfig(lr=1e-2, schedule="const", warmup_steps=1,
                           total_steps=RECSYS_CHECK_STEPS)
    step = make_train_step(recsys_loss_fn(cfg), ocfg)
    states = [init_train_state(cpu, ocfg), init_train_state(card, ocfg)]
    losses = [[], []]
    for i in range(RECSYS_CHECK_STEPS):
        b = recsys_batch(cfg, RECSYS_SERVE, 20 + i, "cpu")
        for k, dev in enumerate(("cpu", "cuda")):
            states[k], m = step(states[k], {n: v.to(dev)
                                            for n, v in b.items()})
            losses[k].append(float(m["loss"]))
    diff = max(abs(a - c) for a, c in zip(*losses))
    log(f"  {arch} {RECSYS_CHECK_STEPS} AdamW steps B{RECSYS_SERVE}: losses "
        f"card {[round(x, 6) for x in losses[1]]}, max |card - CPU| "
        f"{diff:.3e} (tol {REC_LOSS_TOL:g})")
    if not diff <= REC_LOSS_TOL:
        fail(f"{arch}: AdamW losses differ by {diff}")
    return diff


def phase_recsys_full(arch):
    """(b) the FULL config with its full tables on the card: serve_p99,
    one train step at train_batch (xDeepFM 16,384), retrieval_cand with
    1,000,000 candidates in chunks of 8,000; finite, probabilities in
    (0, 1); times with CUDA events."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import (recsys_retrieval_step,
                                          recsys_serve_step)
    from repro_torch.models.recsys import init_recsys
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import init_train_state, make_train_step
    spec = get_arch(arch)
    cfg = spec.config
    torch.cuda.reset_peak_memory_stats()
    params = init_recsys(cfg, seed=13, device="cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    b = recsys_batch(cfg, RECSYS_SERVE, 14, "cuda")
    p = recsys_serve_step(params, cfg, b)
    if p.shape != (RECSYS_SERVE,) or not bool(((p > 0) & (p < 1)).all()):
        fail(f"{arch} serve_p99: probabilities not all in (0, 1)")
    serve_ms = cuda_ms(lambda: recsys_serve_step(params, cfg, b))

    rng = np.random.default_rng(15)
    cand = torch.from_numpy(rng.integers(
        0, cfg.field_vocabs[0] if cfg.kind == "xdeepfm" else cfg.n_items,
        N_CANDIDATES).astype(np.int32)).cuda()
    extra = ({"base_ids": recsys_batch(cfg, 1, 16, "cuda")["ids"]}
             if cfg.kind == "xdeepfm" else
             {"hist": recsys_batch(cfg, 1, 16, "cuda")["hist"]})
    rb = {"cand_ids": cand, **extra}
    scores = recsys_retrieval_step(params, cfg, rb)
    if scores.shape != (N_CANDIDATES,) or not bool(torch.isfinite(
            scores).all()):
        fail(f"{arch} retrieval_cand: scores not finite or of shape "
             f"{tuple(scores.shape)}")
    retr_ms = cuda_ms(lambda: recsys_retrieval_step(params, cfg, rb),
                      iters=2, warmup=1)
    del scores

    tb = TRAIN_BATCH_RECSYS[arch]
    ocfg = OptimizerConfig(lr=1e-3, schedule="cosine", total_steps=10_000)
    step = make_train_step(recsys_loss_fn(cfg), ocfg)
    state = init_train_state(params, ocfg)
    del params
    batches = [recsys_batch(cfg, tb, 17 + i, "cuda") for i in range(2)]
    walls = []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if not np.isfinite(float(m["loss"])):
            fail(f"{arch} train step: loss {float(m['loss'])}")
    finite = all(bool(torch.isfinite(t).all()) for t in _leaves(state.params))
    if not finite:
        fail(f"{arch} train step: non-finite params")
    peak = torch.cuda.max_memory_allocated() / 2**30
    out = dict(params=n_params, serve_ms=serve_ms, retrieval_ms=retr_ms,
               train_ms=walls[-1], train_first_ms=walls[0], train_batch=tb,
               loss=float(m["loss"]), peak_gib=peak)
    log(f"  {arch} FULL ({n_params / 1e6:.1f} M params): serve_p99 B"
        f"{RECSYS_SERVE} {serve_ms:.3f} ms; train step B{tb} "
        f"{walls[-1]:.2f} ms (first {walls[0]:.2f} ms), loss "
        f"{out['loss']:.4f}; retrieval_cand {N_CANDIDATES} candidates "
        f"{retr_ms:.2f} ms; peak memory {peak:.2f} GiB")
    return out


TRAIN_BATCH_RECSYS = {"din": 65_536, "mind": 65_536, "sasrec": 65_536,
                      "xdeepfm": 16_384}


def phase_recsys(kernels):
    """Phase 11; the recsys models gather with plain row lookups, as the
    reference's models do, so this path launches no kernel."""
    log("phase 11: the recsys family, fp32 (TF32 off for matmul and cuDNN)")
    log("phase 11a: FULL widths, tables cut to 2^20 rows (xDeepFM fields to "
        "min(v, 2^16)): card vs CPU, serve_p99 and 3 AdamW steps")
    kernels.reset_launches()
    cut = {arch: phase_recsys_cut(arch) for arch in RECSYS_ARCHS}
    log("phase 11b: FULL configs with full tables on one card")
    full = {}
    for arch in RECSYS_ARCHS:
        full[arch] = phase_recsys_full(arch)
        torch.cuda.empty_cache()
    launched = {k: n for k, n in kernels.LAUNCHES.items() if n}
    log(f"  recsys path launches {launched or 'none'}")
    if launched:
        fail(f"the recsys models launched {launched}")
    return dict(cut=cut, full=full)


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
    out = {"windowed_attn": time_windowed(*real["windowed_attn"]["ops"])}
    out["decode_attn"] = time_decode(*real["decode_attn"]["ops"])
    return out


def time_windowed(o, kw, rows=None):
    """Kernel 1 on ``o`` beside its plain version and SDPA, the bound as
    ``time_kernels`` counts it; with ``rows`` the plain version's time is
    the sum of its calls on ``row_slices`` of that many batch rows (at 128
    heads)."""
    import torch.nn.functional as F
    from repro_torch.core.windowed import dti_mask
    from repro_torch.kernels.windowed_attn import (windowed_attention,
                                                   windowed_attention_plain)
    B, S, H, D = o["q"].shape
    Hk, Dv, e = o["k"].shape[2], o["v"].shape[3], o["q"].element_size()
    ms = cuda_ms(lambda: windowed_attention(o["q"], o["k"], o["v"],
                                            return_lse=True, **kw))
    if rows is None:
        plain = cuda_ms(lambda: windowed_attention_plain(
            o["q"], o["k"], o["v"], **kw), iters=3, warmup=1)
    else:
        plain = sum(cuda_ms(lambda: windowed_attention_plain(*a, **k),
                            iters=3, warmup=1)
                    for a, k in row_slices((o["q"], o["k"], o["v"]), kw,
                                           rows, f32=False))
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
    backend = sdpa_backend(qt, kt, vt, mask)
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bytes=nbytes,
                flops=flops, keys=keys, backend=backend)


def time_wide():
    """Phase 6's rows for the wide geometries, on phase 2h's real shapes
    made again from a seed: kernel 1's Dqk-192 class at deepseek-v2's
    prefill shape, kernel 4's MLA mode at its decode shape in both
    modes."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    out = {"windowed_attn_192": time_windowed(*real_windowed_192(gen),
                                              rows=1)}
    o, kw = real_mla(gen, **DS_LATENT)
    out["decode_attn_mla_576"] = time_mla(dict(ops=(o, None, kw)), False)
    del o, kw
    out["decode_attn_mla_576_q8"] = time_mla(
        dict(ops=real_mla_q8(gen, **DS_LATENT)), True)
    for name, r in out.items():
        log(f"  {name}: SDPA picks {r.get('backend')} for these operands")
    return out


def sdpa_backend(q, k, v, mask):
    """The backend ``scaled_dot_product_attention`` picks for these
    operands, by PyTorch's own choice function."""
    from torch.nn.attention import SDPBackend
    try:
        return SDPBackend(torch._fused_sdp_choice(q, k, v, mask)).name
    except Exception as e:             # a private function: say so
        return f"unknown ({type(e).__name__}: {e})"


def time_decode(o, kw, calls=None):
    """Kernel 4's bf16 mode (GQA, or MLA with ``calls``: the kernel and
    its plain version on the latent operands, ``o`` holding the
    concatenated ones) beside its plain version and SDPA; the bound as
    ``time_kernels`` counts it."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attn import (_decode_mask,
                                                 decode_attention,
                                                 decode_attention_plain)
    B, s, H, D = o["q"].shape
    Hk, Dv, e = o["k"].shape[2], o["v"].shape[3], o["q"].element_size()
    args = (o["q"], o["k"], o["v"], o["pos_q"], o["pos_k"])
    run, run_plain = calls or (lambda: decode_attention(*args, **kw),
                               lambda: decode_attention_plain(*args, **kw))
    ms = cuda_ms(run)
    plain = cuda_ms(run_plain)
    mask = _decode_mask(o["pos_k"], o["pos_q"], kw["window"], o["seg_q"],
                        o["seg_k"])
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
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bytes=nbytes,
                flops=flops, keys=keys, backend=sdpa_backend(qt, kt, vt, mask))


def time_decode_s16():
    """Kernel 4, both modes, at the scheduler's smallest bucket (s=16: four
    4-token candidates over the decode shape's contexts), where the split
    plan cuts the cache into ranges, beside the library yardsticks."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    fills = [1400 + 70 * b for b in range(8)]
    o = decode_operands(gen, B=8, s=16, H=32, Hk=8, D=128, Dv=128, cap=2048,
                        dtype=torch.bfloat16, fills=fills, n_seg=4)
    kw = decode_kwargs(o, window=1024, nope=True, seg=True)
    res = {"decode_attn": time_decode(o, kw)}
    q8 = quantize_kv(o, rope_start=0, G=1, gen=gen)
    kw8 = q8_kwargs(o, q8, window=1024, nope=True, seg=True, rope_start=0,
                    theta=500000.0)
    res["decode_attn_q8"] = time_q8(dict(ops=(o, q8, kw8)))
    for name, r in res.items():
        log(f"  {name} at s=16 (B=8 cap=2048 H32 Hk8 D128 w1024): "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, bound "
            f"{r['bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes: "
            f"{r['bytes'] / 1e6:.1f} MB)")
    return res


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
    log(f"  {cfg.name} train step B={TRAIN_ROWS} S={TRAIN_LEN} "
        f"{cfg.n_layers} layers: median "
        f"{out['step_ms']:.2f} ms over {len(hist) - 1} steady steps (first "
        f"step {out['first_s']:.2f} s); {out['targets_per_s']:.2f} targets/s, "
        f"{out['tokens_per_s']:.1f} non-pad tokens/s; peak memory "
        f"{out['peak_gib']:.2f} GiB")
    log(f"  forward+backward with the LoRA leaves only differentiated: "
        f"{t_lora:.2f} ms; the step's frozen weight-gradient pass (and its "
        f"norms) costs {frozen_ms:.2f} ms ({frozen_ms / out['step_ms']:.1%} "
        f"of the step)")
    return out


def _bwd_launches(o, kw):
    """Kernels 2 and 3 each on its own, on ``o``'s operands (kernel 1's
    output and lse computed once), and the buffers they write."""
    from repro_torch.kernels import windowed_attn as wa
    q, k, v = o["q"], o["k"], o["v"]
    fwd_kw = dict(is_sum_q=None, is_sum_k=None, valid_k=None, seg_q=None,
                  seg_k=None, q_nope=None, k_nope=None, alibi=None, v0=None,
                  reset=None, sum_isolated=True, scale=None)
    fwd_kw.update(kw)
    st, live, alibi_f, ints = wa._prepare(q, k, v, **fwd_kw)
    out, lse = wa._fwd(st, q, k, v, live, alibi_f, ints)
    args = (st, q, k, v, live, alibi_f, ints, lse, wa._delta(out, o["do"]),
            o["do"])
    bufs = {"windowed_attn_dq": (torch.empty_like(q), torch.empty_like(q)),
            "windowed_attn_dkv": (torch.empty_like(k), torch.empty_like(v),
                                  torch.empty_like(k), torch.empty_like(v))}
    calls = {name: (lambda name=name, outs=outs:
                    wa._bwd_pass(name, *args, outs))
             for name, outs in bufs.items()}
    return calls, (st, live, alibi_f, ints, out, lse, bufs)


def time_bwd_at(o, kw, plain_ms, label):
    """Kernels 2 and 3 at one training shape, each on its own, beside the
    backward of ``scaled_dot_product_attention`` (the library yardstick:
    the same boolean mask, repeated kv heads, no NoPE or reset stream).
    The bound counts what these inputs need: 2 (2D + Dv) FLOPs per attended
    pair and head for dq, 2 (2D + 2Dv) for dk/dv; bytes read once each as
    the passes read them: each query row's q or q_nope (a [SUM] row stages
    q_nope in q's place), do, lse and delta (``_delta`` runs before the
    passes, so o is not theirs), the attended keys as ``_attended_bytes``
    counts them, V0 for the keys a [SUM] row attends, the index operands;
    and the pass's gradient buffers written once."""
    import torch.nn.functional as F
    from repro_torch.core.windowed import dti_mask
    from repro_torch.kernels import windowed_attn as wa
    q, k, v, do = o["q"], o["k"], o["v"], o["do"]
    B, S, H, D = q.shape
    Hk, Dv = k.shape[2], v.shape[3]
    calls, (st, live, alibi_f, ints, _, _, bufs) = _bwd_launches(o, kw)
    fwd_ms = cuda_ms(lambda: wa._fwd(st, q, k, v, live, alibi_f, ints),
                     iters=10, warmup=2)
    log(f"  [{label}] windowed_attn at the training shape (NoPE + reset, "
        f"bf16, two launches per layer a step): {fwd_ms:.4f} ms")
    mask = dti_mask(o["pos"], o["pos"], window=1024, is_sum_k=o["is_sum"],
                    valid_k=o["valid"])
    pairs = int(mask.sum())
    e = q.element_size()
    kv_bytes, keys = _attended_bytes(mask, o["is_sum"], hk=Hk, d=D, dv=Dv,
                                     esize=e)
    v0_bytes = keys[1] * Hk * Dv * e if kw.get("v0") is not None else 0
    ins = (B * S * H * (D + Dv) * e + 2 * B * H * S * 4 + kv_bytes + v0_bytes
           + _bytes(o["pos"], o["pos"], o["is_sum"], o["is_sum"], o["valid"],
                    kw.get("alibi")))
    flops = {"windowed_attn_dq": pairs * H * 2 * (2 * D + Dv),
             "windowed_attn_dkv": pairs * H * 2 * (2 * D + 2 * Dv)}
    res = {}
    for name, outs in bufs.items():
        ms = cuda_ms(calls[name], iters=5, warmup=1)
        res[name] = dict(ms=ms, bytes=ins + _bytes(*outs), flops=flops[name],
                         plain_ms=plain_ms)
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
    log(f"  [{label}] attended pairs {pairs} (of {B * S * S}); SDPA backward "
        f"{lib:.4f} ms ({sdpa_backend(qt, kt, vt, mask[:, None])})")
    for name, r in res.items():
        t_ops = r["flops"] / BF16_FLOPS * 1e3
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        log(f"  [{label}] {name}: {r['ms']:.4f} ms, bound "
            f"{max(t_ops, t_bytes):.4f} ms "
            f"({'operations' if t_ops >= t_bytes else 'bytes'}: "
            f"{r['flops'] / 1e12:.4f} TFLOP, {r['bytes'] / 1e6:.1f} MB), "
            f"plain backward {plain_ms:.2f} ms")
    return res


def time_bwd_wide():
    """Phase 6's rows for kernels 2 and 3's Dqk-192 class at deepseek-v2's
    training shape (phase 2i's, made again from a seed; ``time_bwd_at``),
    the plain backward summed over calls of one batch row (its fp32 score
    planes at 128 heads), and with [SUM] rows every 7th slot."""
    from repro_torch.kernels.windowed_attn import windowed_attention_bwd_plain
    gen = torch.Generator(device="cuda")
    gen.manual_seed(29)
    o, kw = train_windowed(gen, heads=DS_HEADS)
    plain = sum(cuda_ms(lambda a=a, k=k: windowed_attention_bwd_plain(*a, **k),
                        iters=1, warmup=1)
                for a, k in row_slices((o["q"], o["k"], o["v"], o["do"]), kw,
                                       1, f32=False))
    res = time_bwd_at(o, kw, plain, "deepseek-v2 B=8 S=2048 H=Hk=128 Dqk192 "
                      "Dv128")
    del o, kw
    spread, _ = _bwd_launches(*train_windowed(gen, spread=True,
                                              heads=DS_HEADS))
    log("  Dqk 192, [SUM] rows every 7th slot: "
        + ", ".join(f"{name}_192 {cuda_ms(fn, iters=5, warmup=1):.4f} ms"
                    for name, fn in spread.items()))
    del spread
    torch.cuda.empty_cache()
    return {f"{name}_192": r for name, r in res.items()}


def time_bwd_kernels(bwd):
    """Kernels 2 and 3 at phase 7's training shape (``time_bwd_at``), and
    with [SUM] rows every 7th slot."""
    o, kw = bwd["windowed_attn_dq"]["ops"]
    res = time_bwd_at(o, kw, bwd["windowed_attn_dq"]["plain_ms"],
                      "dti-llama B=8 S=2048 H32 Hk8 D128")
    spread, _ = _bwd_launches(*bwd["windowed_attn_dq"]["spread"])
    log("  [SUM] rows every 7th slot (phase B revisits every q tile): "
        + ", ".join(f"{name} {cuda_ms(fn, iters=5, warmup=1):.4f} ms"
                    for name, fn in spread.items()))
    return res


def time_mla(res, quant):
    """Kernel 4's MLA mode on ``res``'s latent operands, its plain version
    and its library yardstick, with PR 23's bounds: the yardstick and the
    bound take the concatenated operands the engine built before (K =
    [ckv | kpe_rope], V = ckv, K_nope = [ckv | kpe]; int8: the codes
    [ckv | kpe] with two scale groups split at r)."""
    from repro_torch.kernels.decode_attn import (decode_attention_mla,
                                                 decode_attention_mla_plain)
    o, q8, kw = res["ops"]
    args = mla_args(o, q8)
    calls = (lambda: decode_attention_mla(*args, **kw),
             lambda: decode_attention_mla_plain(*args, **kw))
    r = o["ckv"].shape[-1]
    if not quant:
        cat = dict(o, k=torch.cat([o["ckv"], o["kpe_rope"]], -1)[:, :, None],
                   v=o["ckv"][:, :, None],
                   kn=torch.cat([o["ckv"], o["kpe"]], -1)[:, :, None])
        return time_decode(cat, decode_kwargs(cat, window=1024, nope=True,
                                              seg=True), calls)
    codes = dict(k=torch.cat([q8["ckv"], q8["kpe"]], -1)[:, :, None],
                 v=q8["ckv"][:, :, None],
                 k_scale=torch.stack([q8["ckv_scale"], q8["kpe_scale"]],
                                     -1)[:, :, None],
                 v_scale=q8["ckv_scale"][:, :, None])
    return time_q8(dict(ops=(o, codes, q8_kwargs(
        o, codes, window=1024, nope=True, seg=True, rope_start=r,
        theta=o["theta"]))), calls)


def time_mla_s16():
    """Kernel 4's MLA mode, both modes, at the scheduler's smallest bucket
    (s=16: four 4-token candidates over the MLA decode shape's contexts),
    where its plan cuts the cache into five ranges, beside the library
    yardsticks."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    o, kw = real_mla(gen, s=16)
    res = {"decode_attn_mla": time_mla(dict(ops=(o, None, kw)), False)}
    del o, kw
    res["decode_attn_mla_q8"] = time_mla(dict(ops=real_mla_q8(gen, s=16)),
                                         True)
    for name, r in res.items():
        log(f"  {name} at s=16 (B=8 cap=2048 H40 r256 dr32 w1024): "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, bound "
            f"{max(r['bytes'] / HBM_BYTES_PER_S, r['flops'] / BF16_FLOPS) * 1e3:.4f}"
            f" ms ({r['flops'] / 1e9:.2f} GFLOP, {r['bytes'] / 1e6:.1f} MB)")
    return res


def time_mla_ranges(mla_k, n_split=3):
    """Kernel 4's MLA mode at the decode shape (s=64) with its cache cut
    into ``n_split`` equal ranges (960 CTAs, a last wave 64 % full on an
    H100) instead of the plan's one (320 CTAs), the cut ``mla_split_plan``
    does not make: what the extra waves' balance costs and gains."""
    from repro_torch.kernels import decode_attn as da
    plan = da.mla_split_plan

    def cut(b, s, h, cap, n_sm, dv=256, dr=32):
        n_rb = -(-h * s // da.ROW_BLOCK)
        per, ns = da._ranges(-(-cap // da.KV_TILE), n_split)
        return da.SplitPlan(n_rb, ns, per * da.KV_TILE, b * n_rb * ns,
                            ns * b * s * h * (dv + 2))
    out = {}
    for name, res in mla_k.items():
        o, q8, kw = res["ops"]
        args = mla_args(o, q8)
        one = cuda_ms(lambda: da.decode_attention_mla(*args, **kw))
        da.mla_split_plan = cut
        try:
            out[name] = (one, cuda_ms(lambda: da.decode_attention_mla(
                *args, **kw)))
        finally:
            da.mla_split_plan = plan
        log(f"  {name} at s=64 in {n_split} cache ranges: {out[name][1]:.4f} "
            f"ms; the plan's one range: {one:.4f} ms")
    return out


def time_q8(q8res, calls=None):
    """Kernel 4's int8 mode at the decode shape beside its plain version
    and a library yardstick: dequantize, rope and repeat the kv heads, then
    ``scaled_dot_product_attention`` with the same boolean mask (no NoPE
    stream; the port never calls it). The bound counts what these inputs
    need: each key any query of a row attends, read once per (row, kv
    head) as int8 K and V codes plus their fp32 scales (the NoPE stream is
    the same codes), each query row's q or q_nope, o, the index operands;
    FLOPs 2 (D + Dv) per attended pair and head."""
    import torch.nn.functional as F
    from repro_torch.core.quant import dequantize_q8
    from repro_torch.kernels.decode_attn import (_decode_mask,
                                                 _dequant_keys,
                                                 decode_attention,
                                                 decode_attention_plain)
    from repro_torch.models.layers import apply_rope
    o, q8, kw = q8res["ops"]
    q = o["q"]
    B, s, H, D = q.shape
    Hk, Dv, G = q8["k"].shape[2], q8["v"].shape[3], q8["k_scale"].shape[-1]
    args = (q, q8["k"], q8["v"], o["pos_q"], o["pos_k"])
    run, run_plain = calls or (lambda: decode_attention(*args, **kw),
                               lambda: decode_attention_plain(*args, **kw))
    ms = cuda_ms(run)
    plain = cuda_ms(run_plain)
    mask = _decode_mask(o["pos_k"], o["pos_q"], kw["window"], o["seg_q"],
                        o["seg_k"])
    n_any = int(mask.any(1).sum())
    nbytes = (n_any * Hk * (D + 4 * G + Dv + 4)
              + B * s * H * (D + Dv) * q.element_size()
              + _bytes(o["pos_q"], o["pos_k"], o["is_sum"], o["seg_q"],
                       o["seg_k"], o["alibi"]) + 4 * D // 2)
    flops = int(mask.sum()) * H * 2 * (D + Dv)
    mask4 = mask[:, None]
    rep = H // Hk

    def library():
        if G == 1:
            kd = dequantize_q8(q8["k"], q8["k_scale"][..., 0])
            kr = apply_rope(kd, o["pos_k"].clamp(min=0), kw["rope_theta"])
        else:          # two groups, the span from rope_start roped
            kr = _dequant_keys(q8["k"], q8["k_scale"], o["pos_k"],
                               kw["rope_start"], kw["rope_theta"])[0]
        vd = dequantize_q8(q8["v"], q8["v_scale"])
        kt = kr.to(q.dtype).repeat_interleave(rep, 2).transpose(1, 2)
        vt = vd.to(q.dtype).repeat_interleave(rep, 2).transpose(1, 2)
        return F.scaled_dot_product_attention(q.transpose(1, 2), kt, vt,
                                              attn_mask=mask4)
    lib = cuda_ms(library)
    kt = q8["k"].to(q.dtype).repeat_interleave(rep, 2).transpose(1, 2)
    vt = q8["v"].to(q.dtype).repeat_interleave(rep, 2).transpose(1, 2)
    backend = sdpa_backend(q.transpose(1, 2), kt, vt, mask4)
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bytes=nbytes,
                flops=flops, keys=n_any, backend=backend)


def profile_sched(cfg, params, kv_dtype, dev="cuda"):
    """Phase 9's paged run once more under ``torch.profiler``: the device's
    busy time per step (the sum of its kernels' device time; the operator
    rows that enclose them are not counted again), its idle share of the
    run's wall time (an upper bound: the profiler adds host time) and the
    kernels that take the most device time. None when the profiler
    reports no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.scheduler import ServeScheduler
    sched = ServeScheduler(params, cfg, **SCHED, kv_dtype=kv_dtype,
                           paged=True, attn_impl=cfg.attn_impl,
                           cache_dtype=cfg.cdtype, device=dev)
    sched.warmup()
    sched.reset_stats()
    for r in sched_stream(cfg, N_REQ):
        sched.submit(r["context"], r["candidates"])
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched.run()
        sync()
        wall = time.perf_counter() - t0
    dev = lambda e: (getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0) or 0)
    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU and dev(e) > 0]
    busy_ms = sum(dev(e) for e in events) / 1e3
    steps = sched.n_steps
    if not busy_ms:
        log(f"  profile [{kv_dtype or 'bf16'} KV]: no device time reported")
        return None
    top = sorted(events, key=dev, reverse=True)[:6]
    log(f"  profile [{kv_dtype or 'bf16'} KV, paged]: {steps} steps, wall "
        f"{wall * 1e3:.1f} ms under the profiler, device busy "
        f"{busy_ms:.1f} ms ({busy_ms / steps:.2f} ms per step), idle share "
        f"{1 - busy_ms / (wall * 1e3):.3f}; top device time: "
        + "; ".join(f"{e.key[:60]} {dev(e) / 1e3:.1f} ms ({e.count} calls)"
                    for e in top))
    return dict(busy_ms_per_step=busy_ms / steps,
                idle_share=1 - busy_ms / (wall * 1e3))


def profile_call(fn, label):
    """``fn`` once more (after a warm-up call) under ``torch.profiler``: the
    device's busy time (the sum of its kernels' device time), its idle
    share of the call's wall time under the profiler (an upper bound: the
    profiler adds host time) and the kernels that take the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = lambda e: (getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0) or 0)
    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU and dev(e) > 0]
    busy = sum(dev(e) for e in events) / 1e3
    top = sorted(events, key=dev, reverse=True)[:10]
    log(f"  profile [{label}]: wall {wall:.2f} ms under the profiler, "
        f"device busy {busy:.2f} ms, idle share "
        f"{1 - busy / wall if wall else float('nan'):.3f}; top device time: "
        + "; ".join(f"{e.key[:60]} {dev(e) / 1e3:.2f} ms ({e.count} calls)"
                    for e in top))
    return busy


def mla_ptxas(logs) -> str:
    """``-Xptxas -v``'s report for the MLA mode's instantiations
    (``mla_kernel<MlaGeo<latent, rope span>, T, NOPE, QUANT>`` in
    ``csrc/decode_attn.cu``): registers and spill bytes of each, on one
    line."""
    text = logs.get("decode_attn")
    if text is None:
        return "not built in this run (the library was already built)"
    out, name, spill = [], None, "?"
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), "?"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"{m.group(1)}/{m.group(2)} B spill stores/loads"
            continue
        m = re.search(r"Used (\d+) registers", line)
        t = re.search(r"mla_kernelINS_6MlaGeoILi(\d+)ELi(\d+)EEE"
                      r"(f|13__nv_bfloat16)Lb([01])ELb([01])E", name or "")
        if m and t:
            out.append(f"mla_kernel<{t.group(1)}/{t.group(2)}, "
                       f"{'fp32' if t.group(3) == 'f' else 'bf16'}"
                       f", nope={t.group(4)}, int8={t.group(5)}>: "
                       f"{m.group(1)} registers, {spill}")
    return "; ".join(out) or "no MLA instantiation in the report"


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
    graphs = start_gnn_graphs()
    try:
        return run_phases(kernels, graphs, t_start)
    finally:
        graphs[0].shutdown(cancel_futures=True)
        shutil.rmtree(GRAPH_DIR, ignore_errors=True)


def run_phases(kernels, graphs, t_start) -> int:
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
    bwd = check_kernels_bwd("2d", BWD_CASES, seed=4)
    q8res = check_kernels_q8()
    mla_k = check_kernels_mla()
    wide = check_kernels_wide()
    wide_bwd = check_kernels_bwd("2i", WIDE_BWD_CASES, seed=28,
                                 heads=DS_HEADS, leak_dims=(192, 128),
                                 unaligned=True, keep=False)
    bag = check_kernels_bag(kernels)
    recsys = phase_recsys(kernels)
    torch.cuda.empty_cache()
    mla = phase_mla(kernels)
    mla_train = phase_mla_train(kernels)
    moe = phase_moe(kernels)
    moe_train = phase_moe_train(kernels)
    gqa = phase_gqa_archs(kernels)
    torch.cuda.empty_cache()
    ds = phase_deepseek(kernels)
    torch.cuda.empty_cache()
    gnn = phase_gnn(kernels, graphs)
    torch.cuda.empty_cache()

    cfg, params = build_model()
    users, prompts = serving_material(cfg)
    kernels.reset_launches()
    server, p_prefill = phase_prefill(cfg, params, prompts, kernels)
    run = phase_decode(cfg, params, users, server, p_prefill, kernels)
    launches = dict(kernels.LAUNCHES)
    want = {"windowed_attn": cfg.n_layers * (1 + run["n_prefill_calls"]),
            "windowed_attn_dq": 0, "windowed_attn_dkv": 0,
            "decode_attn": cfg.n_layers * run["n_steps"], "decode_attn_q8": 0,
            "decode_attn_mla": 0, "decode_attn_mla_q8": 0,
            "embedding_bag": 0, "embedding_bag_q8": 0,
            "windowed_attn_192": 0, "decode_attn_mla_576": 0,
            "decode_attn_mla_576_q8": 0, "windowed_attn_dq_192": 0,
            "windowed_attn_dkv_192": 0}
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

    sched_runs, sched_errs = phase_sched(cfg, params, kernels)
    for res in sched_runs.values():
        for name, n in res["launches"].items():
            launches[name] += n
    sched32 = phase_sched32(cfg, params, kernels)
    torch.cuda.empty_cache()
    multi = phase_multi_target(cfg, params, kernels)
    for res in (bag, mla, mla_train, moe, moe_train, gqa, gnn, multi, ds,
                ds["train"]):
        for name, n in res["launches"].items():
            launches[name] += n

    log("phase 6: times (CUDA events after warm-up)")
    t_prefill = cuda_ms(lambda: server.score(prompts), iters=3, warmup=1)
    t_decode = cuda_ms(lambda: run["decode"](params, run["cache"],
                                             *run["burst_args"]),
                       iters=5, warmup=1)
    log(f"  prefill call B=8 S=2048 32 layers: {t_prefill:.2f} ms; decode "
        f"burst step B=8 s=64 cap=2048: {t_decode:.2f} ms ({card})")
    profile_call(lambda: run["decode"](params, run["cache"], *run["burst_args"]),
                 "decode burst step B=8 s=64 cap=2048")
    profile_call(lambda: server.score(prompts), "prefill call B=8 S=2048 "
                 "32 layers")
    del run, server
    t_train = time_train(cfg, params, mat, train)
    state = {"s": train["state"]}

    def one_step():   # two more LoRA steps; every check ran before
        state["s"] = train["step_fn"](state["s"], mat["batches"][0])[0]
    profile_call(one_step, f"train step B={TRAIN_ROWS} S={TRAIN_LEN} 32 "
                 "layers")
    del train, state
    times = time_kernels(real)
    times.update(time_bwd_kernels(bwd))
    mla_bwd = time_bwd_at(*mla_train["bwd"]["ops"],
                          mla_train["bwd"]["plain_ms"],
                          "minicpm3-4b B=8 S=2048 H=Hk=40 Dqk96 Dv64")
    del mla_train["bwd"]["ops"]
    times["decode_attn_q8"] = time_q8(q8res)
    times["decode_attn_mla"] = time_mla(mla_k["decode_attn_mla"], False)
    times["decode_attn_mla_q8"] = time_mla(mla_k["decode_attn_mla_q8"], True)
    for name in ("decode_attn_mla", "decode_attn_mla_q8"):
        log(f"  {name}: SDPA picks {times[name]['backend']} for these "
            f"operands (MQA, Dqk 288, Dv 256, a boolean mask)")
    time_decode_s16()
    time_mla_s16()
    time_mla_ranges(mla_k)
    times.update(time_wide())
    times.update(time_bwd_wide())
    times.update(bag["times"])
    prof = {kv: profile_sched(cfg, params, kv) for kv in (None, "int8")}
    errs = {name: r["err"]
            for name, r in {**real, **bwd, **wide_bwd}.items()}
    errs["decode_attn_q8"] = q8res["err"]
    errs.update({name: r["err"] for name, r in mla_k.items()})
    errs.update(wide)
    errs.update(bag["errs"])
    for key, res in sched_runs.items():
        tel = res["tel"]
        log(f"  scheduler 9{key}: {res['wall'] * 1e3 / tel['steps']:.2f} ms "
            f"per step over {tel['steps']} steps (median step span "
            f"{res['step_ms_median']:.2f} ms), "
            f"{res['candidates'] / res['wall']:.1f} candidates/s, pages in "
            f"use {tel.get('pages_in_use')}, KV bytes {res['kv_bytes']}, "
            f"cross-row hits {tel['cross_row_hits']}, host per step "
            f"(dispatch + build_wave medians) {res['host_ms']:.3f} ms, "
            f"warmup first/execute s per bucket "
            f"{ {b: (round(j['first_s'], 4), round(j['execute_s'], 4)) for b, j in res['jit'].items()} }")
    bwd_src = "src/repro/kernels/windowed_attn/windowed_attn_bwd.py"
    src = {"windowed_attn": ("src/repro_torch/kernels/csrc/windowed_attn.cu",
                             "src/repro/kernels/windowed_attn/windowed_attn.py:79"),
           "windowed_attn_dq": ("src/repro_torch/kernels/csrc/windowed_attn_bwd.cu",
                                f"{bwd_src}:112"),
           "windowed_attn_dkv": ("src/repro_torch/kernels/csrc/windowed_attn_bwd.cu",
                                 f"{bwd_src}:145"),
           "decode_attn": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                           "src/repro/kernels/decode_attn/decode_attn.py:116"),
           "decode_attn_q8": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                              "src/repro/kernels/decode_attn/decode_attn.py:139"),
           "decode_attn_mla": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                               "src/repro/kernels/decode_attn/decode_attn.py:317"),
           "decode_attn_mla_q8": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                                  "src/repro/kernels/decode_attn/decode_attn.py:139"),
           "embedding_bag": ("src/repro_torch/kernels/csrc/embedding_bag.cu",
                             "src/repro/kernels/embedding_bag/embedding_bag.py:29"),
           "embedding_bag_q8": ("src/repro_torch/kernels/csrc/embedding_bag.cu",
                                "src/repro/kernels/embedding_bag/embedding_bag.py:29"),
           "windowed_attn_192": ("src/repro_torch/kernels/csrc/windowed_attn.cu",
                                 "src/repro/kernels/windowed_attn/windowed_attn.py:79"),
           "decode_attn_mla_576": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                                   "src/repro/kernels/decode_attn/decode_attn.py:317"),
           "decode_attn_mla_576_q8": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                                      "src/repro/kernels/decode_attn/decode_attn.py:139"),
           "windowed_attn_dq_192": ("src/repro_torch/kernels/csrc/windowed_attn_bwd.cu",
                                    f"{bwd_src}:112"),
           "windowed_attn_dkv_192": ("src/repro_torch/kernels/csrc/windowed_attn_bwd.cu",
                                     f"{bwd_src}:145")}
    rows = []
    for name in kernels.KERNELS:
        t = times[name]
        t_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = t["flops"] / t.get("peak", BF16_FLOPS) * 1e3
        row = dict(name=name, route="cuda", source=src[name][0],
                   replaces=src[name][1], launches=launches[name],
                   max_abs_err=errs[name], ms=t["ms"],
                   plain_ms=t["plain_ms"], bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   library_ms=t["library_ms"])
        if name.startswith("embedding_bag"):
            what = (f"; distinct rows read, slots summed: {t['keys']}; "
                    f"32-byte sector floor "
                    f"{t['floor'] / HBM_BYTES_PER_S * 1e3:.4f} ms")
        elif isinstance(t.get("keys"), tuple):
            what = (f"; keys read per (row, kv head), summed over rows, for "
                    f"K/K_nope/V: {t['keys']}")
        elif "keys" in t:
            what = (f"; keys read per (row, kv head), summed over rows, as "
                    f"K and V codes: {t['keys']}")
        else:
            what = ""
        log(f"  {name}: {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"library {t['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} "
            f"ms ({row['bound_by']}: {t['bytes'] / 1e6:.1f} MB, "
            f"{t['flops'] / 1e12:.4f} TFLOP), launches {launches[name]}"
            + what)
        rows.append(row)
    log(f"  summary: train step {t_train['step_ms']:.2f} ms, peak "
        f"{t_train['peak_gib']:.2f} GiB, fp32 train check loss diff "
        f"{check32['loss_diff']:.3e} grad rel {check32['grad_rel']:.3e}; "
        f"scheduler score diffs {sched_errs}, fp32 checks {sched32}, "
        f"profiles {prof} ({card})")
    mt = mla["times"]
    log(f"  minicpm3-4b (MLA): prefill {mt['prefill_ms']:.2f} ms, decode "
        f"burst step {mt['decode_ms']:.2f} ms, scheduler bf16 KV "
        f"{mt['sched_bf16'][0]:.2f} ms/step {mt['sched_bf16'][1]:.1f} "
        f"candidates/s, int8 KV {mt['sched_int8'][0]:.2f} ms/step "
        f"{mt['sched_int8'][1]:.1f} candidates/s; score diffs {mla['errs']}; "
        f"fp32 checks {mla['checks']} ({card})")
    tt = mla_train["times"]
    log(f"  minicpm3-4b training (LoRA rank 8): train step "
        f"{tt['step_ms']:.2f} ms, {tt['targets_per_s']:.2f} targets/s, "
        f"{tt['tokens_per_s']:.1f} non-pad tokens/s, peak "
        f"{tt['peak_gib']:.2f} GiB; kernels 2/3 at its shape: dq "
        f"{mla_bwd['windowed_attn_dq']['ms']:.4f} ms, dk/dv "
        f"{mla_bwd['windowed_attn_dkv']['ms']:.4f} ms, SDPA backward "
        f"{mla_bwd['windowed_attn_dq']['library_ms']:.4f} ms; bf16 grads "
        f"max|err| {mla_train['bwd']['errs']}; 13b {mla_train['check']} "
        f"({card})")
    mo = moe["times"]
    log(f"  qwen2-moe-a2.7b (MoE): prefill {mo['prefill_ms']:.2f} ms, decode "
        f"burst step {mo['decode_ms']:.2f} ms, peak {mo['peak_gib']:.2f} "
        f"GiB, drops at capacity factor 1.25 {mo['drops']}; 14b "
        f"{moe['checks']} ({card})")
    log("  gin-tu (GNN): " + "; ".join(
        f"{name} step {t['step_ms']:.2f} ms, {t['nodes_per_s']:.0f} nodes/s, "
        f"peak {t['peak_gib']:.2f} GiB, host {t['host_s']:.1f} s"
        for name, t in gnn["times"].items())
        + f"; full_graph_sm card vs CPU AdamW loss diff {gnn['cut']:.3e} "
        f"({card})")
    log(f"  multi-target (dti-llama FULL): score_multi_target "
        f"{multi['mt_ms']:.2f} ms ({multi['mt_cand_s']:.1f} candidates/s, "
        f"peak {multi['mt_peak_gib']:.2f} GiB) vs score "
        f"{multi['ind_ms']:.2f} ms ({multi['ind_cand_s']:.1f} candidates/s, "
        f"peak {multi['ind_peak_gib']:.2f} GiB); bf16 drift multi-target / "
        f"independent {multi['drift']}; fp32 2 layers {multi['fp32']} "
        f"({card})")
    dt = ds["times"]
    log(f"  deepseek-v2-236b (MLA + MoE, {DS_LAYERS} layers at FULL "
        f"widths): prefill {dt['prefill_ms']:.2f} ms (device busy "
        f"{dt['prefill_busy_ms']:.2f} ms), decode burst step "
        f"{dt['decode_ms']:.2f} ms (device busy {dt['decode_busy_ms']:.2f} "
        f"ms), scheduler {dt['sched'][0]:.2f} ms/step "
        f"{dt['sched'][1]:.1f} candidates/s, peak {dt['peak_gib']:.2f} GiB, "
        f"drops at 1.25 {dt['drops']}; bf16 diffs {ds['errs']}; 18b "
        f"{ds['checks']} ({card})")
    for label, res in (("deepseek-v2-236b (19)", ds["train"]),
                       ("qwen2-moe-a2.7b (20)", moe_train)):
        t = res["times"]
        log(f"  {label} LoRA training: train step {t['step_ms']:.2f} ms, "
            f"{t['targets_per_s']:.2f} targets/s, {t['tokens_per_s']:.1f} "
            f"non-pad tokens/s, peak {t['peak_gib']:.2f} GiB, device busy "
            f"{t['busy_ms']:.2f} ms a profiled step, dropped choices "
            f"{t['drops'][0]} of {t['drops'][1]}; fp32 check {res['check']} "
            f"({card})")
    log("  GQA archs: " + "; ".join(
        f"{name} prefill {t['prefill_ms']:.2f} ms, decode burst step "
        f"{t['decode_ms']:.2f} ms, fp32 diffs {gqa['checks'][name]}"
        for name, t in gqa["times"].items()) + f" ({card})")
    log(f"  recsys: card vs CPU AdamW loss diffs {recsys['cut']}; FULL "
        + "; ".join(f"{a} serve {r['serve_ms']:.3f} ms, train B"
                    f"{r['train_batch']} {r['train_ms']:.2f} ms, retrieval "
                    f"{r['retrieval_ms']:.2f} ms, peak {r['peak_gib']:.2f} GiB"
                    for a, r in recsys["full"].items()) + f" ({card})")
    from repro_torch.kernels.decode_attn import mla_ctas_per_sm
    occ = {f"{r}/{dr} {'bf16' if bf else 'fp32'}{' int8' if q8 else ''}"
           f"{' nope' if nope else ''}": mla_ctas_per_sm(bf, q8, nope, 64, h,
                                                         r, dr)
           for h, r, dr in ((40, 256, 32), (128, 512, 64))
           for bf in (True, False) for q8 in (False, True)
           for nope in (False, True)}
    log(f"  MLA instantiations (-Xptxas -v): {mla_ptxas(logs)}; resident "
        f"CTAs per SM at s=64 (H=40 at 256/32, H=128 at 512/64): {occ}")
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
