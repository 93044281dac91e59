"""Decode/burst attention into the KV cache: CUDA kernel wrappers and their
plain versions.

Replaces the Pallas TPU kernel ``repro.kernels.decode_attn.decode_attn``
(``_kernel``, launched by ``decode_attention_bshd``) in both its modes
with ``csrc/decode_attn.cu``. Operands stay in the serving cache layout:
queries ``(B, s, H, Dqk)``, cache-side tensors ``(B, cap, Hk, D)``; each
K/V tile the kernel stages serves a block of ``ROW_BLOCK`` of the
``n_rep`` heads x ``s`` queries of its kv head (GQA), and the other blocks
of that kv head read it from L2.

Attendable iff the slot is filled (``pos_k >= 0``), causal, within
``window`` when ``window > 0`` (0 = unlimited), and segment-compatible
(``seg_k < 0`` shared, else ``seg_k == seg_q``). Rows flagged ``is_sum_q``
score the NoPE stream minus ``alibi * distance``. Rows with no key give 0.

``decode_attention`` takes head dims up to ``MAX_HEAD_DIM`` (128) on the
card, the GQA mode (launch keys ``"decode_attn"``, ``"decode_attn_q8"``);
its plain version computes any head dims. ``decode_attention_mla`` is the
absorbed-MLA mode (``"decode_attn_mla"``, ``"decode_attn_mla_q8"``): one
latent key (Hk = 1) read in place from the latent cache's own tensors,
``ckv (B, cap, r)`` (the latent, and the values: Dv = r) and the rope span
``kpe_rope``/``kpe (B, cap, dr)``, q = [q_abs | q_pe] of r + dr dims, in
one of ``MLA_GEOMETRIES``: a latent up to 256 and a rope span up to 32
(minicpm3-4b's 288 / 256; launch keys as above), or up to 512 and 64
(deepseek-v2's 576 / 512; ``"decode_attn_mla_576"``,
``"decode_attn_mla_576_q8"``); wider ones raise. It computes what
``decode_attention_plain`` computes on the concatenated operands the
engine built before (``decode_attention_mla_plain``), without the copies.

``k_scale`` (``ckv_scale``/``kpe_scale`` in the MLA mode) switches to the
int8 mode (the quantized-KV contract of ``repro_torch.core.quant``):
``k``/``v`` are raw int8 cache codes, unroped; ``k_scale (B, cap, Hk, G)``
(G in {1, 2}: two scale groups split at ``rope_start``) and
``v_scale (B, cap, Hk)`` are their fp32 scales. Keys are dequantized and
their span ``[rope_start:]`` roped from ``max(pos_k, 0)`` inside the
kernel (launch key ``"decode_attn_q8"``); the NoPE stream is the same
codes dequantized without rotation, so ``k_nope`` must be None there.

The GQA kernel's work is split by ``decode_split_plan``: blocks of
``ROW_BLOCK`` query rows, and, where those are too few to cover the card's
SMs, ranges of the cache whose fp32 partials go to a workspace this
wrapper allocates and the same C entry point combines in a fixed order
(one launch count per call; equal inputs give equal bits). The MLA
kernel's by ``mla_split_plan``: row blocks (times the value-column
chunks of ``MLA_VALUE_COLS`` a CTA owns: two at a latent of 512) times
the fewest cache ranges that fill one wave of resident CTAs
(``MLA_CTAS`` per SM, as its registers and shared memory,
``mla_smem_bytes``, allow).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import as_i32, check_launch, load, ptr, sm_count
from repro_torch.core.windowed import NEG_INF, _repeat_kv
from repro_torch.models.layers import apply_rope, rope_freqs

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {"decode_attn_fwd": [_P] * 13 + [_I] * 14 + [_F, _P],
             "decode_attn_q8_fwd": [_P] * 15 + [_I] * 16 + [_F, _P],
             "decode_attn_mla_fwd": [_P] * 13 + [_I] * 14 + [_F, _P],
             "decode_attn_mla_q8_fwd": [_P] * 15 + [_I] * 14 + [_F, _P],
             "decode_attn_mla_ctas_per_sm": [_I] * 7 + [_P]}
MAX_HEAD_DIM = 128  # the GQA mode's head dims (DMAX in csrc/decode_attn.cu)
# The MLA mode's geometries, (latent (value) width, rope span) up to which
# each instance of mla_kernel reads (MlaNarrow, MlaWide there), with their
# resident CTAs per SM (bf16 and int8 queries) and launch keys
MLA_CTAS = {(256, 32): 2, (512, 64): 1}
MLA_GEOMETRIES = tuple(MLA_CTAS)
MLA_KEYS = {(256, 32): "decode_attn_mla", (512, 64): "decode_attn_mla_576"}
MLA_MAX_V, MLA_MAX_ROPE = MLA_GEOMETRIES[-1]
MLA_MAX_QK = MLA_MAX_V + MLA_MAX_ROPE
MLA_CTAS_PER_SM = MLA_CTAS[MLA_GEOMETRIES[0]]  # the narrow geometry's
MLA_VALUE_COLS = 256  # value columns one MLA CTA owns (VW there)
ROW_BLOCK = 64      # query rows per CTA (RB there)
KV_TILE = 32        # cache slots per staged tile (BK there)
MAX_TILES = 256     # tiles of one cache range (MAX_TILES there)


class SplitPlan(NamedTuple):
    """How one call's work is cut: ``n_rb`` blocks of ``ROW_BLOCK`` rows
    (n_rep heads x s queries of a kv head) times ``n_split`` cache ranges
    of ``span`` slots, for each (kv head, batch row): ``grid`` CTAs.
    ``workspace`` fp32 values hold the ranges' partial rows (acc, then m,
    then l) when ``n_split > 1``, else 0."""
    n_rb: int
    n_split: int
    span: int
    grid: int
    workspace: int


def _ranges(n_tiles: int, want: int):
    """The fewest equal ranges of whole tiles that ``want`` asks for: (tiles
    per range, ranges)."""
    per = -(-n_tiles // want)
    return per, -(-n_tiles // per)


def decode_split_plan(b: int, s: int, h: int, hk: int, cap: int, n_sm: int,
                      dv: int = MAX_HEAD_DIM) -> SplitPlan:
    """The GQA mode's plan. Row blocks first: they re-read K/V tiles from
    L2 and need no workspace. Only when ``b * hk * n_rb`` CTAs leave SMs
    idle (or a range would exceed ``MAX_TILES`` tiles, the kernel's list
    of live tiles) is the cache cut into the fewest equal ranges of whole
    tiles that cover ``n_sm``: each range costs ``b * s * h * (dv + 2)``
    fp32 of partials, written once and read once. (Equal ranges of whole
    tiles can come out fewer than asked, 64 tiles in 9 ranges being 8 of
    8: then one more is asked for.)"""
    n_rb = -(-(h // hk) * s // ROW_BLOCK)
    base = b * hk * n_rb
    n_tiles = max(1, -(-cap // KV_TILE))
    want = min(n_tiles, max(1, -(-n_sm // max(base, 1)),
                            -(-n_tiles // MAX_TILES)))
    per, n_split = _ranges(n_tiles, want)
    while per > 1 and base * n_split < n_sm:
        want += 1
        per, n_split = _ranges(n_tiles, want)
    ws = n_split * b * s * h * (dv + 2) if n_split > 1 else 0
    return SplitPlan(n_rb, n_split, per * KV_TILE, base * n_split, ws)


def mla_geometry(r: int, dr: int):
    """The narrowest of ``MLA_GEOMETRIES`` that holds a latent of ``r``
    values and an even rope span of ``dr``; raises for wider ones."""
    for lat, rope in MLA_GEOMETRIES:
        if 0 < r <= lat and 0 < dr <= rope and dr % 2 == 0:
            return lat, rope
    raise ValueError(
        f"head dims {r + dr}/{r} exceed the MLA mode's geometries: a latent "
        f"of up to {MLA_MAX_V} values and an even rope span of up to "
        f"{MLA_MAX_ROPE} (" + ", ".join(f"{v + dr_}/{v}" for v, dr_ in
                                        MLA_GEOMETRIES) + ")")


def mla_split_plan(b: int, s: int, h: int, cap: int, n_sm: int,
                   dv: int = 256, dr: int = 32) -> SplitPlan:
    """The MLA mode's plan: ``b * n_rb`` row blocks, each taken by one CTA
    per ``MLA_VALUE_COLS`` value columns of ``dv`` (one at minicpm3-4b's
    256, two at deepseek-v2's 512, each computing the block's scores),
    times the fewest equal ranges of whole tiles that give at least one
    full wave of resident CTAs (``n_sm`` times the geometry's
    ``MLA_CTAS``); a range holds at most ``MAX_TILES`` tiles, and one tile
    at the least. More ranges than that cost more than the waves they
    even out: on an H100, three ranges at s=64 (960 CTAs, a last wave 64 %
    full, instead of 320 and 21 %) made the bf16 mode 1.20x slower, each
    range paying a CTA's prologue and epilogue and its fp32 partials
    (PERF.md, PR 24)."""
    n_rb = -(-h * s // ROW_BLOCK)
    base = b * n_rb * -(-dv // MLA_VALUE_COLS)
    slots = n_sm * MLA_CTAS[mla_geometry(dv, dr)]
    n_tiles = max(1, -(-cap // KV_TILE))
    want = max(1, -(-n_tiles // MAX_TILES))
    per, n_split = _ranges(n_tiles, want)
    while per > 1 and base * n_split < slots:
        want += 1
        per, n_split = _ranges(n_tiles, want)
    ws = n_split * b * s * h * (dv + 2) if n_split > 1 else 0
    return SplitPlan(n_rb, n_split, per * KV_TILE, base * n_split, ws)


def mla_smem_bytes(is_bf16: bool, quant: bool, nope: bool, s: int,
                   h: int, r: int = 256, dr: int = 32) -> int:
    """The dynamic shared memory one MLA CTA asks for (``MlaSmem`` and
    ``mla_launch`` in ``csrc/decode_attn.cu``, which refuses a launch whose
    count differs) in the geometry that holds ``r`` and ``dr``: the Q
    planes (64 x (latent + rope span) bf16; none in fp32), the plane stages
    (latent 32 x 256 or 512, rope spans 32 x 32 or 64, in their bf16
    terms), the int8 copy stages, the tile rings and scales, the row
    tables."""
    f32 = not is_bf16
    nl = 3 if f32 and not quant else 1            # latent plane terms
    nr = 3 if f32 else (2 if quant else 1)        # roped rope span
    nn = 3 if f32 and not quant else 1            # unroped rope span
    stages = 1 if f32 and not quant else 3        # copy stages
    pstages = 3 if not f32 and not quant else 1   # plane stages
    lat, rope = mla_geometry(r, dr)
    q_elems = 0 if f32 else ROW_BLOCK * (lat + rope)
    stage = KV_TILE * (nl * lat + nr * rope + (nn * rope if nope else 0))
    raw = stages * (KV_TILE * (lat + rope) + 8 * KV_TILE) if quant else 0
    ints = (4 * stages * KV_TILE + 2 * KV_TILE + rope // 2
            + 6 * ROW_BLOCK + 4 + 3 * MAX_TILES + 1)
    return (q_elems + pstages * stage) * 2 + raw + 4 * ints + 4 * (3 * s + h)


def mla_ctas_per_sm(is_bf16: bool, quant: bool, nope: bool, s: int,
                    h: int, r: int = 256, dr: int = 32) -> int:
    """The MLA kernel's resident CTAs per SM on this card in the geometry
    that holds ``r`` and ``dr``, by the CUDA runtime's occupancy
    calculator (registers and ``mla_smem_bytes``)."""
    mla_geometry(r, dr)
    n = ctypes.c_int(0)
    rc = load("decode_attn", _ARGTYPES).decode_attn_mla_ctas_per_sm(
        int(is_bf16), int(quant), int(nope), s, h, r, dr, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"occupancy query failed: cudaError {rc}")
    return n.value


def split_workspace(plan: SplitPlan, device) -> Optional[torch.Tensor]:
    """The fp32 workspace a call with ``plan`` hands the kernel, or None
    when it has one cache range."""
    if not plan.workspace:
        return None
    return torch.empty(plan.workspace, dtype=torch.float32, device=device)


def _decode_mask(pos_k, pos_q, window: int, seg_q=None, seg_k=None):
    """(B, s, cap) attendability: filled slot, causal, the window term only
    when window > 0, and in-burst segment isolation."""
    m = (pos_k[:, None, :] >= 0) & (pos_q[:, :, None] >= pos_k[:, None, :])
    if window > 0:
        m = m & ((pos_q[:, :, None] - pos_k[:, None, :]) <= window)
    if seg_q is not None and seg_k is not None:
        m = m & ((seg_k[:, None, :] < 0)
                 | (seg_k[:, None, :] == seg_q[:, :, None]))
    return m


def _dequant_keys(k, k_scale, pos_k, rope_start: int, rope_theta: float):
    """int8 key codes -> (roped keys, unroped keys), fp32, as the reference's
    ``decode_attn/ref.py`` computes them: dequantize with the per-dim scale
    row, then rope the span ``[rope_start:]`` from ``max(pos_k, 0)``."""
    kf = k.float()
    if k_scale.shape[-1] == 1:
        sc = k_scale.float()
    else:                          # two groups split at rope_start
        idx = torch.arange(k.shape[-1], device=k.device)
        sc = torch.where(idx < rope_start, k_scale[..., 0:1].float(),
                         k_scale[..., 1:2].float())
    kd = kf * sc
    roped = apply_rope(kd[..., rope_start:], pos_k.clamp(min=0), rope_theta)
    if rope_start:
        roped = torch.cat([kd[..., :rope_start], roped], dim=-1)
    return roped, kd


def decode_attention_plain(q, k, v, pos_q, pos_k, *, window: int,
                           is_sum_q=None, q_nope=None, k_nope=None,
                           alibi=None, seg_q=None, seg_k=None,
                           scale: Optional[float] = None, k_scale=None,
                           v_scale=None, rope_start: int = 0,
                           rope_theta: float = 10000.0) -> torch.Tensor:
    """Plain PyTorch version (mirrors ``decode_attn/ref.py``): the engine's
    dense decode math on the kernel's operands -> (B, s, H, Dv), in q's
    dtype. With ``k_scale`` the int8 operands are dequantized and roped
    first (``_dequant_keys``)."""
    h, d = q.shape[2], q.shape[3]
    n_rep = h // k.shape[2]
    if scale is None:
        scale = d ** -0.5
    nope = q_nope is not None and is_sum_q is not None
    if k_scale is not None:
        if k_nope is not None:
            raise ValueError("the int8 mode derives the NoPE stream from the "
                             "codes: k_nope must be None")
        k, kd = _dequant_keys(k, k_scale, pos_k, rope_start, rope_theta)
        k_nope = kd if nope else None
        v = v.float() * v_scale.float()[..., None]
    sc = torch.einsum("bshd,bkhd->bhsk", q.float(),
                      _repeat_kv(k, n_rep).float()) * scale
    if nope:
        dist = (pos_q[:, None, :, None] - pos_k[:, None, None, :]).float()
        sn = torch.einsum("bshd,bkhd->bhsk", q_nope.float(),
                          _repeat_kv(k_nope, n_rep).float()) * scale
        sn = sn - alibi.float()[None, :, None, None] * dist
        sc = torch.where(is_sum_q[:, None, :, None], sn, sc)
    mask = _decode_mask(pos_k, pos_q, window, seg_q, seg_k)
    sc = sc.masked_fill(~mask[:, None], NEG_INF)
    probs = torch.softmax(sc, dim=-1) * mask.any(dim=-1)[:, None, :, None]
    probs = probs.to(q.dtype)
    if k_scale is not None:        # fp32 values: the product is fp32
        probs = probs.float()
    return torch.einsum("bhsk,bkhd->bshd", probs,
                        _repeat_kv(v, n_rep)).to(q.dtype)


def _check(q, k, v, use_nope, q_nope, k_nope, kv_dtype):
    b, s, h, d = q.shape
    cap, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unsupported dtype {q.dtype}")
    if k.shape != (b, cap, hk, d) or v.shape[:3] != (b, cap, hk) or h % hk:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not fit")
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(
            f"head dims {d}/{dv} exceed the GQA mode's {MAX_HEAD_DIM}: "
            "absorbed MLA on the latent cache takes decode_attention_mla")
    _check_q(q, q_nope if use_nope else None)
    for t in [k, v] + ([k_nope] if k_nope is not None else []):
        if (t.dtype != kv_dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"k/v/k_nope must be {kv_dtype}, on q's device "
                             "and contiguous")
    if k_nope is not None and k_nope.shape != k.shape:
        raise ValueError("k_nope must have the shape of k")


def _check_q(q, q_nope):
    for t in [q] + ([q_nope] if q_nope is not None else []):
        if t.dtype != q.dtype or t.device != q.device or not t.is_contiguous():
            raise ValueError("q/q_nope must share q's dtype and device and "
                             "be contiguous")
    if q_nope is not None and q_nope.shape != q.shape:
        raise ValueError("q_nope must have the shape of q")


def _ints(pos_q, pos_k, is_sum_q, use_nope, seg_q, seg_k, use_seg):
    """int32 (the [SUM] flags: bool) copies of the index and flag operands,
    held until the launch is enqueued (a freed copy's memory could be
    handed to the next one); no copy where they already are."""
    on = lambda t, use: as_i32(t) if use else None
    return [as_i32(pos_q), as_i32(pos_k),
            is_sum_q.to(torch.bool).contiguous() if use_nope else None,
            on(seg_q, use_seg), on(seg_k, use_seg)]


def decode_attention(q, k, v, pos_q, pos_k, *, window: int, is_sum_q=None,
                     q_nope=None, k_nope=None, alibi=None, seg_q=None,
                     seg_k=None, scale: Optional[float] = None, k_scale=None,
                     v_scale=None, rope_start: int = 0,
                     rope_theta: float = 10000.0) -> torch.Tensor:
    """Fused burst attention into the cache -> (B, s, H, Dv); on the card
    head dims up to ``MAX_HEAD_DIM`` (the GQA mode)."""
    use_nope = q_nope is not None and is_sum_q is not None
    use_seg = seg_q is not None and seg_k is not None
    quant = k_scale is not None
    if quant and (v_scale is None or k_nope is not None):
        raise ValueError("the int8 mode needs k_scale and v_scale together "
                         "and derives the NoPE stream from the codes "
                         "(k_nope must be None)")
    kw = dict(window=window, is_sum_q=is_sum_q if use_nope else None,
              q_nope=q_nope if use_nope else None,
              k_nope=k_nope if use_nope else None,
              alibi=alibi if use_nope else None,
              seg_q=seg_q if use_seg else None,
              seg_k=seg_k if use_seg else None, scale=scale)
    if quant:
        kw.update(k_scale=k_scale, v_scale=v_scale, rope_start=rope_start,
                  rope_theta=rope_theta)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, pos_q, pos_k, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")

    b, s, h, d = q.shape
    cap, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    _check(q, k, v, use_nope, q_nope, kw["k_nope"],
           torch.int8 if quant else q.dtype)
    if scale is None:
        scale = d ** -0.5
    o = torch.empty((b, s, h, dv), dtype=q.dtype, device=q.device)
    alibi_f = (alibi.float().contiguous() if use_nope
               else torch.zeros(h, dtype=torch.float32, device=q.device))
    ints = _ints(pos_q, pos_k, is_sum_q, use_nope, seg_q, seg_k, use_seg)
    plan = decode_split_plan(b, s, h, hk, cap, sm_count(q.device), dv)
    ws = split_workspace(plan, q.device)
    split = (plan.n_rb, plan.n_split, plan.span)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = load("decode_attn", _ARGTYPES)
    if not quant:
        rc = lib.decode_attn_fwd(
            ptr(q), ptr(q_nope if use_nope else None), ptr(k),
            ptr(k_nope if use_nope else None), ptr(v), ptr(alibi_f),
            *map(ptr, ints), ptr(o), ptr(ws),
            b, s, h, hk, cap, d, dv, int(window), int(use_nope),
            int(use_seg), int(q.dtype == torch.bfloat16), *split,
            float(scale), stream)
        check_launch("decode_attn", rc)
        return o

    g = k_scale.shape[-1]
    if (k_scale.shape != (b, cap, hk, g) or g not in (1, 2)
            or v_scale.shape != (b, cap, hk)):
        raise ValueError(f"scales k {tuple(k_scale.shape)} v "
                         f"{tuple(v_scale.shape)} do not fit k "
                         f"{tuple(k.shape)}")
    if not 0 <= rope_start < d or (d - rope_start) % 2:
        raise ValueError(f"rope_start {rope_start} must leave an even span "
                         f"of the head dim {d}")
    ks = k_scale.float().contiguous()
    vs = v_scale.float().contiguous()
    rinv = rope_freqs(d - rope_start, rope_theta, q.device)
    rc = lib.decode_attn_q8_fwd(
        ptr(q), ptr(q_nope if use_nope else None), ptr(k), ptr(v), ptr(ks),
        ptr(vs), ptr(rinv), ptr(alibi_f), *map(ptr, ints), ptr(o), ptr(ws),
        b, s, h, hk, cap, d, dv, g, int(rope_start), int(window),
        int(use_nope), int(use_seg), int(q.dtype == torch.bfloat16), *split,
        float(scale), stream)
    check_launch("decode_attn_q8", rc)
    return o


def decode_attention_mla_plain(q, ckv, kpe, pos_q, pos_k, *, window: int,
                               kpe_rope=None, is_sum_q=None, q_nope=None,
                               alibi=None, seg_q=None, seg_k=None,
                               scale: Optional[float] = None, ckv_scale=None,
                               kpe_scale=None,
                               rope_theta: float = 10000.0) -> torch.Tensor:
    """Plain version of ``decode_attention_mla``: one call of
    ``decode_attention_plain`` on the operands the engine built before the
    MLA mode read the cache in place. bf16/fp32: K = [ckv | kpe_rope],
    V = ckv, K_nope = [ckv | kpe]; int8: K = the codes [ckv | kpe] with two
    scale groups split at r (``ckv_scale``, ``kpe_scale``), V = the ckv
    codes with ``ckv_scale``."""
    r = ckv.shape[-1]
    nope = q_nope is not None and is_sum_q is not None
    kw = dict(window=window, is_sum_q=is_sum_q, q_nope=q_nope, alibi=alibi,
              seg_q=seg_q, seg_k=seg_k, scale=scale)
    if ckv_scale is not None:
        return decode_attention_plain(
            q, torch.cat([ckv, kpe], dim=-1)[:, :, None], ckv[:, :, None],
            pos_q, pos_k,
            k_scale=torch.stack([ckv_scale, kpe_scale], dim=-1)[:, :, None],
            v_scale=ckv_scale[:, :, None], rope_start=r,
            rope_theta=rope_theta, **kw)
    return decode_attention_plain(
        q, torch.cat([ckv, kpe_rope], dim=-1)[:, :, None], ckv[:, :, None],
        pos_q, pos_k,
        k_nope=torch.cat([ckv, kpe], dim=-1)[:, :, None] if nope else None,
        **kw)


def _check_mla(q, ckv, kpe, kpe_rope, quant, use_nope, ckv_scale,
               kpe_scale):
    b, s, h, d = q.shape
    cap, r = ckv.shape[1], ckv.shape[-1]
    dr = d - r
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unsupported dtype {q.dtype}")
    mla_geometry(r, dr)
    kv_dtype = torch.int8 if quant else q.dtype
    spans = ([kpe] if quant or use_nope else []) + (
        [] if quant else [kpe_rope])
    if ckv.shape != (b, cap, r) or any(t is None or t.shape != (b, cap, dr)
                                       for t in spans):
        raise ValueError(f"shapes q {tuple(q.shape)} ckv {tuple(ckv.shape)} "
                         "and the rope spans (B, cap, Dqk - r) do not fit")
    for t in [ckv] + spans:
        if (t.dtype != kv_dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"ckv/kpe/kpe_rope must be {kv_dtype}, on q's "
                             "device and contiguous")
    if quant and (kpe_rope is not None or kpe_scale is None
                  or ckv_scale.shape != (b, cap)
                  or kpe_scale.shape != (b, cap)):
        raise ValueError("the int8 mode takes ckv_scale and kpe_scale (B, "
                         "cap) and ropes the kpe codes itself (kpe_rope must "
                         "be None)")


def decode_attention_mla(q, ckv, kpe, pos_q, pos_k, *, window: int,
                         kpe_rope=None, is_sum_q=None, q_nope=None,
                         alibi=None, seg_q=None, seg_k=None,
                         scale: Optional[float] = None, ckv_scale=None,
                         kpe_scale=None,
                         rope_theta: float = 10000.0) -> torch.Tensor:
    """Absorbed-MLA burst attention into the latent cache, read in place ->
    (B, s, H, r).

    ``q`` (and ``q_nope``, for [SUM] rows) ``(B, s, H, r + dr)``;
    ``ckv (B, cap, r)`` the latent and the values; bf16/fp32: ``kpe_rope``
    (roped, ordinary rows) and ``kpe`` (unroped, [SUM] rows; may be None
    without the NoPE stream) ``(B, cap, dr)``; int8: ``ckv``, ``kpe`` codes
    with ``ckv_scale``, ``kpe_scale (B, cap)``, roped inside the kernel
    from ``rope_theta``. The rest as ``decode_attention``."""
    use_nope = q_nope is not None and is_sum_q is not None
    use_seg = seg_q is not None and seg_k is not None
    quant = ckv_scale is not None
    kw = dict(window=window, kpe_rope=kpe_rope,
              is_sum_q=is_sum_q if use_nope else None,
              q_nope=q_nope if use_nope else None,
              alibi=alibi if use_nope else None,
              seg_q=seg_q if use_seg else None,
              seg_k=seg_k if use_seg else None, scale=scale,
              ckv_scale=ckv_scale, kpe_scale=kpe_scale,
              rope_theta=rope_theta)
    if q.device.type == "cpu":
        return decode_attention_mla_plain(q, ckv, kpe, pos_q, pos_k, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")

    _check_mla(q, ckv, kpe, kpe_rope, quant, use_nope, ckv_scale, kpe_scale)
    _check_q(q, q_nope if use_nope else None)
    b, s, h, d = q.shape
    cap, r = ckv.shape[1], ckv.shape[2]
    if scale is None:
        scale = d ** -0.5
    o = torch.empty((b, s, h, r), dtype=q.dtype, device=q.device)
    alibi_f = (alibi.float().contiguous() if use_nope
               else torch.zeros(h, dtype=torch.float32, device=q.device))
    ints = _ints(pos_q, pos_k, is_sum_q, use_nope, seg_q, seg_k, use_seg)
    dr = d - r
    plan = mla_split_plan(b, s, h, cap, sm_count(q.device), r, dr)
    ws = split_workspace(plan, q.device)
    is_bf16 = q.dtype == torch.bfloat16
    key = MLA_KEYS[mla_geometry(r, dr)]
    tail = (b, s, h, cap, r, dr, int(window), int(use_nope), int(use_seg),
            int(is_bf16), plan.n_rb, plan.n_split, plan.span,
            mla_smem_bytes(is_bf16, quant, use_nope, s, h, r, dr),
            float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    lib = load("decode_attn", _ARGTYPES)
    qn = ptr(q_nope if use_nope else None)
    kpe_p = ptr(kpe if quant or use_nope else None)
    if not quant:
        rc = lib.decode_attn_mla_fwd(
            ptr(q), qn, ptr(ckv), ptr(kpe_rope), kpe_p, ptr(alibi_f),
            *map(ptr, ints), ptr(o), ptr(ws), *tail)
        check_launch(key, rc)
        return o
    cs = ckv_scale.float().contiguous()
    ps = kpe_scale.float().contiguous()
    rinv = rope_freqs(d - r, rope_theta, q.device)
    rc = lib.decode_attn_mla_q8_fwd(
        ptr(q), qn, ptr(ckv), kpe_p, ptr(cs), ptr(ps), ptr(rinv),
        ptr(alibi_f), *map(ptr, ints), ptr(o), ptr(ws), *tail)
    check_launch(key + "_q8", rc)
    return o


__all__ = ["SplitPlan", "decode_attention", "decode_attention_mla",
           "decode_attention_mla_plain", "decode_attention_plain",
           "decode_split_plan", "mla_ctas_per_sm", "mla_geometry",
           "mla_smem_bytes", "mla_split_plan", "split_workspace"]
