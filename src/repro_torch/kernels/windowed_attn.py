"""Windowed DTI attention: the CUDA kernels' wrappers and plain versions.

Replaces the Pallas TPU kernel ``repro.kernels.windowed_attn.windowed_attn``
(``_kernel``, launched by ``windowed_attention_fwd_bhsd``) with
``csrc/windowed_attn.cu``. Same public layout as
``repro.kernels.windowed_attn.ops.windowed_attention``: q ``(B, S, H, Dqk)``,
k ``(B, S, Hk, Dqk)``, v ``(B, S, Hk, Dv)`` -> o ``(B, S, H, Dv)`` in q's
dtype, plus the fp32 row logsumexp ``(B, H, S)`` (``+1e30`` on rows with no
key) when ``return_lse`` is set. The kernel reads this layout in place: no
transpose, and no copy of K/V per query head (GQA maps head h to kv head
h // n_rep).

The kernel multiplies on tensor cores (``mma.sync``, bf16 operands, fp32
sums; fp32 inputs as sums of three bf16 terms) over kv tiles that
``cp.async`` stages ahead of the products. Its cost is operations: 2 (Dqk
+ Dv) FLOPs per attended (query, key) pair and head, 0.2054 TFLOP at
dti-llama's prefill shape (B=8, S=2048, H=32, Hk=8, D=128, window 1024).
``windowed_tile_plan`` holds the host side of its design: the tile sizes,
the grid, the stages and the shared memory it launches with, and the kv
band each q tile walks. The C entry point refuses a plan it would not make.
It takes q/k head dims up to ``MAX_QK_DIM`` (192) in two classes, up to
128 (launch key ``"windowed_attn"``) and up to 192 (deepseek-v2's 128 +
64; ``"windowed_attn_192"``, q and K planes 200 values wide), and value
head dims up to ``MAX_HEAD_DIM`` (128).

Schedule contract (as the reference's): the band of kv tiles a q tile
visits is physical (rows within ``window`` of the tile), the mask is
positional. The two agree because physical distance equals positional
distance on every attendable pair, which is why shared-prefix rows stay on
the dense path (``repro_torch.core.windowed.attention``).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises, for the forward and, when an operand asks for a gradient, for the
backward: a ``torch.autograd.Function`` pairs kernel 1 with the dq and
dk/dv kernels of ``csrc/windowed_attn_bwd.cu`` (the reference's
``windowed_attn_bwd._dq_kernel`` and ``_dkv_kernel``), which recompute
``p = exp(s - lse)`` from the saved row logsumexp and multiply on tensor
cores as kernel 1 does (dS, P as hi + lo bf16 pairs). Their cost is
operations too: 2 (2 Dqk + Dv) FLOPs per attended pair and head for dq,
2 (2 Dqk + 2 Dv) for dk/dv. ``windowed_bwd_plan`` holds their host side:
the dq pass is one CTA per (head, q tile of 64 rows, batch row) over the
forward's kv band (``kv_band``); the dk/dv pass one CTA per (kv tile of
64 keys, kv head, batch row) over the q tiles of 32 rows of the
transposed band (``q_band``), for each query head of its group, in two
phases: dK and dV over the whole band, then dK_nope and dV0 over the q
tiles that hold a [SUM] row (``sum_tiles``). The wrapper computes
delta = <do, o> (``_delta``), as the reference does outside its kernels.
The backward takes the forward's two head-dim classes: up to 128
(``"windowed_attn_dq"``, ``"windowed_attn_dkv"``) and up to ``MAX_QK_DIM``
(``"windowed_attn_dq_192"``, ``"windowed_attn_dkv_192"``: q, K, q_nope and
K_nope planes 200 values wide, V's, V0's and dO's 136, the gradient
columns past 128 accumulated in shared memory, one CTA per SM, and in fp32
a dq CTA of 2 warps). A q/k head dim past ``MAX_QK_DIM`` raises before any
launch.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import as_i32, check_launch, load, ptr
from repro_torch.core.windowed import ResetConfig, attention_dense

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {"windowed_attn_fwd": [_P] * 16 + [_I] * 14 + [_F] * 4 + [_P]}
_BWD_ARGTYPES = {fn: [_P] * 21 + [_I] * 14 + [_F] * 4 + [_P]
                 for fn in ("windowed_attn_dq", "windowed_attn_dkv")}
MAX_HEAD_DIM = 128   # value head dims; the narrow class's q/k head dims
MAX_QK_DIM = 192     # q/k head dims of the wide class (DWIDE in the sources)
# csrc/windowed_attn.cu's tiles: warps per CTA, keys per kv tile, the
# bf16 plane row stride (of V, and of q and K up to 128), int words per
# staged slot
WARPS, BLOCK_K = 4, 32
PLANE_LD = MAX_HEAD_DIM + 8
META_WORDS = 4
SMEM_LIMIT = 232448          # bytes of shared memory one CTA may use (H100)
# csrc/windowed_attn_bwd.cu's tiles: query rows per q tile of the dk/dv
# pass, int words per staged query row, q tiles phase B's table holds
BWD_Q_TILE, Q_META_WORDS, BAND_TABLE = 32, 5, 256


class TilePlan(NamedTuple):
    """How kernel 1 runs one call: ``grid`` = (H, q tiles, B) CTAs of
    ``warps`` warps, each a q tile of ``block_q`` rows (``block_q / warps``
    per warp) walking kv tiles of ``block_k`` keys through ``stages``
    shared-memory stages of ``stage_bytes`` each; ``smem_bytes`` in all.
    ``terms`` = bf16 terms of (q, K, P, V) in the products."""
    block_q: int
    block_k: int
    warps: int
    terms: Tuple[int, int, int, int]
    stages: int
    stage_bytes: int
    smem_bytes: int
    grid: Tuple[int, int, int]


def qk_plane_ld(d: int) -> int:
    """The row stride of the q and K planes for q/k head dim ``d``: its
    head-dim class (128 or ``MAX_QK_DIM``) + 8."""
    if not 0 < d <= MAX_QK_DIM:
        raise ValueError(f"q/k head dim {d} exceeds {MAX_QK_DIM}")
    return (MAX_HEAD_DIM if d <= MAX_HEAD_DIM else MAX_QK_DIM) + 8


def windowed_tile_plan(b: int, s: int, h: int, *, bf16: bool,
                       use_nope: bool, use_reset: bool,
                       d: int = MAX_HEAD_DIM) -> TilePlan:
    """The plan ``csrc/windowed_attn.cu`` launches with (its ``Cfg``) for
    q/k head dim ``d``. bf16: one term for q and K, two for P, one for V;
    32 rows a warp (two m-tiles share each K/V fragment), 16 with the
    reset stream (whose registers would spill); three stages of K and V,
    two when K_nope or V0 is live too, so that two CTAs fit an SM at head
    dims up to 128. fp32: 16 rows a warp, three terms each, converted from
    memory into one stage. V planes are padded to ``MAX_HEAD_DIM``, the q
    and K planes to their head-dim class (``qk_plane_ld``), whatever the
    head dims."""
    mt = 2 if bf16 and not use_reset else 1
    block_q = WARPS * 16 * mt
    nq, nk, np_, nv = (1, 1, 2, 1) if bf16 else (3, 3, 3, 3)
    kplanes = nk * (1 + use_nope)
    planes = kplanes + nv * (1 + use_reset)
    stages = (3 if planes <= 2 else 2) if bf16 else 1
    ring = max(stages, 2)
    ldq = qk_plane_ld(d)
    stage = BLOCK_K * 2 * (kplanes * ldq + (planes - kplanes) * PLANE_LD)
    smem = (nq * block_q * ldq * 2 + stages * stage
            + (ring * META_WORDS * BLOCK_K + 3 * block_q + block_q // 8
               + ring) * 4)
    return TilePlan(block_q, BLOCK_K, WARPS, (nq, nk, np_, nv), stages,
                    stage, smem, (h, -(-s // block_q), b))


def tile_of_block(plan: TilePlan, x: int, y: int, z: int):
    """The (batch row, head, first query row) of CTA ``(x, y, z)``: q
    tiles run last first, the longest bands before the shortest."""
    return z, x, (plan.grid[1] - 1 - y) * plan.block_q


def kv_band(q0: int, s: int, window: int, block_q: int,
            block_k: int = BLOCK_K) -> Tuple[int, int]:
    """Key rows ``[lo, hi)`` of the kv tiles the q tile from row ``q0``
    walks: whole tiles holding rows ``[q0 - window, q0 + block_q - 1]``,
    cut at ``s``."""
    last = min(q0 + block_q, s) - 1
    lo = max(q0 - window, 0) // block_k * block_k
    return lo, min((last // block_k + 1) * block_k, s)


class BwdPlan(NamedTuple):
    """How one pass of kernels 2 and 3 runs: ``grid`` CTAs of ``warps``
    warps (16 rows each), each owning ``block_rows`` rows (dq: query rows;
    dk/dv: keys) and walking tiles of ``block_cols`` (dq: keys; dk/dv:
    query rows) through ``stages`` shared-memory stages of
    ``stage_bytes`` each; ``smem_bytes`` in all, ``ctas_per_sm`` CTAs on
    an SM. ``terms`` = bf16 terms of (each operand, P and dS)."""
    block_rows: int
    block_cols: int
    warps: int
    terms: Tuple[int, int]
    stages: int
    stage_bytes: int
    smem_bytes: int
    ctas_per_sm: int
    grid: Tuple[int, int, int]


def windowed_bwd_plan(b: int, s: int, h: int, hk: int, *, bf16: bool,
                      use_nope: bool, use_reset: bool,
                      d: int = MAX_HEAD_DIM) -> Tuple[BwdPlan, BwdPlan]:
    """The plans ``csrc/windowed_attn_bwd.cu`` launches its dq and dk/dv
    passes with (its ``DqCfg`` and ``DkvCfg``) for q/k head dim ``d``.
    bf16: one term for every operand, two for P and dS; fp32: three each,
    one stage, converted from memory. dq: 4 warps of 16 query rows over kv
    tiles of ``BLOCK_K`` keys (K, K_nope, V, V0 planes a stage), Q and dO
    staged once; three stages when only K and V are live, else two. dk/dv:
    16 keys a warp (4 warps; 2 in fp32) whose K, K_nope, V, V0 are staged
    once, over q tiles of ``BWD_Q_TILE`` rows (Q and dO planes a stage, and
    each row's five words of position, [SUM], segment, lse, delta); three
    stages when at most three key planes are live. The q, K, q_nope and
    K_nope planes are padded to their head-dim class (``qk_plane_ld``), V,
    V0 and dO to ``MAX_HEAD_DIM``. The 128 class fits two bf16 CTAs (8
    warps) on an SM. The wide class keeps a thread's fragments of the
    gradient columns past 128 (dQ; dK or dK_nope) in shared memory, 32
    floats a thread, and runs one CTA per SM; its fp32 dq pass takes 2
    warps (32 query rows), or a CTA would pass ``SMEM_LIMIT`` with NoPE."""
    ldq = qk_plane_ld(d)
    wide = ldq > PLANE_LD
    nt, np_ = (1, 2) if bf16 else (3, 3)
    kpl = nt * (1 + use_nope)                   # K, K_nope: ldq wide
    planes = nt * (2 + use_nope + use_reset)
    per_sm = 2 if bf16 and not wide else 1
    xs = (ldq - PLANE_LD) // 8 * 4              # floats a thread, past 128
    warps = 2 if wide and not bf16 else WARPS
    bq = 16 * warps
    stages = (3 if planes <= 2 else 2) if bf16 else 1
    ring = max(stages, 2)
    stage = BLOCK_K * 2 * (kpl * ldq + (planes - kpl) * PLANE_LD)
    smem = (nt * bq * (ldq + PLANE_LD) * 2 + stages * stage
            + (ring * META_WORDS * BLOCK_K + 5 * bq + bq // 8 + ring
               + xs * 32 * warps) * 4)
    dq = BwdPlan(bq, BLOCK_K, warps, (nt, np_), stages, stage, smem, per_sm,
                 (h, -(-s // bq), b))
    warps = WARPS if bf16 else 2
    bkv = 16 * warps
    stages = (3 if planes <= 3 else 2) if bf16 else 1
    ring = max(stages, 2)
    stage = nt * BWD_Q_TILE * (ldq + PLANE_LD) * 2
    smem = (bkv * (kpl * ldq + (planes - kpl) * PLANE_LD) * 2
            + stages * stage
            + (ring * Q_META_WORDS * BWD_Q_TILE + ring + 8 * warps
               + BAND_TABLE // 4 + BAND_TABLE // 2 + 1 + xs * 32 * warps) * 4)
    dkv = BwdPlan(bkv, BWD_Q_TILE, warps, (nt, np_), stages, stage, smem,
                  per_sm, (-(-s // bkv), hk, b))
    return dq, dkv


def dq_block(plan: BwdPlan, x: int, y: int, z: int):
    """The (batch row, head, first query row) of dq CTA ``(x, y, z)``: q
    tiles run last first."""
    return z, x, (plan.grid[1] - 1 - y) * plan.block_rows


def dkv_block(plan: BwdPlan, x: int, y: int, z: int):
    """The (batch row, kv head, first key) of dk/dv CTA ``(x, y, z)``."""
    return z, y, x * plan.block_rows


def q_band(k0: int, s: int, window: int, block_k: int,
           block_q: int = BWD_Q_TILE) -> Tuple[int, int]:
    """Query rows ``[lo, hi)`` of the q tiles the dk/dv CTA from key ``k0``
    walks: whole tiles holding rows ``[k0, k0 + block_k - 1 + window]``,
    cut at ``s``."""
    last = min(k0 + block_k - 1 + window, s - 1)
    return k0 // block_q * block_q, min((last // block_q + 1) * block_q, s)


def sum_tiles(is_sum_row, k0: int, s: int, window: int, block_k: int,
              block_q: int = BWD_Q_TILE):
    """First rows of the q tiles phase B of the dk/dv CTA from key ``k0``
    revisits: those of its band holding a [SUM] row (``is_sum_row``, one
    flag per row of the batch row), as the kernel's table lists them; a
    band of more than ``BAND_TABLE`` tiles revisits every tile."""
    lo, hi = q_band(k0, s, window, block_k, block_q)
    firsts = list(range(lo, hi, block_q))
    if len(firsts) > BAND_TABLE:
        return firsts
    return [q0 for q0 in firsts if any(is_sum_row[q0:q0 + block_q])]


def windowed_attention_plain(q, k, v, *, pos_q, pos_k, window: int,
                             is_sum_q=None, is_sum_k=None, valid_k=None,
                             seg_q=None, seg_k=None, q_nope=None,
                             k_nope=None, alibi=None, v0=None,
                             reset: Optional[ResetConfig] = None,
                             sum_isolated: bool = True,
                             scale: Optional[float] = None):
    """Plain PyTorch version of the kernel: returns ``(o, lse)``."""
    use_nope = q_nope is not None and is_sum_q is not None
    use_reset = reset is not None and v0 is not None
    return attention_dense(
        q, k, v, pos_q=pos_q, pos_k=pos_k, window=window, is_sum_q=is_sum_q,
        is_sum_k=is_sum_k, valid_k=valid_k, seg_q=seg_q, seg_k=seg_k,
        q_nope=q_nope if use_nope else None,
        k_nope=k_nope if use_nope else None,
        alibi=alibi if use_nope else None,
        v0=v0 if use_reset else None, reset=reset if use_reset else None,
        sum_isolated=sum_isolated and is_sum_k is not None, scale=scale,
        return_lse=True)


def windowed_attention(q, k, v, *, pos_q, pos_k, window: int,
                       is_sum_q=None, is_sum_k=None, valid_k=None,
                       seg_q=None, seg_k=None, q_nope=None, k_nope=None,
                       alibi=None, v0=None,
                       reset: Optional[ResetConfig] = None,
                       sum_isolated: bool = True,
                       scale: Optional[float] = None,
                       return_lse: bool = False):
    """Windowed DTI attention; ``(o, lse)`` when ``return_lse``, else o."""
    if window <= 0:
        raise ValueError("the windowed kernel needs a window > 0")
    kw = dict(pos_q=pos_q, pos_k=pos_k, window=window, is_sum_q=is_sum_q,
              is_sum_k=is_sum_k, valid_k=valid_k, seg_q=seg_q, seg_k=seg_k,
              q_nope=q_nope, k_nope=k_nope, alibi=alibi, v0=v0, reset=reset,
              sum_isolated=sum_isolated, scale=scale)
    if q.device.type == "cpu":
        o, lse = windowed_attention_plain(q, k, v, **kw)
        return (o, lse) if return_lse else o
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    o, lse = _launch(q, k, v, **kw)
    return (o, lse) if return_lse else o


@dataclasses.dataclass(frozen=True)
class _Statics:
    """Shapes and flags of one call, shared by the forward and both
    backward launches."""
    b: int
    s: int
    h: int
    hk: int
    d: int
    dv: int
    window: int
    use_nope: bool
    use_reset: bool
    sum_isolated: bool
    use_seg: bool
    scale: float
    y_min: float
    y_max: float
    midpoint: float

    def ints(self, is_bf16: bool):
        return (self.b, self.s, self.h, self.hk, self.d, self.dv,
                self.window, int(self.use_nope), int(self.use_reset),
                int(self.sum_isolated), int(self.use_seg), int(is_bf16))

    def floats(self):
        return (float(self.scale), float(self.y_min), float(self.y_max),
                float(self.midpoint))


def _prepare(q, k, v, *, pos_q, pos_k, window, is_sum_q, is_sum_k, valid_k,
             seg_q, seg_k, q_nope, k_nope, alibi, v0, reset, sum_isolated,
             scale):
    """Check what the kernels take; return the statics, the live float
    operands (q_nope, k_nope, v0 or None), the fp32 ALiBi slopes and the
    int32 index operands (pos_q, pos_k, sum_q, sum_k, valid_k, seg_q,
    seg_k; None where switched off)."""
    b, s, h, d = q.shape
    hk, dv = k.shape[2], v.shape[3]
    use_nope = q_nope is not None and is_sum_q is not None
    use_reset = reset is not None and v0 is not None
    use_seg = seg_q is not None and seg_k is not None
    sum_isolated = sum_isolated and is_sum_k is not None
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unsupported dtype {q.dtype}")
    if k.shape != (b, s, hk, d) or v.shape[:3] != (b, s, hk) or h % hk:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not fit (self-attention, "
                         "H a multiple of Hk)")
    if d > MAX_QK_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"head dims {d}/{dv} exceed {MAX_QK_DIM}/"
                         f"{MAX_HEAD_DIM}")
    live = (q_nope if use_nope else None, k_nope if use_nope else None,
            v0 if use_reset else None)
    for t in (q, k, v) + live:
        if t is not None and (t.dtype != q.dtype or t.device != q.device
                              or not t.is_contiguous()):
            raise ValueError("q/k/v/q_nope/k_nope/v0 must share q's dtype and "
                             "device and be contiguous")
    if use_nope and (q_nope.shape != q.shape or k_nope.shape != k.shape):
        raise ValueError("q_nope/k_nope must have the shapes of q/k")
    if use_reset and v0.shape != v.shape:
        raise ValueError("v0 must have the shape of v")
    st = _Statics(b, s, h, hk, d, dv, int(window), use_nope, use_reset,
                  sum_isolated, use_seg, d ** -0.5 if scale is None else scale,
                  *((reset.y_min, reset.y_max, reset.midpoint) if use_reset
                    else (0.0, 0.0, 0.0)))
    # int32 copies of the index/flag operands: the caller holds them until
    # the launches are enqueued (a freed copy's memory could be handed to
    # the next one), and the autograd Function saves them for the backward
    on = lambda t, use: as_i32(t) if use else None
    ints = (as_i32(pos_q), as_i32(pos_k), on(is_sum_q, use_nope or use_reset),
            on(is_sum_k, sum_isolated), as_i32(valid_k), on(seg_q, use_seg),
            on(seg_k, use_seg))
    alibi_f = (alibi.float().contiguous() if use_nope and alibi is not None
               else torch.zeros(h, dtype=torch.float32, device=q.device))
    return st, live, alibi_f, ints


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_key(name: str, d: int) -> str:
    """The launch key kernel ``name`` counts under at q/k head dim ``d``:
    ``name`` in the 128 class, ``name`` + ``"_192"`` in the wide one."""
    return name if d <= MAX_HEAD_DIM else f"{name}_192"


def _fwd(st, q, k, v, live, alibi_f, ints):
    qn, kn, v0 = live
    o = torch.empty((st.b, st.s, st.h, st.dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((st.b, st.h, st.s), dtype=torch.float32,
                      device=q.device)
    bf16 = q.dtype == torch.bfloat16
    plan = windowed_tile_plan(st.b, st.s, st.h, bf16=bf16,
                              use_nope=st.use_nope, use_reset=st.use_reset,
                              d=st.d)
    lib = load("windowed_attn", _ARGTYPES)
    rc = lib.windowed_attn_fwd(
        ptr(q), ptr(qn), ptr(k), ptr(kn), ptr(v), ptr(v0), ptr(alibi_f),
        *map(ptr, ints), ptr(o), ptr(lse), *st.ints(bf16), plan.grid[1],
        plan.smem_bytes, *st.floats(), _stream(q))
    check_launch(launch_key("windowed_attn", st.d), rc)
    return o, lse


def _bwd_pass(name, st, q, k, v, live, alibi_f, ints, lse, delta, do, outs):
    """Launch ``windowed_attn_dq`` (outs: dq, dq_nope) or
    ``windowed_attn_dkv`` (outs: dk, dv, dk_nope, dv0) into ``outs``,
    counted under ``launch_key(name, st.d)``."""
    qn, kn, v0 = live
    outs = (list(outs) + [None] * 4)[:4]
    bf16 = q.dtype == torch.bfloat16
    dq_plan, dkv_plan = windowed_bwd_plan(st.b, st.s, st.h, st.hk, bf16=bf16,
                                          use_nope=st.use_nope,
                                          use_reset=st.use_reset, d=st.d)
    plan = dkv_plan if name == "windowed_attn_dkv" else dq_plan
    n_blocks = plan.grid[0] if plan is dkv_plan else plan.grid[1]
    lib = load("windowed_attn_bwd", _BWD_ARGTYPES)
    rc = getattr(lib, name)(
        ptr(q), ptr(qn), ptr(k), ptr(kn), ptr(v), ptr(v0), ptr(do), ptr(lse),
        ptr(delta), ptr(alibi_f), *map(ptr, ints), *map(ptr, outs),
        *st.ints(bf16), n_blocks, plan.smem_bytes, *st.floats(), _stream(q))
    check_launch(launch_key(name, st.d), rc)


def _delta(o, do):
    """Flash delta D_i = <do_i, o_i> in fp32, in the kernels' (B, H, S)
    layout (it holds with the reset stream too: the reset changes each
    pair's value, not the normalisation)."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd(st, q, k, v, live, alibi_f, ints, o, lse, do):
    """The dq and dk/dv kernels. Returns (dq, dk, dv, dq_nope, dk_nope,
    dv0), None for streams that are not live."""
    do = do.to(q.dtype).contiguous()
    delta = _delta(o, do)
    new = lambda t, use: torch.empty_like(t) if use else None
    dq, dqn = torch.empty_like(q), new(q, st.use_nope)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dkn, dv0 = new(k, st.use_nope), new(v, st.use_reset)
    args = (st, q, k, v, live, alibi_f, ints, lse, delta, do)
    _bwd_pass("windowed_attn_dq", *args, (dq, dqn))
    _bwd_pass("windowed_attn_dkv", *args, (dk, dv, dkn, dv0))
    return dq, dk, dv, dqn, dkn, dv0


class _WindowedAttn(torch.autograd.Function):
    """Kernel 1 forward, kernels 2 and 3 backward. Gradients flow to q, k,
    v, q_nope, k_nope and v0; positions, flags, segments and the ALiBi
    slopes (head constants, not parameters) get none, as in the
    reference's ``ops._attn_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, q_nope, k_nope, v0, st, alibi_f, ints):
        live = (q_nope, k_nope, v0)
        o, lse = _fwd(st, q, k, v, live, alibi_f, ints)
        ctx.st = st
        ctx.save_for_backward(q, k, v, *live, alibi_f, o, lse, *ints)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, qn, kn, v0, alibi_f, o, lse, *ints = ctx.saved_tensors
        grads = _bwd(ctx.st, q, k, v, (qn, kn, v0), alibi_f, ints, o, lse, do)
        return (*grads, None, None, None)


def _launch(q, k, v, **kw):
    st, live, alibi_f, ints = _prepare(q, k, v, **kw)
    return _WindowedAttn.apply(q, k, v, *live, st, alibi_f, ints)


def windowed_attention_bwd_plain(q, k, v, do, dlse=None, **kw):
    """Plain PyTorch version of kernels 2 and 3: ``torch.autograd.grad``
    of ``windowed_attention_plain``'s o against the cotangent ``do``.
    Takes the keyword arguments of ``windowed_attention_plain``; returns
    ``(dq, dk, dv, dq_nope, dk_nope, dv0)``, None for streams that are not
    live (no q_nope/k_nope without ``is_sum_q``, no v0 without ``reset``).

    ``dlse`` (fp32, (B, H, S)), when given, is a cotangent of the row
    logsumexp as well. The kernels take delta = <do, o> from kernel 1's
    output o; where o was rounded (bf16), delta is off by some e, and
    ``ds = p (dp - delta)`` moves exactly as an lse cotangent of -e moves
    it, so ``dlse = -e`` gives the plain version the kernels' delta."""
    use_nope = kw.get("q_nope") is not None and kw.get("is_sum_q") is not None
    use_reset = kw.get("reset") is not None and kw.get("v0") is not None
    leaf = lambda t: t.detach().requires_grad_(True)
    q, k, v = leaf(q), leaf(k), leaf(v)
    names = [n for n, use in (("q_nope", use_nope), ("k_nope", use_nope),
                              ("v0", use_reset)) if use]
    kw = dict(kw, **{n: leaf(kw[n]) for n in names})
    with torch.enable_grad():
        o, lse = windowed_attention_plain(q, k, v, **kw)
        outs, cots = ([o], [do]) if dlse is None else ([o, lse], [do, dlse])
        got = torch.autograd.grad(outs, [q, k, v] + [kw[n] for n in names],
                                  cots)
    extra = dict(zip(names, got[3:]))
    return (*got[:3], extra.get("q_nope"), extra.get("k_nope"),
            extra.get("v0"))


__all__ = ["windowed_attention", "windowed_attention_plain",
           "windowed_attention_bwd_plain", "windowed_tile_plan", "TilePlan",
           "qk_plane_ld",
           "tile_of_block", "kv_band", "windowed_bwd_plan", "BwdPlan",
           "dq_block", "dkv_block", "q_band", "sum_tiles"]
