// Windowed DTI attention forward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/windowed_attn/windowed_attn.py, `_kernel`
// (launched by `windowed_attention_fwd_bhsd`), the Pallas TPU kernel.
//
// Computes, for every query row, a banded flash-attention forward with an
// online softmax: causal + window + key-padding + [SUM]-isolation + packed-
// segment masks by index arithmetic; [SUM] rows score a second NoPE stream
// (q_nope . k_nope) minus ALiBi * distance; the optional hidden-state reset
// adds a(d) * (v0 - v) on [SUM] rows into the same accumulator. Writes o in
// the input dtype and the fp32 row logsumexp, +1e30 on rows with no key.
//
// What bounds it on this card: operations. At dti-llama prefill (B=8,
// S=2048, H=32, Hk=8, D=128, window 1024, a [SUM] row every ~200 tokens)
// the attended pairs need 2 (D + Dv) FLOPs each per head, 0.2054 TFLOP per
// call (0.208 ms at 989 TFLOP/s), against ~0.3 GB of operands that must
// move: far above the ~295 FLOP/byte ridge. So the products go to the
// tensor cores. The design:
//
// * Tiles. One CTA of 4 warps per (q tile, head, batch row). In bf16 each
//   warp takes 32 query rows as two 16-row m-tiles that share every K and
//   V fragment (q tile of 128 rows); with the reset stream, whose
//   registers would spill at 32 rows, and in fp32, 16 rows (q tile of 64).
//   The CTA walks the physical band of kv tiles of 32 keys that hold rows
//   [q0 - window, q0 + BQ - 1] (the mask is positional: the two agree
//   because physical distance equals positional distance on every
//   attendable pair). blockIdx.x is the head, so the heads of one kv head
//   read the same K/V tiles side by side, from L2; q tiles run last first,
//   the longest bands before the short ones. `windowed_tile_plan` in
//   `windowed_attn.py` computes the grid, the stages and the shared memory
//   this source computes, and the entry point refuses a plan that differs.
// * Tensor-core products. Q.K^T and P.V are mma.sync m16n8k16 (bf16 in,
//   fp32 accumulate), fragments by ldmatrix from bf16 planes whose rows are
//   padded to 136 values (conflict-free). An operand that is not exact in
//   bf16 is split into a sum of bf16 terms (x = hi + lo [+ lo2], each term
//   the bf16 rounding of what the previous ones left) and the products of
//   the leading term pairs are accumulated: bf16 q and K are one term each
//   (their products are exact in fp32); P is two terms (~2^-17 of p; one
//   bf16 term, ~2^-9 of each product, breaks the bf16 gate of chip_smoke.py
//   at the prefill shape); the fp32 instantiation splits q, K, P and V into
//   three terms each and takes the six leading term pairs, an error ~2^-24
//   of each product (no TF32). The softmax runs in base 2 (scores times
//   log2 e, ex2.approx) with m, l and the accumulator in registers; lse =
//   m ln 2 + log l, +1e30 (and o = 0) on rows with no key.
// * [SUM] rows. Their q tile rows hold q_nope, so one Q plane serves both
//   streams. An m-tile whose 16 rows hold a [SUM] row accumulates two
//   products into one score tile: Q.K^T with its [SUM] rows' A fragments
//   zeroed, and Q.Kn^T with its ordinary rows' zeroed; other m-tiles
//   compute one product, and K_nope is copied only for q tiles that hold a
//   [SUM] row.
// * Reset. On [SUM] rows acc += (P - P a(d)) . V + (P a(d)) . V0, both
//   operands exact bf16 (V0 - V rounded to bf16 would not be); a(d) and the
//   second product only in m-tiles that hold a [SUM] row, V0 copied only
//   for q tiles that hold one.
// * Overlap and skipping. Each kv tile (K, V, and K_nope / V0 where live,
//   with its slots' positions, flags and segments) is copied by 16-byte
//   cp.async into one of 3 shared-memory stages (2 when K_nope or V0 is
//   live), ST - 1 tiles ahead of the one being computed. Each slot's owner
//   thread decides from its staged flags and position whether any row of
//   the tile may attend it (valid, within [min pos_q - window, max pos_q],
//   a [SUM] key only at a row's own position, a segment among the rows'),
//   and the tile's one barrier (__syncthreads_or) skips the products of a
//   tile the mask empties: padding, other packed segments.
// * Occupancy. bf16: 71-90 KB of shared memory and 158-255 registers
//   (nvcc -Xptxas -v, no spills), 2 CTAs (8 warps) per SM. The fp32
//   instantiation (and bf16 rows that are not 16-byte aligned) converts
//   each tile straight from memory into its term planes, one stage, 106-158
//   KB, 1 CTA per SM.
// * Head-dim classes (`Cfg`'s DQ). q/k head dims up to 128 (DMAX) and, for
//   deepseek-v2's MLA prefill (Dqk = 128 + 64, Dv 128,
//   `repro/configs/deepseek_v2_236b.py`), up to 192 (DWIDE): the q and K
//   planes' rows hold DQ + 8 values (200: conflict-free for ldmatrix too),
//   V's stay at 136; tiles, terms, stages and the loop over k-steps are
//   the same, so the 128 class is as it was. At 192 with the NoPE stream
//   a bf16 CTA takes ~120 KB: one CTA per SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WARPS = 4;            // 16 rows each
constexpr int THREADS = 32 * WARPS;
constexpr int BK = 32;              // keys per kv tile
constexpr int DMAX = 128;           // the value head dim's limit, and the narrow
                                    // class's q/k head dim's
constexpr int DWIDE = 192;          // the wide class's q/k head dim limit
constexpr int LDV = DMAX + 8;       // V planes' row stride: conflict-free fragments
constexpr int NT_S = BK / 8;        // score n-tiles per warp and tile
constexpr int KK = BK / 16;         // P.V k-steps per tile
constexpr int NT_V = DMAX / 8;      // value n-tiles
constexpr int META = 4;             // per staged slot: position, valid, [SUM], segment
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }

// Rows, terms of each operand, stages and shared memory per instantiation
// (see the header); `windowed_tile_plan` in windowed_attn.py mirrors this.
// DQ is the head-dim class of q and K (DMAX or DWIDE): their planes' rows
// hold DQ + 8 values (conflict-free for ldmatrix at both), V's DMAX + 8.
template <typename T, bool NOPE, bool RESET, int DQ>
struct Cfg {
  static constexpr int LDQ = DQ + 8;
  static constexpr bool F32 = sizeof(T) == 4;
  // 16-row m-tiles per warp: two share each K/V fragment where the
  // registers allow it (bf16 without the reset stream)
  static constexpr int MT = (F32 || RESET) ? 1 : 2;
  static constexpr int BQ = WARPS * 16 * MT;        // query rows per CTA
  static constexpr int NQ = F32 ? 3 : 1;
  static constexpr int NK = F32 ? 3 : 1;
  static constexpr int NP = F32 ? 3 : 2;
  static constexpr int NV = F32 ? 3 : 1;
  static constexpr int KPLANES = NK + (NOPE ? NK : 0);   // K, K_nope terms
  static constexpr int PLANES = KPLANES + NV + (RESET ? NV : 0);
  static constexpr int STAGES = F32 ? 1 : (PLANES <= 2 ? 3 : 2);
  static constexpr int MS = STAGES > 1 ? STAGES : 2;     // metadata ring
  static constexpr size_t Q_ELEMS = (size_t)NQ * BQ * LDQ;
  static constexpr size_t STAGE_ELEMS =
      (size_t)KPLANES * BK * LDQ + (size_t)(PLANES - KPLANES) * BK * LDV;
  static constexpr size_t BYTES = (Q_ELEMS + STAGES * STAGE_ELEMS) * sizeof(bf16) +
                                  (size_t)(MS * META * BK + 3 * BQ + BQ / 8 + MS) * sizeof(int);
};

template <int N>
__device__ __forceinline__ void split_store(float x, bf16* p, int stride) {
#pragma unroll
  for (int t = 0; t < N; ++t) {
    const bf16 h = __float2bfloat16_rn(x);
    p[t * stride] = h;
    x -= __bfloat162float(h);
  }
}

// 2^x, the hardware approximation (~2 ulp), 0 for -inf
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Not volatile: a pure function of its registers, which the compiler may
// schedule among the (volatile, program-ordered) fragment loads.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// 16 (4) bytes global -> shared; zero-filled, reading nothing, unless
// `pred`
__device__ __forceinline__ void cp16(void* dst, const void* src, bool pred) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool pred) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <typename T>
struct Args {
  const T *q, *qn, *k, *kn, *v, *v0;
  const float* alibi;
  const int *pos_q, *pos_k, *sum_q, *sum_k, *valid_k, *seg_q, *seg_k;
  T* o;
  float* lse;
  int B, S, H, Hk, D, Dv, window, sum_isolated, use_seg, n_qb, direct;
  float scale, y_min, y_max, midpoint;
};

template <typename T, bool NOPE, bool RESET, int DQ>
__global__ void __launch_bounds__(THREADS, 2)
windowed_attn_kernel(const Args<T> a) {
  using C = Cfg<T, NOPE, RESET, DQ>;
  constexpr int LDQ = C::LDQ;
  constexpr int MT = C::MT, BQ = C::BQ, NR = 2 * MT;
  constexpr int NQ = C::NQ, NK = C::NK, NP = C::NP, NV = C::NV;
  constexpr int ST = C::STAGES, MS = C::MS;
  constexpr int TQK = NQ > NK ? NQ : NK;     // term pairs i + j < TQK
  constexpr int TPV = NP > NV ? NP : NV;
  // planes of a stage: K terms, K_nope terms, V terms, V0 terms
  constexpr int PK = 0, PKN = NK, PV = NK + (NOPE ? NK : 0), PV0 = PV + NV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_p = reinterpret_cast<bf16*>(smem_raw);
  bf16* st_p = q_p + C::Q_ELEMS;
  int* meta = reinterpret_cast<int*>(st_p + ST * C::STAGE_ELEMS);
  int* pos_r = meta + MS * META * BK;
  int* sum_r = pos_r + BQ;
  int* seg_r = sum_r + BQ;
  int* red = seg_r + BQ;      // per warp of rows: least, greatest position, segment
  int* interior = red + BQ / 8;   // per ring slot: every pair of the tile attends
  // plane p of stage st: the K and K_nope terms LDQ wide, then V's LDV
  auto plane = [&](int st, int p) {
    return st_p + st * C::STAGE_ELEMS +
           (p < C::KPLANES ? (size_t)p * BK * LDQ
                           : (size_t)C::KPLANES * BK * LDQ + (size_t)(p - C::KPLANES) * BK * LDV);
  };
  // tile i's slots in ring slot i % MS: positions, flags, [SUM] flags, segments
  auto meta_of = [&](int i) { return meta + (i % MS) * META * BK; };

  const int h = blockIdx.x, iq = a.n_qb - 1 - (int)blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hk);
  const int S = a.S, D = a.D, Dv = a.Dv;
  const int q0 = iq * BQ, nr = min(BQ, S - q0);
  const int DP = (D + 15) & ~15, DVP = (Dv + 15) & ~15;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, cq = lane & 3;
  const bool direct = !C::F32 && a.direct;     // copies by cp.async

  // the q tile's rows: position, [SUM] flag, segment, and each warp's
  // least and greatest position and segment
  if (tid < BQ) {
    const bool in = tid < nr;
    const size_t bs = (size_t)b * S + q0 + tid;
    const int p = in ? a.pos_q[bs] : 0;
    const int sm = (in && a.sum_q != nullptr) ? (a.sum_q[bs] != 0) : 0;
    const int sg = (in && a.use_seg) ? a.seg_q[bs] : 0;
    pos_r[tid] = p;
    sum_r[tid] = sm;
    seg_r[tid] = sg;
    const int lo = __reduce_min_sync(FULL, in ? p : INT_MAX);
    const int hi = __reduce_max_sync(FULL, in ? p : INT_MIN);
    const int slo = __reduce_min_sync(FULL, in ? sg : INT_MAX);
    const int shi = __reduce_max_sync(FULL, in ? sg : INT_MIN);
    if (lane == 0) {
      red[4 * warp] = lo;
      red[4 * warp + 1] = hi;
      red[4 * warp + 2] = slo;
      red[4 * warp + 3] = shi;
    }
  }
  if (direct && ((D | Dv) & 15)) {   // pads cp.async never writes
    for (int i = tid; i < (int)(C::Q_ELEMS + ST * C::STAGE_ELEMS); i += THREADS)
      q_p[i] = __ushort_as_bfloat16((unsigned short)0);
  }
  const int any_sum = __syncthreads_or(tid < nr && sum_r[tid]);
  int pq_min = INT_MAX, pq_max = INT_MIN, sg_min = INT_MAX, sg_max = INT_MIN;
#pragma unroll
  for (int w = 0; w < BQ / 32; ++w) {
    pq_min = min(pq_min, red[4 * w]);
    pq_max = max(pq_max, red[4 * w + 1]);
    sg_min = min(sg_min, red[4 * w + 2]);
    sg_max = max(sg_max, red[4 * w + 3]);
  }

  // physical band: kv tiles holding rows [q0 - window, q0 + nr - 1]
  const int kb_lo = max(q0 - a.window, 0) / BK;
  const int n_t = (q0 + nr - 1) / BK - kb_lo + 1;

  // The q tile, q_nope on [SUM] rows (NoPE), zero past D and past S: by
  // cp.async in tile 0's group, or converted into NQ term planes.
  if (direct) {
    const int nch = D / 8;
    for (int idx = tid; idx < BQ * nch; idx += THREADS) {
      const int r = idx / nch, ch = idx - r * nch;
      const bool in = r < nr;
      const T* src = (NOPE && sum_r[r]) ? a.qn : a.q;
      cp16(q_p + r * LDQ + ch * 8,
           src + (((size_t)b * S + q0 + (in ? r : 0)) * a.H + h) * D + ch * 8, in);
    }
  } else {
    for (int idx = tid; idx < BQ * DP; idx += THREADS) {
      const int r = idx / DP, d = idx - r * DP;
      float x = 0.f;
      if (r < nr && d < D) {
        const T* src = (NOPE && sum_r[r]) ? a.qn : a.q;
        x = to_f(src[(((size_t)b * S + q0 + r) * a.H + h) * D + d]);
      }
      split_store<NQ>(x, q_p + r * LDQ + d, BQ * LDQ);
    }
  }

  // tile i's slot metadata: thread c < BK copies slot c's position, valid
  // flag, [SUM] flag (isolation) and segment
  auto meta_load = [&](int i, bool async) {
    if (tid >= BK) return;
    const int kj = (kb_lo + i) * BK + tid;
    const bool in = kj < S;
    const size_t bs = (size_t)b * S + (in ? kj : 0);
    int* m = meta_of(i);
    if (async) {
      cp4(m + tid, a.pos_k + bs, in);
      if (a.valid_k != nullptr) cp4(m + BK + tid, a.valid_k + bs, in);
      else m[BK + tid] = in;
      if (a.sum_isolated) cp4(m + 2 * BK + tid, a.sum_k + bs, in);
      if (a.use_seg) cp4(m + 3 * BK + tid, a.seg_k + bs, in);
    } else {
      m[tid] = in ? a.pos_k[bs] : 0;
      m[BK + tid] = in && (a.valid_k == nullptr || a.valid_k[bs] != 0);
      if (a.sum_isolated) m[2 * BK + tid] = in ? a.sum_k[bs] : 0;
      if (a.use_seg) m[3 * BK + tid] = in ? a.seg_k[bs] : 0;
    }
  };
  // The owner of slot c (warp 0), once the slot's copies have landed (its
  // own): fold the flags into one word, bit 0 an attendable key slot, bit 1
  // an isolated [SUM] key, and return whether some row of this q tile may
  // attend the slot; lane 0 records whether every row attends every slot
  // (an interior tile: valid, no isolated [SUM] key, causal and within the
  // window for all rows, one segment), whose scores need no mask.
  auto slot_live = [&](int i) {
    if (tid >= BK) return false;
    int* m = meta_of(i);
    const int kj = (kb_lo + i) * BK + tid;
    const int pk = m[tid];
    const int sk = a.sum_isolated ? (m[2 * BK + tid] != 0) : 0;
    const int f = (kj < S && m[BK + tid] != 0) ? (1 | (sk << 1)) : 0;
    m[BK + tid] = f;
    bool live = (f & 1) && pk <= pq_max && (long long)pk >= (long long)pq_min - a.window;
    if (f & 2) live = live && pk >= pq_min;
    bool all = f == 1 && pk <= pq_min && (long long)pq_max - pk <= a.window;
    if (a.use_seg) {
      const int sgk = m[3 * BK + tid];
      live = live && sgk >= sg_min && sgk <= sg_max;
      all = all && sgk == sg_min && sg_min == sg_max;
    }
    all = __all_sync(FULL, all);
    if (tid == 0) interior[i % MS] = all;
    return live;
  };
  // 16-byte copies of tile i's K, V (K_nope, V0 where a row needs them)
  // rows into stage i % ST; thread tid copies chunks tid % 16 (and, of a
  // K row of the wide class, tid % 16 + 16) of slots tid / 16 + 8 j;
  // slots past S are zero-filled without a read
  auto issue = [&](int i) {
    const int st = i % ST, k0 = (kb_lo + i) * BK;
    const int ch = tid & 15, c0 = tid >> 4;
    meta_load(i, true);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const int c = c0 + 8 * j, kj = k0 + c;
      const bool ok = kj < S;
      const size_t row = ((size_t)b * S + (ok ? kj : 0)) * a.Hk + hk;
#pragma unroll
      for (int u = 0; u < (DQ / 8 + 15) / 16; ++u) {   // K rows past 128 values
        const int cu = ch + 16 * u;
        if (cu < D / 8) {
          cp16(plane(st, PK) + c * LDQ + cu * 8, a.k + row * D + cu * 8, ok);
          if (NOPE && any_sum)
            cp16(plane(st, PKN) + c * LDQ + cu * 8, a.kn + row * D + cu * 8, ok);
        }
      }
      if (ch < Dv / 8) {
        cp16(plane(st, PV) + c * LDV + ch * 8, a.v + row * Dv + ch * 8, ok);
        if (RESET && any_sum)
          cp16(plane(st, PV0) + c * LDV + ch * 8, a.v0 + row * Dv + ch * 8, ok);
      }
    }
  };
  // the fp32 (and unaligned bf16) path: tile i's rows from memory into
  // term planes of stage i % ST, zero past D, Dv and S; a warp per slot
  auto convert = [&](int i) {
    const int st = i % ST, k0 = (kb_lo + i) * BK;
    for (int c = warp; c < BK; c += WARPS) {
      const int kj = k0 + c;
      const bool ok = kj < S;
      const size_t row = ((size_t)b * S + (ok ? kj : 0)) * a.Hk + hk;
      for (int d = lane; d < DP; d += 32) {
        const bool on = ok && d < D;
        split_store<NK>(on ? to_f(a.k[row * D + d]) : 0.f, plane(st, PK) + c * LDQ + d, BK * LDQ);
        if (NOPE && any_sum)
          split_store<NK>(on ? to_f(a.kn[row * D + d]) : 0.f, plane(st, PKN) + c * LDQ + d, BK * LDQ);
      }
      for (int d = lane; d < DVP; d += 32) {
        const bool on = ok && d < Dv;
        split_store<NV>(on ? to_f(a.v[row * Dv + d]) : 0.f, plane(st, PV) + c * LDV + d, BK * LDV);
        if (RESET && any_sum)
          split_store<NV>(on ? to_f(a.v0[row * Dv + d]) : 0.f, plane(st, PV0) + c * LDV + d, BK * LDV);
      }
    }
  };

  // this thread's rows: R = 2 mt + hh is row g + 8 hh of the warp's m-tile mt
  const int wr0 = warp * 16 * MT;
  const bool w_live = wr0 < nr;
  int pq[NR], sg[NR];
  bool rin[NR], rsum[NR];
#pragma unroll
  for (int R = 0; R < NR; ++R) {
    const int r = wr0 + 16 * (R >> 1) + g + 8 * (R & 1);
    rin[R] = r < nr;
    pq[R] = pos_r[r];
    sg[R] = seg_r[r];
    rsum[R] = sum_r[r] != 0;
  }
  // which products each m-tile's rows need: Q.K^T, and with a [SUM] row
  // Qn.Kn^T (NoPE) and P a(d).V0 (reset)
  bool m_sum[MT], w_sum = false;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m_sum[mt] = __any_sync(FULL, rsum[2 * mt] || rsum[2 * mt + 1]);
    w_sum = w_sum || m_sum[mt];
  }
  const bool w_n = NOPE && w_sum;
  const bool w_r = RESET && w_sum;
  const float sl2 = a.scale * LOG2E;
  const float al2 = NOPE ? a.alibi[h] * LOG2E : 0.f;
  const unsigned wlim = (unsigned)a.window;
  float m[NR], l[NR];
  float acc[MT][NT_V][4];
#pragma unroll
  for (int R = 0; R < NR; ++R) {
    m[R] = -INFINITY;
    l[R] = 0.f;
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT_V; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  const int koff = ((lane & 7) + (lane >> 4) * 8) * LDQ + ((lane >> 3) & 1) * 8;
  const int voff = ((lane & 7) + ((lane >> 3) & 1) * 8) * LDV + (lane >> 4) * 8;
  const bf16* qrow = q_p + (wr0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDQ + (lane >> 4) * 8;

  auto compute = [&](int i) {
    const int st = i % ST;
    const int* mt_ = meta_of(i);
    float sc[MT][NT_S][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mt][j][e] = 0.f;
    // Q.K^T; with [SUM] rows in the warp, + Qn.Kn^T on their rows
    for (int kd = 0; kd < DP / 16; ++kd) {
      uint32_t fq[MT][NQ][4], fk[NK][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int t = 0; t < NQ; ++t)
          ldsm_x4(fq[mt][t], qrow + (t * BQ + 16 * mt) * LDQ + kd * 16);
#pragma unroll
      for (int tk = 0; tk < NK; ++tk)
#pragma unroll
        for (int jp = 0; jp < 2; ++jp)
          ldsm_x4(fk[tk][jp], plane(st, PK + tk) + jp * 16 * LDQ + koff + kd * 16);
      uint32_t fn[NK][2][4];
      if (w_n) {
#pragma unroll
        for (int tk = 0; tk < NK; ++tk)
#pragma unroll
          for (int jp = 0; jp < 2; ++jp)
            ldsm_x4(fn[tk][jp], plane(st, PKN + tk) + jp * 16 * LDQ + koff + kd * 16);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (NOPE && m_sum[mt]) {
          // A fragments: registers 0 and 2 hold row g, 1 and 3 row g + 8
          uint32_t fp[NQ][4], fs[NQ][4];
#pragma unroll
          for (int t = 0; t < NQ; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const bool s = rsum[2 * mt + (e & 1)];
              fp[t][e] = s ? 0u : fq[mt][t][e];
              fs[t][e] = s ? fq[mt][t][e] : 0u;
            }
#pragma unroll
          for (int tk = 0; tk < NK; ++tk)
#pragma unroll
            for (int tq = 0; tq < NQ; ++tq)
              if (tq + tk < TQK) {
#pragma unroll
                for (int jp = 0; jp < 2; ++jp) {
                  mma(sc[mt][2 * jp], fp[tq], fk[tk][jp][0], fk[tk][jp][1]);
                  mma(sc[mt][2 * jp + 1], fp[tq], fk[tk][jp][2], fk[tk][jp][3]);
                  mma(sc[mt][2 * jp], fs[tq], fn[tk][jp][0], fn[tk][jp][1]);
                  mma(sc[mt][2 * jp + 1], fs[tq], fn[tk][jp][2], fn[tk][jp][3]);
                }
              }
        } else {
#pragma unroll
          for (int tk = 0; tk < NK; ++tk)
#pragma unroll
            for (int tq = 0; tq < NQ; ++tq)
              if (tq + tk < TQK) {
#pragma unroll
                for (int jp = 0; jp < 2; ++jp) {
                  mma(sc[mt][2 * jp], fq[mt][tq], fk[tk][jp][0], fk[tk][jp][1]);
                  mma(sc[mt][2 * jp + 1], fq[mt][tq], fk[tk][jp][2], fk[tk][jp][3]);
                }
              }
        }
      }
    }

    // masks, ALiBi, online softmax in base 2 (scores times log2 e);
    // element (mt, j, 2 hh + e) is row R = 2 mt + hh, column j * 8 + 2 cq + e
    int cpk[NT_S][2], cfl[NT_S][2], csg[NT_S][2];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      const int c = j * 8 + 2 * cq;
      const int2 p2 = *reinterpret_cast<const int2*>(mt_ + c);
      const int2 f2 = *reinterpret_cast<const int2*>(mt_ + BK + c);
      cpk[j][0] = p2.x; cpk[j][1] = p2.y;
      cfl[j][0] = f2.x; cfl[j][1] = f2.y;
      if (a.use_seg) {
        const int2 s2 = *reinterpret_cast<const int2*>(mt_ + 3 * BK + c);
        csg[j][0] = s2.x; csg[j][1] = s2.y;
      } else {
        csg[j][0] = csg[j][1] = 0;
      }
    }
    float alpha[NR];
    bool rescale = false;
    // the scores of row R (an interior tile's need no mask)
    auto scores = [&](int R, auto all) {
      const int mt = R >> 1, hh = R & 1;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = cfl[j][e], dd = pq[R] - cpk[j][e];
          // valid, causal and in the window (one unsigned compare),
          // isolated [SUM] keys only at distance 0, the same segment (rows
          // past S hold zeros and are never written)
          const bool ok = decltype(all)::value ||
                          ((f & 1) && (unsigned)dd <= wlim &&
                           (!(f & 2) || dd == 0) && csg[j][e] == sg[R]);
          float x = sc[mt][j][2 * hh + e] * sl2;
          if (NOPE && rsum[R]) x -= al2 * (float)dd;
          sc[mt][j][2 * hh + e] = ok ? x : -INFINITY;
          tmax = fmaxf(tmax, sc[mt][j][2 * hh + e]);
        }
      return tmax;
    };
    const bool all = interior[i % MS] != 0;
#pragma unroll
    for (int R = 0; R < NR; ++R) {
      const int mt = R >> 1, hh = R & 1;
      float tmax = all ? scores(R, std::true_type()) : scores(R, std::false_type());
      tmax = fmaxf(tmax, __shfl_xor_sync(FULL, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(FULL, tmax, 2));
      const float m_new = fmaxf(m[R], tmax);
      float rs = 0.f;
      alpha[R] = 1.f;
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[mt][j][2 * hh + e];
          x = m_new == -INFINITY ? 0.f : ex2(x - m_new);
          rs += x;
        }
      if (m_new != -INFINITY) {
        alpha[R] = ex2(m[R] - m_new);
        m[R] = m_new;
      }
      rs += __shfl_xor_sync(FULL, rs, 1);
      rs += __shfl_xor_sync(FULL, rs, 2);
      l[R] = l[R] * alpha[R] + rs;
      rescale = rescale || alpha[R] != 1.f;
    }
    if (__any_sync(FULL, rescale)) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT_V; ++j) {
          acc[mt][j][0] *= alpha[2 * mt];
          acc[mt][j][1] *= alpha[2 * mt];
          acc[mt][j][2] *= alpha[2 * mt + 1];
          acc[mt][j][3] *= alpha[2 * mt + 1];
        }
    }

    // P.V (+ P a(d).V0), k-step by k-step; V fragments two 16-column pairs
    // at a time, each for every m-tile
    auto pv = [&](const uint32_t (&pa)[MT][NP][4], int pl, int kk, bool v0) {
#pragma unroll
      for (int n2 = 0; n2 < NT_V / 4; ++n2) {
        if (n2 * 32 < DVP) {
          uint32_t bv[NV][2][4];
#pragma unroll
          for (int tv = 0; tv < NV; ++tv)
#pragma unroll
            for (int u = 0; u < 2; ++u)
              if ((n2 * 2 + u) * 16 < DVP)
                ldsm_x4_t(bv[tv][u], plane(st, pl + tv) + kk * 16 * LDV + voff + (n2 * 2 + u) * 16);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            if (!v0 || m_sum[mt])
#pragma unroll
            for (int tv = 0; tv < NV; ++tv)
#pragma unroll
              for (int tp = 0; tp < NP; ++tp)
                if (tp + tv < TPV) {
#pragma unroll
                  for (int u = 0; u < 2; ++u)
                    if ((n2 * 2 + u) * 16 < DVP) {
                      const int np = n2 * 2 + u;
                      mma(acc[mt][2 * np], pa[mt][tp], bv[tv][u][0], bv[tv][u][1]);
                      mma(acc[mt][2 * np + 1], pa[mt][tp], bv[tv][u][2], bv[tv][u][3]);
                    }
                }
        }
      }
    };
    // P (or, on [SUM] rows with reset, P (1 - a(d)) in pass 0 and P a(d)
    // in pass 1) of k-step kk as NP bf16 terms in the A layout
    auto split_p = [&](int kk, int pass, uint32_t (&pa)[MT][NP][4]) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 2 * kk + (r >> 1), hh = r & 1, R = 2 * mt + hh;
          float x[2] = {sc[mt][j][2 * hh], sc[mt][j][2 * hh + 1]};
          if (w_r) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float ad = 0.f;
              if (rsum[R]) {
                const float dd = (float)(pq[R] - cpk[j][e]);
                ad = a.y_min + (a.y_max - a.y_min) / (1.f + expf(-(dd - a.midpoint)));
              }
              x[e] = pass ? x[e] * ad : x[e] - x[e] * ad;
            }
          }
#pragma unroll
          for (int t = 0; t < NP; ++t) {
            const __nv_bfloat162 h2 = __floats2bfloat162_rn(x[0], x[1]);   // x0 low
            pa[mt][t][r] = *reinterpret_cast<const uint32_t*>(&h2);
            x[0] -= __low2float(h2);
            x[1] -= __high2float(h2);
          }
        }
    };
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      uint32_t pa[MT][NP][4];
      split_p(kk, 0, pa);
      pv(pa, PV, kk, false);
      if (w_r) {
        split_p(kk, 1, pa);
        pv(pa, PV0, kk, true);
      }
    }
  };

  // The pipeline (cp.async groups, one per tile, the q tile in the first):
  // tile i + ST - 1's copies are in flight while tile i is computed. Each
  // tile has one barrier, which also tells every thread whether the tile
  // holds a slot some row may attend.
  if (direct) {
#pragma unroll
    for (int i = 0; i < ST - 1; ++i) {
      if (i < n_t) issue(i);
      cp_commit();
    }
  }
  for (int i = 0; i < n_t; ++i) {
    if (direct)
      cp_wait<(ST > 1 ? ST - 2 : 0)>();   // tile i's group
    else
      meta_load(i, false);
    const bool mine = slot_live(i);
    const int live = __syncthreads_or(mine);
    if (direct) {
      if (i + ST - 1 < n_t) issue(i + ST - 1);
      cp_commit();
    }
    if (!live) continue;
    if (!direct) {
      convert(i);
      __syncthreads();
    }
    if (w_live) compute(i);
  }
  if (direct) cp_wait<0>();

#pragma unroll
  for (int R = 0; R < NR; ++R) {
    if (!rin[R]) continue;
    const int mt = R >> 1, hh = R & 1;
    const int qi = q0 + wr0 + 16 * mt + g + 8 * hh;
    const float inv = l[R] > 0.f ? 1.f / l[R] : 0.f;
    T* orow = a.o + (((size_t)b * S + qi) * a.H + h) * Dv;
#pragma unroll
    for (int j = 0; j < NT_V; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * cq + e;
        if (col < Dv) store(orow + col, acc[mt][j][2 * hh + e] * inv);
      }
    if (cq == 0)
      a.lse[((size_t)b * a.H + h) * S + qi] =
          l[R] > 0.f ? m[R] * LN2 + logf(l[R]) : 1e30f;
  }
}

template <typename T, bool NOPE, bool RESET, int DQ>
int launch(const Args<T>& a, int smem, cudaStream_t stream) {
  using C = Cfg<T, NOPE, RESET, DQ>;
  // the plan must be this source's (windowed_tile_plan)
  if (smem != (int)C::BYTES || a.n_qb != (a.S + C::BQ - 1) / C::BQ)
    return (int)cudaErrorInvalidValue;
  auto kern = windowed_attn_kernel<T, NOPE, RESET, DQ>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.H, a.n_qb, a.B);
  kern<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int DQ>
int dispatch_dq(const Args<T>& a, bool nope, bool reset, int smem, cudaStream_t st) {
  if (nope)
    return reset ? launch<T, true, true, DQ>(a, smem, st) : launch<T, true, false, DQ>(a, smem, st);
  return reset ? launch<T, false, true, DQ>(a, smem, st) : launch<T, false, false, DQ>(a, smem, st);
}

// the head-dim class of q and K: DMAX up to 128, else DWIDE
template <typename T>
int dispatch(const Args<T>& a, bool nope, bool reset, int smem, cudaStream_t st) {
  return a.D <= DMAX ? dispatch_dq<T, DMAX>(a, nope, reset, smem, st)
                     : dispatch_dq<T, DWIDE>(a, nope, reset, smem, st);
}

template <typename T>
Args<T> make_args(const void* q, const void* qn, const void* k, const void* kn,
                  const void* v, const void* v0, const void* alibi,
                  const void* pos_q, const void* pos_k, const void* sum_q,
                  const void* sum_k, const void* valid_k, const void* seg_q,
                  const void* seg_k, void* o, void* lse, int B, int S, int H,
                  int Hk, int D, int Dv, int window, int sum_isolated,
                  int use_seg, int n_qb, float scale, float y_min, float y_max,
                  float midpoint) {
  Args<T> a;
  a.q = static_cast<const T*>(q);
  a.qn = static_cast<const T*>(qn);
  a.k = static_cast<const T*>(k);
  a.kn = static_cast<const T*>(kn);
  a.v = static_cast<const T*>(v);
  a.v0 = static_cast<const T*>(v0);
  a.alibi = static_cast<const float*>(alibi);
  a.pos_q = static_cast<const int*>(pos_q);
  a.pos_k = static_cast<const int*>(pos_k);
  a.sum_q = static_cast<const int*>(sum_q);
  a.sum_k = static_cast<const int*>(sum_k);
  a.valid_k = static_cast<const int*>(valid_k);
  a.seg_q = static_cast<const int*>(seg_q);
  a.seg_k = static_cast<const int*>(seg_k);
  a.o = static_cast<T*>(o);
  a.lse = static_cast<float*>(lse);
  a.B = B; a.S = S; a.H = H; a.Hk = Hk; a.D = D; a.Dv = Dv;
  a.window = window; a.sum_isolated = sum_isolated; a.use_seg = use_seg;
  a.n_qb = n_qb;
  a.scale = scale; a.y_min = y_min; a.y_max = y_max; a.midpoint = midpoint;
  // 16-byte copies need 16-byte rows and bases
  const uintptr_t al = (uintptr_t)q | (uintptr_t)qn | (uintptr_t)k |
                       (uintptr_t)kn | (uintptr_t)v | (uintptr_t)v0;
  a.direct = sizeof(T) == 2 && D % 8 == 0 && Dv % 8 == 0 && al % 16 == 0;
  return a;
}

}  // namespace

// Returns the launch's cudaError_t (0 = launched). Pointers the flags
// switch off may be null; valid_k may be null (every key valid). The plan
// (n_qb q tiles of 64 rows, `smem` bytes of dynamic shared memory) comes
// from `windowed_tile_plan`; a plan this source does not make is refused.
extern "C" int windowed_attn_fwd(
    const void* q, const void* qn, const void* k, const void* kn,
    const void* v, const void* v0, const void* alibi, const void* pos_q,
    const void* pos_k, const void* sum_q, const void* sum_k,
    const void* valid_k, const void* seg_q, const void* seg_k, void* o,
    void* lse, int B, int S, int H, int Hk, int D, int Dv, int window,
    int use_nope, int use_reset, int sum_isolated, int use_seg, int is_bf16,
    int n_qb, int smem, float scale, float y_min, float y_max,
    float midpoint, void* stream) {
  if (D > DWIDE || Dv > DMAX || D <= 0 || Dv <= 0 || Hk <= 0 || H % Hk != 0 ||
      window <= 0 || (use_nope && (qn == nullptr || kn == nullptr || sum_q == nullptr)) ||
      (use_reset && (v0 == nullptr || sum_q == nullptr)) ||
      (sum_isolated && sum_k == nullptr) ||
      (use_seg && (seg_q == nullptr || seg_k == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    auto a = make_args<bf16>(q, qn, k, kn, v, v0, alibi, pos_q, pos_k, sum_q,
                             sum_k, valid_k, seg_q, seg_k, o, lse, B, S, H, Hk,
                             D, Dv, window, sum_isolated, use_seg, n_qb, scale,
                             y_min, y_max, midpoint);
    return dispatch(a, use_nope != 0, use_reset != 0, smem, st);
  }
  auto a = make_args<float>(q, qn, k, kn, v, v0, alibi, pos_q, pos_k, sum_q,
                            sum_k, valid_k, seg_q, seg_k, o, lse, B, S, H, Hk,
                            D, Dv, window, sum_isolated, use_seg, n_qb, scale,
                            y_min, y_max, midpoint);
  return dispatch(a, use_nope != 0, use_reset != 0, smem, st);
}
