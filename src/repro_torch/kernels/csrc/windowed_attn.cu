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
// * Occupancy (the 128 class). bf16: 71-90 KB of shared memory and
//   158-255 registers (nvcc -Xptxas -v, no spills), 2 CTAs (8 warps) per
//   SM. The fp32 instantiation (and bf16 rows that are not 16-byte
//   aligned) converts each tile straight from memory into its term planes,
//   one stage, 106-158 KB, 1 CTA per SM.
// * Head-dim classes (`Cfg`'s DQ). q/k head dims up to 128 (DMAX) and, for
//   deepseek-v2's MLA (Dqk = 128 + 64, Dv 128,
//   `repro/configs/deepseek_v2_236b.py`), up to 192 (DWIDE). In fp32 the
//   wide class runs the design above, its q and K planes' rows DQ + 8 = 200
//   values (conflict-free for ldmatrix too), V's 136, one CTA per SM.
//
// The wide class in bf16 (`WgCfg`, `fwd_wg_kernel`) is built on Hopper's
// warpgroup products instead: at 192 the design above fits one CTA of 4
// warps an SM, whose chains of products and exponentials nothing hides
// (2.07x SDPA forward at deepseek-v2's prefill shape on an H100, PERF.md).
// * wgmma. Two consumer warpgroups of 64 query rows (128 a CTA) and a
//   producer warpgroup, one CTA per SM; setmaxnreg gives the consumers 232
//   registers and the producer 40. Q (q_nope on [SUM] rows) is staged once
//   and held as A fragments in registers (48 a thread); over kv tiles of 64
//   keys, S = Q.K^T is m64n64k16 with K from shared memory; a warpgroup
//   holding a [SUM] row adds Sn = Q.Kn^T and takes each row's stream. P
//   goes from the accumulator layout into hi + lo A fragments for
//   O += P.V (m64n128k16, V read MN-major); on [SUM] rows with reset, P (1
//   - a(d)) multiplies V and P a(d) V0, a(d) by the fast exponential and
//   division (~1e-7 relative). The warpgroups skip tiles as above, from
//   the staged metadata, each for its own 64 rows.
// * Staging. TMA copies each tile's K (and K_nope) and V (and V0) planes as
//   boxes of 64 columns x 64 keys in the 128-byte swizzle, zero past S and
//   the head dims, into two rings (K 96 KB, V 64 KB) of four stages each,
//   two where the q tile holds a [SUM] row; 4-byte cp.async copies the
//   keys' metadata. Each stage has a full and an empty mbarrier: a K stage
//   is released once its scores are in registers, a V stage once its P.V
//   is done, and the two warpgroups never meet at a CTA-wide barrier, so
//   one's exponentials overlap the other's products. The grid is (q tiles,
//   H, B), so that a head's q tiles run side by side and share its band
//   from L2. Rows that are not 16-byte aligned (or head dims off 8) are
//   staged by the producer's loads of the same bits into the same planes,
//   so their outputs are those of aligned copies. Sums run in a fixed
//   order, without atomics: two calls give the same bits.
// * Tried and dropped (PERF.md): the tiles staged by the producer
//   warpgroup's cp.async (its address arithmetic, not the memory, bound
//   it: 1.6x the TMA version's time); the previous tile's P.V issued behind
//   this tile's scores so that the softmax overlaps it (slower; with Q in
//   registers it spilled and ptxas serialized the wgmma); the two
//   warpgroups taking turns on named barriers (slower).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

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

// ---------------------------------------------------------------------------
// the bf16 wide class on wgmma
// ---------------------------------------------------------------------------

// Three warpgroups a CTA: two consumers of 64 query rows each (wgmma's M)
// and one producer, which stages each kv tile's planes and its keys'
// metadata into a ring of stages; a full and an empty mbarrier per stage
// order the two sides, so that the consumers never meet at a CTA-wide
// barrier and drift apart. setmaxnreg moves the producer's registers to
// the consumers (40 and 232 a thread). Planes are blocks of 64 columns
// (128 bytes a row) in the 128-byte swizzle that TMA writes and wgmma
// reads: a row's eight 16-byte chunks permuted by the row's index mod 8
// inside aligned atoms of 8 rows (1,024 bytes). q, K and K_nope are three
// blocks wide (192 columns), V and V0 two (128).
constexpr int WG_CONSUMERS = 256, WG_PRODUCERS = 128;
constexpr int WG_THREADS = WG_CONSUMERS + WG_PRODUCERS;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int WBK = 64;             // keys per kv tile
constexpr int WG_MAX_STAGES = 4;    // the ring's stages when only K and V are staged
constexpr int SW = 64;              // columns of a swizzled block (128 bytes)
constexpr int QBLK = DWIDE / SW, VBLK = DMAX / SW;   // blocks of a q/k row, a value row

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// wgmma's shared-memory matrix descriptor, 128-byte swizzle, of the
// operand at shared address a: `lbo` the bytes between swizzle atoms
// along M/N (read only for an MN-major operand), `sbo` between 8-row atoms
// along the other dimension. Shared addresses stay below 2^18, so moving
// the operand by k bytes adds k / 16 to the descriptor.
__device__ __forceinline__ uint64_t sw_desc(uint32_t a, int lbo, int sbo) {
  return (uint64_t)(a >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// shared-memory writes of this thread (st.shared, cp.async) made visible
// to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving accesses of x across a wgmma wait
template <int N>
__device__ __forceinline__ void hold(float (&x)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(x[j][e]));
}
template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
}

// mbarriers: `count` arrivals (and, where a thread announced them, the
// bytes of TMA copies) complete a phase; a waiter names the phase's parity
// (phases alternate 0, 1, 0, ...)
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(saddr(b)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(saddr(b)) : "memory");
}
// an arrival that also announces `bytes` of TMA copies to come
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(saddr(b)), "r"(bytes) : "memory");
}
// an arrival once this thread's cp.async copies so far have landed (the
// barrier's count includes it)
__device__ __forceinline__ void mbar_arrive_cp(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(saddr(b)) : "memory");
}
// waits for the phase of parity `parity` to complete (no trap on a long
// wait: ptxas then keeps the consumers' region at the launch's register
// count and spills)
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  const uint32_t a = saddr(b);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// TMA: the box of tensor map `map` at coordinates (c0, c1, c2, c3) into
// shared memory at dst, its bytes counted on mbarrier bar
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map, int c0, int c1,
                                          int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(saddr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3), "r"(saddr(bar))
      : "memory");
}

#define WG_D32 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
// a k-step of the score product: A from the four registers named, B at
// descriptor b, d scaled by predicate `pd` (z: overwritten, p: summed)
#define WG_RS64(pd, a4) "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32 \
    ", {" a4 "}, b, " pd ", 1, 1, 0;\n"
// B's next k-step: 32 bytes along a block's rows, or the next block of 64
// keys x 128 bytes (less the 96 bytes already moved)
#define WG_NEXT "add.s64 b, b, 2;\n"
#define WG_NEXT_BLOCK "add.s64 b, b, 506;\n"
#define WG_OUT8(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
#define WG_DEF8(j) "=f"(d[j][0]), "=f"(d[j][1]), "=f"(d[j][2]), "=f"(d[j][3])
#define WG_A4(k) "r"(q[k][0]), "r"(q[k][1]), "r"(q[k][2]), "r"(q[k][3])

// d = A.B for m64n64k16 over 12 k-steps (the first ignores d's old value,
// so d is only written): A (64 x 192) from registers (k-step k's fragment
// in q[k]), B (64 keys x 192) K-major in three swizzled blocks, its
// descriptor advanced inside the asm block
__device__ __forceinline__ void wg_rs64x12(float (&d)[8][4], const uint32_t (&q)[12][4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p, z;\n.reg .b64 b;\nsetp.ne.b32 p, %81, 0;\nsetp.eq.b32 z, %81, 0;\n"
      "mov.b64 b, %80;\n"
      WG_RS64("z", "%32, %33, %34, %35") WG_NEXT WG_RS64("p", "%36, %37, %38, %39") WG_NEXT
      WG_RS64("p", "%40, %41, %42, %43") WG_NEXT WG_RS64("p", "%44, %45, %46, %47") WG_NEXT_BLOCK
      WG_RS64("p", "%48, %49, %50, %51") WG_NEXT WG_RS64("p", "%52, %53, %54, %55") WG_NEXT
      WG_RS64("p", "%56, %57, %58, %59") WG_NEXT WG_RS64("p", "%60, %61, %62, %63") WG_NEXT_BLOCK
      WG_RS64("p", "%64, %65, %66, %67") WG_NEXT WG_RS64("p", "%68, %69, %70, %71") WG_NEXT
      WG_RS64("p", "%72, %73, %74, %75") WG_NEXT WG_RS64("p", "%76, %77, %78, %79")
      "}\n"
      : WG_DEF8(0), WG_DEF8(1), WG_DEF8(2), WG_DEF8(3), WG_DEF8(4), WG_DEF8(5), WG_DEF8(6), WG_DEF8(7)
      : WG_A4(0), WG_A4(1), WG_A4(2), WG_A4(3), WG_A4(4), WG_A4(5), WG_A4(6), WG_A4(7),
        WG_A4(8), WG_A4(9), WG_A4(10), WG_A4(11), "l"(db), "r"(1));
}

// d += A.B for m64n128k16: A (64 x 16 bf16) from registers in the
// accumulator-derived fragment layout, B (16 keys x 128) MN-major in two
// swizzled blocks
__device__ __forceinline__ void wg_rs128(float (&d)[16][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_OUT8(0), WG_OUT8(1), WG_OUT8(2), WG_OUT8(3), WG_OUT8(4), WG_OUT8(5), WG_OUT8(6), WG_OUT8(7),
        WG_OUT8(8), WG_OUT8(9), WG_OUT8(10), WG_OUT8(11), WG_OUT8(12), WG_OUT8(13), WG_OUT8(14), WG_OUT8(15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef WG_D32
#undef WG_RS64
#undef WG_NEXT
#undef WG_NEXT_BLOCK
#undef WG_OUT8
#undef WG_DEF8
#undef WG_A4

// Rows [0, R) of a swizzled plane of NB blocks, `len` values each (zero
// past them, and rows for which src(r, ptr, ok) clears ok), by threads t
// of NT: eight threads a row of a block (128 bytes: coalesced reads,
// conflict-free stores); by cp.async (direct: len a multiple of 8, rows
// 16-byte aligned) or by loads of the raw bits (the same values)
template <int R, int NB, int NT, typename Src>
__device__ __forceinline__ void stage_sw(bf16* pl, int t, int len, bool direct, Src&& src) {
  for (int i = t; i < R * NB * 8; i += NT) {
    const int j = i & 7, r = (i >> 3) % R, blk = (i >> 3) / R;
    const int c = blk * SW + j * 8;
    const bf16* s;
    bool ok;
    src(r, s, ok);
    bf16* dst = pl + (blk * R + r) * SW + ((j ^ (r & 7)) * 8);
    if (direct) {
      cp16(dst, s + c, ok && c < len);
      continue;
    }
    const unsigned short* u = reinterpret_cast<const unsigned short*>(s + c);
    const int n = len - c;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t lo = (ok && 2 * e < n) ? u[2 * e] : 0u;
      const uint32_t hi = (ok && 2 * e + 1 < n) ? u[2 * e + 1] : 0u;
      w[e] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// the reset weight a(d) sigma at distance dd with the fast exponential and
// division (~1e-7 relative: far below bf16's rounding)
__device__ __forceinline__ float reset_fast(const Args<bf16>& a, int dd) {
  return a.y_min + __fdividef(a.y_max - a.y_min, 1.f + ex2((a.midpoint - (float)dd) * LOG2E));
}

// two values as hi + lo bf16 pairs (x0 in the low half): the rounding of
// (x0, x1), then that of what it leaves
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// TMA maps of K, K_nope, V, V0 (dims: head dim, Hk, S, B; boxes of 64
// columns x 1 x 64 keys x 1, 128-byte swizzle): the direct path's copies
struct TmaMaps {
  CUtensorMap k, kn, v, v0;
};

// Tiles, rings and shared memory of the bf16 wide class (see the header;
// `windowed_tile_plan` mirrors it): 128 query rows, their Q (q_nope on
// [SUM] rows) staged once; kv tiles of WBK keys through two rings, each
// stage with a full and an empty mbarrier: a K ring of K_RING values
// (WG_MAX_STAGES stages of K, or, in a CTA whose rows hold a [SUM] row,
// K_STAGES of K and K_nope) and a V ring of V_RING values (WG_MAX_STAGES
// stages of V, or V_STAGES of V and V0); META_SLOTS slots of the keys'
// four words (position, valid, [SUM], segment), filled with the K ring;
// each row's position, [SUM] flag and segment; five words a row warp and
// a warpgroup; 1,024 bytes to align the planes to the swizzle's atoms.
constexpr int META_SLOTS = 2 * WG_MAX_STAGES;
template <bool NOPE, bool RESET>
struct WgCfg {
  static constexpr int BQ = 128;                        // query rows per CTA
  static constexpr size_t Q_ELEMS = (size_t)BQ * DWIDE;
  static constexpr size_t K_RING = (size_t)WG_MAX_STAGES * WBK * DWIDE;
  static constexpr size_t V_RING = (size_t)WG_MAX_STAGES * WBK * DMAX;
  static constexpr int K_STAGES = NOPE ? WG_MAX_STAGES / 2 : WG_MAX_STAGES;
  static constexpr int V_STAGES = RESET ? WG_MAX_STAGES / 2 : WG_MAX_STAGES;
  static constexpr size_t BYTES =
      1024 + (Q_ELEMS + K_RING + V_RING) * sizeof(bf16) + 4 * WG_MAX_STAGES * sizeof(uint64_t) +
      (size_t)(META_SLOTS * META * WBK + 3 * BQ + 5 * (BQ / 32) + 10) * sizeof(int);
};

// a ring's position: stage s of n (2 or 4), the parity of its phase
struct Ring {
  int n, s = 0, ph = 0;
  __device__ __forceinline__ void next() {
    if (++s == n) {
      s = 0;
      ph ^= 1;
    }
  }
};

template <bool NOPE, bool RESET>
__global__ void __launch_bounds__(WG_THREADS, 1)
fwd_wg_kernel(const Args<bf16> a, const __grid_constant__ TmaMaps maps) {
  using C = WgCfg<NOPE, RESET>;
  constexpr int BQ = C::BQ;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  unsigned char* base = wg_smem + ((1024 - (saddr(wg_smem) & 1023)) & 1023);
  bf16* q_p = reinterpret_cast<bf16*>(base);   // q (q_nope on [SUM] rows)
  bf16* kr_p = q_p + C::Q_ELEMS;               // the K ring
  bf16* vr_p = kr_p + C::K_RING;               // the V ring
  uint64_t* full_k = reinterpret_cast<uint64_t*>(vr_p + C::V_RING);
  uint64_t* empty_k = full_k + WG_MAX_STAGES;
  uint64_t* full_v = empty_k + WG_MAX_STAGES;
  uint64_t* empty_v = full_v + WG_MAX_STAGES;
  int* meta = reinterpret_cast<int*>(empty_v + WG_MAX_STAGES);  // per slot: keys' position, valid, [SUM], segment
  int* pos_r = meta + META_SLOTS * META * WBK;
  int* sum_r = pos_r + BQ;
  int* seg_r = sum_r + BQ;
  int* red = seg_r + BQ;      // per warp of rows: least, greatest position and segment, any [SUM]
  int* agg = red + 5 * (BQ / 32);   // the same per consumer warpgroup

  const int iq = a.n_qb - 1 - (int)blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hk);
  const int S = a.S, D = a.D, Dv = a.Dv;
  const int q0 = iq * BQ, nr = min(BQ, S - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, cq = lane & 3;
  const bool direct = a.direct;

  // the q tile's rows (threads below BQ, a warp per 32): position, [SUM]
  // flag, segment, and each warp's least and greatest position and segment
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
    const int any = __any_sync(FULL, sm != 0);
    if (lane == 0) {
      red[5 * warp] = lo;
      red[5 * warp + 1] = hi;
      red[5 * warp + 2] = slo;
      red[5 * warp + 3] = shi;
      red[5 * warp + 4] = any;
    }
  }
  __syncthreads();
  if (tid < 2) {   // consumer warpgroup tid: row warps 2 tid, 2 tid + 1
    const int* r0 = red + 10 * tid;
    agg[5 * tid] = min(r0[0], r0[5]);
    agg[5 * tid + 1] = max(r0[1], r0[6]);
    agg[5 * tid + 2] = min(r0[2], r0[7]);
    agg[5 * tid + 3] = max(r0[3], r0[8]);
    agg[5 * tid + 4] = r0[4] | r0[9];
  }
  if (tid == 32) {
    // direct: a K stage waits for the 64 metadata copiers' cp.async
    // arrivals and the K thread's, a V stage for the V thread's; else for
    // the producer warpgroup's
    for (int s = 0; s < WG_MAX_STAGES; ++s) {
      mbar_init(&full_k[s], direct ? WBK + 1 : WG_PRODUCERS);
      mbar_init(&full_v[s], direct ? 1 : WG_PRODUCERS);
      mbar_init(&empty_k[s], WG_CONSUMERS / 32);
      mbar_init(&empty_v[s], WG_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Q (q_nope on [SUM] rows, NoPE), zero past D and S, by every thread
  stage_sw<BQ, QBLK, WG_THREADS>(q_p, tid, D, direct, [&](int r, const bf16*& s, bool& ok) {
    ok = r < nr;
    s = ((NOPE && ok && sum_r[r]) ? a.qn : a.q) + (((size_t)b * S + q0 + (ok ? r : 0)) * a.H + h) * D;
  });
  cp_commit();
  cp_wait<0>();
  fence_async_smem();
  __syncthreads();
  const bool any_sum = (agg[4] | agg[9]) != 0;
  // the rings: stages of K and K_nope, V and V0 where a [SUM] row needs
  // them, else more stages of K alone and V alone in the same bytes
  const bool kn_live = NOPE && any_sum, v0_live = RESET && any_sum;
  const int nk = kn_live ? C::K_STAGES : WG_MAX_STAGES;
  const int nv = v0_live ? C::V_STAGES : WG_MAX_STAGES;
  auto k_st = [&](int s) { return kr_p + (size_t)s * WBK * DWIDE * (kn_live ? 2 : 1); };
  auto v_st = [&](int s) { return vr_p + (size_t)s * WBK * DMAX * (v0_live ? 2 : 1); };
  auto meta_of = [&](int i) { return meta + (i % META_SLOTS) * META * WBK; };
  // physical band: kv tiles holding rows [q0 - window, q0 + nr - 1]
  const int kb_lo = max(q0 - a.window, 0) / WBK;
  const int n_t = (q0 + nr - 1) / WBK - kb_lo + 1;
  // the warpgroup, warp-uniform to the compiler: wgmma on a path it must
  // take as divergent is serialized
  const int wg = __shfl_sync(FULL, warp >> 2, 0);

  if (wg == 2) {
    // The producer, for each tile: once its K stage is free, the keys'
    // metadata by 4-byte cp.async (threads below WBK, a key each) and the
    // K and K_nope planes; once its V stage is free, the V and V0 planes.
    // Direct: planes by TMA, K's from thread WBK, V's from thread 3 * 32
    // (keys past S and columns past the head dims zero-filled); a stage is
    // full once its copies have landed. Else every thread loads the planes.
    regs_dec<PRODUCER_REGS>();
    const int pt = tid - WG_CONSUMERS;
    const bool k_side = !direct || pt <= WBK, v_side = !direct || pt == 96;
    if (!k_side && !v_side) return;
    Ring rk{nk}, rv{nv};
    for (int i = 0; i < n_t; ++i, rk.next(), rv.next()) {
      const int kt0 = (kb_lo + i) * WBK;
      if (k_side) {
        if (i >= nk) mbar_wait(&empty_k[rk.s], rk.ph ^ 1);
        if (pt < WBK) {
          int* m = meta_of(i);
          const bool in = kt0 + pt < S;
          const size_t bs = (size_t)b * S + (in ? kt0 + pt : 0);
          cp4(m + pt, a.pos_k + bs, in);
          if (a.valid_k != nullptr) cp4(m + WBK + pt, a.valid_k + bs, in);
          if (a.sum_isolated) cp4(m + 2 * WBK + pt, a.sum_k + bs, in);
          if (a.use_seg) cp4(m + 3 * WBK + pt, a.seg_k + bs, in);
          if (direct) mbar_arrive_cp(&full_k[rk.s]);
        }
        bf16* kp = k_st(rk.s);
        if (direct && pt == WBK) {
          mbar_arrive_tx(&full_k[rk.s], WBK * DWIDE * 2 * (kn_live ? 2 : 1));
#pragma unroll
          for (int blk = 0; blk < QBLK; ++blk) {
            tma_load4(kp + blk * WBK * SW, &maps.k, blk * SW, hk, kt0, b, &full_k[rk.s]);
            if (kn_live)
              tma_load4(kp + (QBLK + blk) * WBK * SW, &maps.kn, blk * SW, hk, kt0, b, &full_k[rk.s]);
          }
        }
        if (!direct) {
          auto row = [&](int r, bool& ok) {
            ok = kt0 + r < S;
            return ((size_t)b * S + (ok ? kt0 + r : 0)) * a.Hk + hk;
          };
          stage_sw<WBK, QBLK, WG_PRODUCERS>(kp, pt, D, false,
                                            [&](int r, const bf16*& p, bool& ok) { p = a.k + row(r, ok) * D; });
          if (kn_live)
            stage_sw<WBK, QBLK, WG_PRODUCERS>(kp + WBK * DWIDE, pt, D, false,
                                              [&](int r, const bf16*& p, bool& ok) { p = a.kn + row(r, ok) * D; });
          cp_commit();
          cp_wait<0>();
          fence_async_smem();
          mbar_arrive(&full_k[rk.s]);
        }
      }
      if (v_side) {
        if (i >= nv) mbar_wait(&empty_v[rv.s], rv.ph ^ 1);
        bf16* vp = v_st(rv.s);
        if (direct) {
          mbar_arrive_tx(&full_v[rv.s], WBK * DMAX * 2 * (v0_live ? 2 : 1));
#pragma unroll
          for (int blk = 0; blk < VBLK; ++blk) {
            tma_load4(vp + blk * WBK * SW, &maps.v, blk * SW, hk, kt0, b, &full_v[rv.s]);
            if (v0_live)
              tma_load4(vp + (VBLK + blk) * WBK * SW, &maps.v0, blk * SW, hk, kt0, b, &full_v[rv.s]);
          }
        } else {
          auto row = [&](int r, bool& ok) {
            ok = kt0 + r < S;
            return ((size_t)b * S + (ok ? kt0 + r : 0)) * a.Hk + hk;
          };
          stage_sw<WBK, VBLK, WG_PRODUCERS>(vp, pt, Dv, false,
                                            [&](int r, const bf16*& p, bool& ok) { p = a.v + row(r, ok) * Dv; });
          if (v0_live)
            stage_sw<WBK, VBLK, WG_PRODUCERS>(vp + WBK * DMAX, pt, Dv, false,
                                              [&](int r, const bf16*& p, bool& ok) { p = a.v0 + row(r, ok) * Dv; });
          fence_async_smem();
          mbar_arrive(&full_v[rv.s]);
        }
      }
    }
    return;
  }

  regs_inc<CONSUMER_REGS>();
  // this thread's rows: hh = 0, 1 is row g + 8 hh of the warp's 16; their
  // data is read from shared memory where needed, not held
  const int wr0 = warp * 16;
  const bool w_sum = __shfl_sync(FULL, agg[5 * wg + 4], 0) != 0;   // this warpgroup holds a [SUM] row
  const bool wg_live = 64 * wg < nr;
  const bool has_valid = a.valid_k != nullptr;
  const float sl2 = a.scale * LOG2E;
  const float al2 = NOPE ? a.alibi[h] * LOG2E : 0.f;
  const unsigned wlim = (unsigned)a.window;
  const int lo = agg[5 * wg], hi = agg[5 * wg + 1], slo = agg[5 * wg + 2], shi = agg[5 * wg + 3];
  float acc[DMAX / 8][4];     // O, 64 rows x 128 value columns
  zero(acc);
  // each row's running max (base 2) and this thread's part of its sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // one arrival a warp on a stage's empty mbarrier
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // this warp's 16 rows of Q as A fragments, a k-step of 16 columns each:
  // matrix L / 8 of an ldmatrix.x4 is rows 8 (L / 8 & 1) + L % 8, columns
  // 8 (L / 16) of the k-step, read through the swizzle
  uint32_t qf[DWIDE / 16][4];
  {
    const int r = wr0 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
    for (int kk = 0; kk < DWIDE / 16; ++kk) {
      const int c0 = kk * 16 + (lane >> 4) * 8, blk = c0 / SW, j = (c0 % SW) / 8;
      ldsm_x4(qf[kk], q_p + (blk * BQ + r) * SW + ((j ^ (r & 7)) * 8));
    }
  }

  // The warpgroup's walk over the band, a kv tile at a time: S = Q.K^T,
  // with a [SUM] row also Sn = Q.Kn^T (its Q row holds q_nope; NoPE), Q
  // from registers and K from shared memory; the K stage is released once
  // the scores are in registers; masks, ALiBi and the online softmax in
  // registers; then O += P.V with P as hi + lo A fragments (on [SUM] rows
  // with reset P (1 - a(d)) for V and P a(d) for V0), and the V stage is
  // released. WN and WR are the warpgroup's NoPE and reset products.
  auto walk = [&](auto wn, auto wr) {
    constexpr bool WN = decltype(wn)::value, WR = decltype(wr)::value;
    Ring rk{nk}, rv{nv};
    for (int i = 0; i < n_t; ++i, rk.next(), rv.next()) {
      mbar_wait(&full_k[rk.s], rk.ph);
      // whether some row of this warpgroup may attend a key of the tile,
      // and whether every row attends every key (an interior tile, whose
      // scores need no mask): each warp, a lane per two keys
      const int kt0 = (kb_lo + i) * WBK;
      const int* mt_ = meta_of(i);
      bool live = false, all = true;
#pragma unroll
      for (int u = 0; u < WBK / 32; ++u) {
        const int c = lane + 32 * u;
        const int pk = mt_[c];
        const int sk = a.sum_isolated ? (mt_[2 * WBK + c] != 0) : 0;
        const int f = (kt0 + c < S && (!has_valid || mt_[WBK + c] != 0)) ? (1 | (sk << 1)) : 0;
        bool lv = (f & 1) && pk <= hi && (long long)pk >= (long long)lo - a.window;
        if (f & 2) lv = lv && pk >= lo;
        bool al = f == 1 && pk <= lo && (long long)hi - pk <= a.window;
        if (a.use_seg) {
          const int sgk = mt_[3 * WBK + c];
          lv = lv && sgk >= slo && sgk <= shi;
          al = al && sgk == slo && slo == shi;
        }
        live = live || lv;
        all = all && al;
      }
      if (!wg_live || !__any_sync(FULL, live)) {
        // nothing of this tile for these rows: release both stages (V's
        // once its copies have landed, so that its phases stay in order)
        release(&empty_k[rk.s]);
        mbar_wait(&full_v[rv.s], rv.ph);
        release(&empty_v[rv.s]);
        continue;
      }
      const bool interior = __all_sync(FULL, all);
      const uint32_t ks = saddr(k_st(rk.s));
      float sc[WBK / 8][4], sn[WN ? WBK / 8 : 1][4];
      (void)sn;
      wg_fence();
      wg_rs64x12(sc, qf, sw_desc(ks, 16, 1024));
      if constexpr (WN) wg_rs64x12(sn, qf, sw_desc(ks + WBK * DWIDE * 2, 16, 1024));
      wg_commit();
      wg_wait0();
      hold(sc);
      if constexpr (WN) {
        hold(sn);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool sr = sum_r[wr0 + g + 8 * (e >> 1)] != 0;
#pragma unroll
          for (int j = 0; j < WBK / 8; ++j)
            if (sr) sc[j][e] = sn[j][e];
        }
      }
      release(&empty_k[rk.s]);

      // masks and ALiBi, scores times log2 e; element (j, 2 hh + e) is
      // row g + 8 hh, key column j * 8 + 2 cq + e
      int pq[2], sgr[2];
      bool rsr[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = wr0 + g + 8 * hh;
        pq[hh] = pos_r[r];
        sgr[hh] = seg_r[r];
        rsr[hh] = (WN || WR) && sum_r[r] != 0;
      }
      float tmax[2] = {-INFINITY, -INFINITY};
      auto scores = [&](auto all_) {
#pragma unroll
        for (int j = 0; j < WBK / 8; ++j) {
          const int c = j * 8 + 2 * cq;
          const int2 p2 = *reinterpret_cast<const int2*>(mt_ + c);
          const int2 v2 = has_valid ? *reinterpret_cast<const int2*>(mt_ + WBK + c) : make_int2(1, 1);
          const int2 i2 = a.sum_isolated ? *reinterpret_cast<const int2*>(mt_ + 2 * WBK + c)
                                         : make_int2(0, 0);
          const int2 s2 = a.use_seg ? *reinterpret_cast<const int2*>(mt_ + 3 * WBK + c)
                                    : make_int2(0, 0);
          const int cpk[2] = {p2.x, p2.y}, csg[2] = {s2.x, s2.y};
          // bit 0 an attendable key (< S, valid), bit 1 an isolated [SUM] key
          const int cfl[2] = {(kt0 + c < S && v2.x != 0) ? (1 | ((i2.x != 0) << 1)) : 0,
                              (kt0 + c + 1 < S && v2.y != 0) ? (1 | ((i2.y != 0) << 1)) : 0};
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int f = cfl[e], dd = pq[hh] - cpk[e];
              // valid, causal and in the window (one unsigned compare),
              // isolated [SUM] keys only at distance 0, the same segment
              // (rows past S hold zeros and are never written)
              const bool ok = decltype(all_)::value ||
                              ((f & 1) && (unsigned)dd <= wlim &&
                               (!(f & 2) || dd == 0) && csg[e] == sgr[hh]);
              float x = sc[j][2 * hh + e] * sl2;
              if constexpr (WN) {
                if (rsr[hh]) x -= al2 * (float)dd;
              }
              x = ok ? x : -INFINITY;
              sc[j][2 * hh + e] = x;
              tmax[hh] = fmaxf(tmax[hh], x);
            }
        }
      };
      if (interior) scores(std::true_type());
      else scores(std::false_type());

      // the online softmax in base 2; a row's max over its quad of lanes
      float alpha[2];
      bool rescale = false;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float t = tmax[hh];
        t = fmaxf(t, __shfl_xor_sync(FULL, t, 1));
        t = fmaxf(t, __shfl_xor_sync(FULL, t, 2));
        const float m_new = fmaxf(m[hh], t);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < WBK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[j][2 * hh + e];
            x = m_new == -INFINITY ? 0.f : ex2(x - m_new);
            rs += x;
          }
        alpha[hh] = 1.f;
        if (m_new != -INFINITY) {
          alpha[hh] = ex2(m[hh] - m_new);
          m[hh] = m_new;
        }
        l[hh] = l[hh] * alpha[hh] + rs;
        rescale = rescale || alpha[hh] != 1.f;
      }
      if (__any_sync(FULL, rescale)) {
#pragma unroll
        for (int j = 0; j < DMAX / 8; ++j) {
          acc[j][0] *= alpha[0];
          acc[j][1] *= alpha[0];
          acc[j][2] *= alpha[1];
          acc[j][3] *= alpha[1];
        }
      }

      // P (on [SUM] rows with reset P (1 - a(d)), and P a(d) for V0) as hi
      // + lo A fragments, k-step kk of 16 keys: register r holds row
      // g + 8 (r & 1) of n-tile 2 kk + (r >> 1)
      uint32_t pa[WBK / 16][2][4];
      uint32_t pb[WR ? WBK / 16 : 1][2][4];
#pragma unroll
      for (int kk = 0; kk < WBK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 2 * kk + (r >> 1), hh = r & 1;
          float x0 = sc[j][2 * hh], x1 = sc[j][2 * hh + 1];
          if constexpr (WR) {
            float y0 = 0.f, y1 = 0.f;
            if (rsr[hh]) {
              const int2 p2 = *reinterpret_cast<const int2*>(mt_ + j * 8 + 2 * cq);
              y0 = x0 * reset_fast(a, pq[hh] - p2.x);
              y1 = x1 * reset_fast(a, pq[hh] - p2.y);
              x0 -= y0;
              x1 -= y1;
            }
            split2(y0, y1, pb[kk][0][r], pb[kk][1][r]);
          }
          split2(x0, x1, pa[kk][0][r], pa[kk][1][r]);
        }
      // V MN-major: 8-key atoms 1,024 bytes apart along K, its two blocks
      // of 64 value columns WBK * 128 bytes apart along N; a k-step is two
      // atoms
      mbar_wait(&full_v[rv.s], rv.ph);
      const uint32_t vs = saddr(v_st(rv.s));
      const uint64_t vd = sw_desc(vs, WBK * SW * 2, 1024);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < WBK / 16; ++kk)
#pragma unroll
        for (int t = 1; t >= 0; --t) wg_rs128(acc, pa[kk][t], vd + kk * (2048 >> 4));
      if constexpr (WR) {
        const uint64_t v0d = sw_desc(vs + WBK * DMAX * 2, WBK * SW * 2, 1024);
#pragma unroll
        for (int kk = 0; kk < WBK / 16; ++kk)
#pragma unroll
          for (int t = 1; t >= 0; --t) wg_rs128(acc, pb[kk][t], v0d + kk * (2048 >> 4));
      }
      wg_commit();
      wg_wait0();
      hold(acc);
      release(&empty_v[rv.s]);
    }
  };
  if (w_sum)
    walk(std::integral_constant<bool, NOPE>(), std::integral_constant<bool, RESET>());
  else
    walk(std::false_type(), std::false_type());

  // o = O / l (0 on rows with no key) in bf16, lse = m ln 2 + log l
  // (+1e30 on rows with no key)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh];
    lt += __shfl_xor_sync(FULL, lt, 1);
    lt += __shfl_xor_sync(FULL, lt, 2);
    const int r = wr0 + g + 8 * hh;
    if (r >= nr) continue;
    const int qi = q0 + r;
    const float inv = lt > 0.f ? 1.f / lt : 0.f;
    bf16* orow = a.o + (((size_t)b * S + qi) * a.H + h) * Dv;
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j) {
      const int col = j * 8 + 2 * cq;
      if (col + 1 < Dv && !(Dv & 1)) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[j][2 * hh] * inv, acc[j][2 * hh + 1] * inv);
      } else {
        if (col < Dv) store(orow + col, acc[j][2 * hh] * inv);
        if (col + 1 < Dv) store(orow + col + 1, acc[j][2 * hh + 1] * inv);
      }
    }
    if (cq == 0)
      a.lse[((size_t)b * a.H + h) * S + qi] = lt > 0.f ? m[hh] * LN2 + logf(lt) : 1e30f;
  }
}

// cuTensorMapEncodeTiled, from libcuda through the runtime's entry-point
// query (no link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) p = nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the map of a (B, S, Hk, d) bf16 tensor: boxes of 64 columns of one row
// of 64 keys, 128-byte swizzle, zeros past the tensor
bool kv_map(CUtensorMap* map, const bf16* t, int B, int S, int Hk, int d) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)Hk, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)Hk * d * 2,
                                 (cuuint64_t)S * Hk * d * 2};
  const cuuint32_t box[4] = {SW, 1, WBK, 1}, step[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(t), dims, strides, box,
             step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool NOPE, bool RESET>
int launch_wg(const Args<bf16>& a, int smem, cudaStream_t stream) {
  using C = WgCfg<NOPE, RESET>;
  // the plan must be this source's (windowed_tile_plan)
  if (smem != (int)C::BYTES || a.n_qb != (a.S + C::BQ - 1) / C::BQ)
    return (int)cudaErrorInvalidValue;
  // TMA where the rows allow it (16-byte aligned; libcuda encodes the
  // maps), else the producer's loads of the same bits
  TmaMaps maps;
  memset(&maps, 0, sizeof(maps));
  Args<bf16> args = a;
  args.direct = a.direct && kv_map(&maps.k, a.k, a.B, a.S, a.Hk, a.D) &&
                kv_map(&maps.v, a.v, a.B, a.S, a.Hk, a.Dv) &&
                (!NOPE || kv_map(&maps.kn, a.kn, a.B, a.S, a.Hk, a.D)) &&
                (!RESET || kv_map(&maps.v0, a.v0, a.B, a.S, a.Hk, a.Dv));
  auto kern = fwd_wg_kernel<NOPE, RESET>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  // q tiles innermost: the q tiles of one head (of one kv head's heads)
  // run side by side and read their overlapping bands from L2
  kern<<<dim3(a.n_qb, a.H, a.B), WG_THREADS, smem, stream>>>(args, maps);
  return (int)cudaGetLastError();
}

template <typename T, bool NOPE, bool RESET, int DQ>
int launch(const Args<T>& a, int smem, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value && DQ == DWIDE) {
    return launch_wg<NOPE, RESET>(a, smem, stream);
  } else {
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
// (n_qb q tiles, `smem` bytes of dynamic shared memory) comes from
// `windowed_tile_plan`; a plan this source does not make is refused.
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
