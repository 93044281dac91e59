// Windowed DTI attention backward for Hopper (sm_90a): the dq pass and the
// dk/dv pass.
//
// Replaces: src/repro/kernels/windowed_attn/windowed_attn_bwd.py,
// `_dq_kernel` (the dq pass) and `_dkv_kernel` + `_head_sum` (the dk/dv
// pass), both launched by `windowed_attention_bwd_bhsd`, the Pallas TPU
// kernels; the shared tile math is `_recompute_tile`.
//
// Both passes recompute, for every attendable (query, key) pair of the
// window band, the forward's score exactly as windowed_attn.cu does (q.k
// on ordinary rows, q_nope.k_nope - alibi*d on [SUM] rows, the same
// window / valid_k / [SUM]-isolation / segment masks), then
//   p  = exp(s - lse)            (0 on masked pairs; lse = +1e30 on rows
//                                 with no key, so every p of them is 0)
//   dp = do.v + a(d)sigma * do.(v0 - v)   (the reset stream, [SUM] rows)
//   ds = p * (dp - delta),  delta = <do, o>  (computed by the wrapper)
// and accumulates in fp32:
//   dq  += scale ds k      (ordinary rows)   dq_nope += scale ds k_nope ([SUM])
//   dk  += scale ds q      (ordinary rows)   dk_nope += scale ds q_nope ([SUM])
//   dv  += p (1 - a sigma) do                dv0     += p a sigma do
// Gradients are written in the input dtype.
//
// What bounds it on this card: operations. At the dti-llama training shape
// (B=8, S=2048, H=32, Hk=8, D=128, window 1024) the attended pairs need
// 2 (2D + Dv) FLOPs each per head for dq and 2 (2D + 2Dv) for dk/dv, 0.31
// and 0.42 ms at 989 TFLOP/s, against ~0.5 GB of operands: far above the
// ~295 FLOP/byte ridge. (At deepseek-v2's, H = Hk = 128 and D = 192, the
// 1.65 and 2.06 TFLOP meet 5.0 and 6.1 GB of operands and gradients:
// still operations.) So every product goes to the tensor cores. The 128
// class follows kernel 1's design (windowed_attn.cu):
//
// * Tensor cores. mma.sync m16n8k16 (bf16 in, fp32 accumulate), fragments
//   by ldmatrix from bf16 planes whose rows are padded to 136 values; K, Q
//   and dO go through ldmatrix.trans where they are the B operand over keys
//   or queries. bf16 q, K, V, dO (q_nope, K_nope, V0) are one exact term
//   each; P, P a(d) sigma and ds go from the accumulator layout straight
//   into A fragments as hi + lo bf16 pairs (~2^-17 of each value); the fp32
//   instantiation splits every operand into three terms and takes the six
//   leading term pairs (no TF32). The tensor cores truncate each fp32
//   accumulation, so there the products of a k-step go into fresh
//   registers that are added to the band's gradient accumulators in
//   round-to-nearest (mma2_acc). Exponentials in base 2 (ex2.approx) from
//   kernel 1's lse.
// * dq pass: one CTA of 4 warps (16 query rows each) per (head, q tile of
//   64 rows, batch row); blockIdx.x is the head, so the heads of one kv
//   head read the same K/V tiles side by side, from L2; q tiles run last
//   first. Its Q (q_nope on [SUM] rows) and dO planes are staged once; it
//   walks the forward's physical band of kv tiles of 32 keys (rows
//   [q0 - window, q0 + 63]). Per tile: S = Q.K^T, on [SUM] rows Qn.Kn^T
//   through A fragments masked by row (only in warps holding a [SUM] row);
//   dP = dO.V^T, and dO.V0^T in warps holding a [SUM] row (reset); P and
//   dS in registers; dQ += scale dS.K (dS.Kn on [SUM] rows), K through
//   ldmatrix.trans. One 16 x 128 fp32 accumulator a warp serves dq and
//   dq_nope: a row writes one or the other. Registers: 64 for dQ, 16 each
//   for S, dP and dP0.
// * dk/dv pass: one CTA of 4 warps per (kv tile of 64 keys, kv head, batch
//   row); each warp owns 16 keys, the M dimension of every product, so the
//   n_rep query heads of the group are summed in registers: no atomics and
//   no per-query-head buffer. Its K, V (K_nope and V0 where a [SUM] row
//   lies in its band) are staged once; it walks, for each of the n_rep
//   query heads, the q tiles of 32 rows of the transposed band (rows
//   [k0, k0 + 63 + window]). Per tile: S^T = K.Q^T and dP^T = V.dO^T (Q
//   and dO the B operands), P^T and dS^T in the accumulator layout (lse and
//   delta index columns, d = pos_q - pos_k runs along them), then
//   dV += P^T.dO and dK += scale dS^T.Q, P^T and dS^T reused as A fragments
//   and dO and Q through ldmatrix.trans.
//   The register budget: dK and dV take 64 + 64 fp32 registers a thread
//   (16 keys x 128), S^T and dP^T 16 each (32 query columns); dK_nope and
//   dV0 would take another 128. So the pass runs in two phases that share
//   the same registers. Phase A walks the whole band for dK and dV: on
//   [SUM] columns the score is Kn.Qn^T - ALiBi d (NoPE, B fragments masked
//   by column), their P (1 - a sigma) goes to dV and their dS is left to
//   phase B. dV, and dK with NoPE, are written. Phase B clears those
//   registers and revisits, for each query head, only the q tiles of the
//   band that hold a [SUM] row (a table the CTA builds from the [SUM]
//   flags at its start), 16 query columns at a time: P and dS of the
//   [SUM] columns (S, dP and dP0 take 8 registers each), dK_nope (dK
//   without NoPE) += scale dS^T.Q and dV0 += (P a sigma)^T.dO. In DTI
//   streaming rows the [SUM] rows sit in each row's tail, so phase B
//   touches a few q tiles.
// * Overlap and skipping. Each tile's operands (K, V, and K_nope / V0
//   where live; Q, dO, and each query row's position, [SUM] flag, segment,
//   lse and delta) are copied by 16-byte (4-byte) cp.async into one of 2-3
//   shared-memory stages, ST - 1 tiles ahead of the one being computed.
//   Before a tile's one barrier (__syncthreads_or) its rows decide from
//   their staged data whether any pair of the tile may attend (the tile is
//   skipped otherwise: padding, other packed segments) and whether every
//   pair does (an interior tile, whose scores need no mask).
// * Order. Every sum runs in a fixed order, with no atomics: two calls give
//   the same bits.
// * Head-dim classes (the Cfgs' DQ). q/k head dims up to 128 (DMAX) and,
//   for deepseek-v2's MLA training (Dqk = 128 + 64, Dv 128), up to 192
//   (DWIDE). The 128 class (bf16 and fp32) and the wide class in fp32 (the
//   gates' instantiation) run the mma.sync design above: the q, K, q_nope
//   and K_nope planes' rows hold DQ + 8 values (200: conflict-free for
//   ldmatrix), V's, V0's and dO's 136; the wide fp32 class keeps a thread's
//   gradient columns past 128 in shared memory (XsAcc) and its dq CTA has
//   2 warps (32 query rows): 4 would need 245-270 KiB with NoPE.
// * Occupancy (the 128 class). bf16: 87-105 KiB of shared memory and
//   160-236 registers (nvcc -Xptxas -v, no spills), 2 CTAs (8 warps) per
//   SM. The fp32 instantiation (and bf16 rows that are not 16-byte
//   aligned) converts each tile straight from memory into its term
//   planes; fp32 takes one stage (and its dk/dv pass 2 warps, 32 keys a
//   CTA): 104-206 KiB, 1 CTA per SM.
//
// The wide class in bf16 (Dqk up to 192; `WgDqCfg`, `WgDkvCfg`) is built
// on Hopper's warpgroup products instead, because at 192 the mma.sync
// design fits one CTA of 4 warps an SM: nothing hides a warp's chain of
// products, exponentials and products (22.7x / 22.8x its bound at
// deepseek-v2's training shape, PERF.md).
// * wgmma. Two consumer warpgroups a CTA, 64 rows each (the M of every
//   product): dq, 128 query rows; dk/dv, 128 keys, so that the n_rep
//   query heads are still summed in registers. Scores and dP (S = Q.K^T,
//   dP = dO.V^T; S^T = K.Q^T, dP^T = V.dO^T) are m64n32k16 with both
//   operands in shared memory, each k-step chain issued in one asm block
//   (the compiler otherwise holds a descriptor pair a k-step); P and dS go
//   from the accumulator layout into A fragments (hi + lo bf16 pairs, as
//   before) for dQ += dS.K (m64n192k16), dV += P^T.dO (m64n128k16) and
//   dK += dS^T.Q (m64n192k16), the B operand read MN-major from the same
//   planes. Planes hold 8 x 8 core matrices without a swizzle.
// * The gradients in registers: dQ (96 floats a thread), dV (64), dK (96).
//   dK and dV together beside two score tiles need more than the 232
//   registers a consumer gets (a one-pass dk/dv was 20 % faster but
//   spilled, PERF.md), so the dk/dv pass walks its band in four phases
//   over the same staged keys: V (dV; P^T (1 - a sigma) on every column,
//   the [SUM] columns' scores from Kn.Qn^T), K (dK; dS^T on ordinary
//   columns, S^T and dP^T recomputed), B1 (dK_nope, or dK without NoPE:
//   the [SUM] columns' dS^T) and, with reset, B2 (dV0: P^T a sigma), each
//   phase's accumulator its own (one reused across phases makes the
//   compiler serialize the wgmma). ~20 % more products than one pass.
// * A producer warpgroup. It copies each tile (dq: 32 keys of K, K_nope,
//   V, V0; dk/dv: 32 query rows of Q (q_nope on [SUM] rows) and dO) and
//   its rows' metadata by cp.async into a ring of three stages, each with
//   a full and an empty mbarrier; consumers wait on full, multiply, and
//   release with empty, so the two warpgroups drift apart and one's
//   exponentials overlap the other's products (a CTA-wide barrier a tile
//   kept them in step: one warpgroup alone took 82 % of both's time).
//   Each consumer warp derives its warpgroup's liveness bits (skip a tile
//   no pair attends, drop the masks of an interior tile) from the staged
//   metadata. setmaxnreg gives the producer 40 registers and the
//   consumers 232 (the CTA's pool is 384 x 168 at launch); counts that
//   both roles need are read from shared memory after the split, since
//   ptxas spills values held across it, and the mbarrier wait has no
//   trap (with one, ptxas kept the consumers at 168 registers). ptxas:
//   no spill in any of the eight instantiations.
// * Shared memory (NoPE + reset): dq 204 KiB (Q and dO of 128 rows,
//   three stages of 40 KiB); dk/dv 224 KiB (the 128 keys' four planes,
//   160 KiB; three stages of Q and dO, 20 KiB). One CTA per SM.
// * Tried and dropped: the first wgmma version, two warpgroups in lockstep
//   on a barrier a tile (dq 13.75, dk/dv 29.32 ms); one producer warp
//   (288 threads: ptxas still targets 168 registers a thread); the
//   one-pass dk/dv above.
// Rows that are not 16-byte aligned (or head dims off 8) are staged by
// loads of the same bits in place of cp.async, so their gradients are
// those of aligned copies. `windowed_bwd_plan` in windowed_attn.py
// computes the grids, stages and shared memory of every Cfg below; the
// entry points refuse a plan that differs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int DMAX = 128;           // the value head dim's limit, and the narrow
                                    // class's q/k head dim's
constexpr int DWIDE = 192;          // the wide class's q/k head dim limit
constexpr int LDV = DMAX + 8;       // V / dO plane row stride: conflict-free fragments
constexpr int NT_V = DMAX / 8;      // n-tiles of a value head dim, and of the
                                    // part of a q/k gradient held in registers
constexpr int BK = 32;              // keys per kv tile (dq pass)
constexpr int BQT = 32;             // query rows per q tile (dk/dv pass)
constexpr int META = 4;             // per staged key: position, valid, [SUM], segment
constexpr int QMETA = 5;            // per staged query row: position, [SUM], segment, lse, delta
constexpr int BAND_TABLE = 256;     // q tiles of a dk/dv band that phase B's table holds
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }

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

// Two n-tiles of one k-step: c0 += A.B(regs 0, 1), c1 += A.B(regs 2, 3),
// summed over the term pairs ta + tb < max(NA, NB) of NA-term A and
// NB-term B fragments (one ldmatrix x4 holds a B term of both n-tiles),
// the smallest pairs first.
template <int NA, int NB>
__device__ __forceinline__ void mma2(float (&c0)[4], float (&c1)[4],
                                     const uint32_t (&a)[NA][4],
                                     const uint32_t (&b)[NB][4]) {
  constexpr int TP = NA > NB ? NA : NB;
#pragma unroll
  for (int sum = TP - 1; sum >= 0; --sum)
#pragma unroll
    for (int tb = 0; tb < NB; ++tb) {
      const int ta = sum - tb;
      if (ta >= 0 && ta < NA) {
        mma(c0, a[ta], b[tb][0], b[tb][1]);
        mma(c1, a[ta], b[tb][2], b[tb][3]);
      }
    }
}

// mma2 into a gradient accumulator that runs over a whole band. The
// tensor cores truncate each fp32 accumulation, a bias that grows with
// the length of the chain (~1e-4 of dV over a band of 1,600 query rows);
// with FRESH (the fp32 instantiation) a k-step's products go into fresh
// registers and are added to the accumulator in round-to-nearest.
template <bool FRESH, int NA, int NB>
__device__ __forceinline__ void mma2_acc(float (&c0)[4], float (&c1)[4],
                                         const uint32_t (&a)[NA][4],
                                         const uint32_t (&b)[NB][4]) {
  if constexpr (FRESH) {
    float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
    mma2<NA, NB>(t0, t1, a, b);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      c0[e] += t0[e];
      c1[e] += t1[e];
    }
  } else {
    mma2<NA, NB>(c0, c1, a, b);
  }
}

// k-step kk (16 columns) of accumulator tiles c as N-term A fragments:
// register r holds row g + 8 (r & 1) of n-tile 2 kk + (r >> 1)
template <int N, int NC>
__device__ __forceinline__ void a_frags(const float (&c)[NC][4], int kk,
                                        uint32_t (&pa)[N][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = 2 * kk + (r >> 1), hh = r & 1;
    float x0 = c[j][2 * hh], x1 = c[j][2 * hh + 1];
#pragma unroll
    for (int t = 0; t < N; ++t) {
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);   // x0 low
      pa[t][r] = *reinterpret_cast<const uint32_t*>(&h2);
      x0 -= __low2float(h2);
      x1 -= __high2float(h2);
    }
  }
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

// N terms of a fragment: one ldmatrix per term plane, planes `stride`
// values apart
template <int N>
__device__ __forceinline__ void ldsm_terms(uint32_t (&r)[N][4], const bf16* p,
                                           int stride) {
#pragma unroll
  for (int t = 0; t < N; ++t) ldsm_x4(r[t], p + t * stride);
}
template <int N>
__device__ __forceinline__ void ldsm_terms_t(uint32_t (&r)[N][4], const bf16* p,
                                             int stride) {
#pragma unroll
  for (int t = 0; t < N; ++t) ldsm_x4_t(r[t], p + t * stride);
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
  const T *q, *qn, *k, *kn, *v, *v0, *dout;
  const float *lse, *delta, *alibi;
  const int *pos_q, *pos_k, *sum_q, *sum_k, *valid_k, *seg_q, *seg_k;
  T *g0, *g1, *g2, *g3;   // dq, dq_nope | dk, dv, dk_nope, dv0
  int B, S, H, Hk, D, Dv, window, sum_isolated, use_seg, n_blocks, direct;
  float scale, y_min, y_max, midpoint;
};

// the reset weight a(d) sigma of a [SUM] row at distance dd
template <typename T>
__device__ __forceinline__ float reset_w(const Args<T>& a, int dd) {
  return a.y_min + (a.y_max - a.y_min) / (1.f + expf(-((float)dd - a.midpoint)));
}

// Tiles, terms, stages and shared memory per instantiation (see the
// header); `windowed_bwd_plan` in windowed_attn.py mirrors both Cfgs. DQ
// is the head-dim class of q and K (DMAX or DWIDE): the q, K, q_nope and
// K_nope planes' rows hold DQ + 8 values (LDQ), V's, V0's and dO's LDV.
// XS is the floats of the wide class's gradient columns past DMAX, kept in
// shared memory (`XsAcc`).
template <typename T, bool NOPE, bool RESET, int DQ>
struct DqCfg {
  static constexpr bool F32 = sizeof(T) == 4, WIDE = DQ > DMAX;
  static constexpr int LDQ = DQ + 8;
  // fp32 at the wide class: 2 warps, or Q, dO and a stage of K, K_nope, V
  // and V0 in three terms would pass 227 KB
  static constexpr int WARPS = (F32 && WIDE) ? 2 : 4, THREADS = 32 * WARPS;
  static constexpr int CTAS = WIDE ? 1 : 2;           // CTAs per SM (launch bounds)
  static constexpr int BQ = 16 * WARPS;               // query rows per CTA
  static constexpr int NT = F32 ? 3 : 1;              // terms of q, dO, K, V, K_nope, V0
  static constexpr int NP = F32 ? 3 : 2;              // terms of dS
  static constexpr int KPL = NT * (1 + NOPE);         // K, K_nope planes (LDQ)
  static constexpr int PLANES = NT * (2 + NOPE + RESET);   // K, K_nope, V, V0
  static constexpr int STAGES = F32 ? 1 : (PLANES <= 2 ? 3 : 2);
  static constexpr int MS = STAGES > 1 ? STAGES : 2;  // metadata ring
  static constexpr size_t ROW_ELEMS = (size_t)NT * BQ * (LDQ + LDV);   // Q, dO
  static constexpr size_t STAGE_ELEMS =
      (size_t)KPL * BK * LDQ + (size_t)(PLANES - KPL) * BK * LDV;
  static constexpr int XS = (DQ - DMAX) / 8 * 4 * THREADS;
  static constexpr size_t BYTES = (ROW_ELEMS + STAGES * STAGE_ELEMS) * sizeof(bf16) +
                                  (size_t)(MS * META * BK + 5 * BQ + BQ / 8 + MS + XS) * sizeof(int);
};

template <typename T, bool NOPE, bool RESET, int DQ>
struct DkvCfg {
  static constexpr bool F32 = sizeof(T) == 4, WIDE = DQ > DMAX;
  static constexpr int LDQ = DQ + 8;
  static constexpr int WARPS = F32 ? 2 : 4, THREADS = 32 * WARPS;
  static constexpr int CTAS = WIDE ? 1 : 2;           // CTAs per SM (launch bounds)
  static constexpr int BKV = 16 * WARPS;              // keys per CTA
  static constexpr int BQ = BQT;                      // query rows per q tile
  static constexpr int NT = F32 ? 3 : 1;              // terms of K, V, K_nope, V0, q, dO
  static constexpr int NP = F32 ? 3 : 2;              // terms of P, P a sigma, dS
  static constexpr int KPK = NT * (1 + NOPE);         // K, K_nope planes (LDQ)
  static constexpr int KPL = NT * (2 + NOPE + RESET);   // K, K_nope, V, V0
  static constexpr int STAGES = F32 ? 1 : (KPL <= 3 ? 3 : 2);
  static constexpr int MS = STAGES > 1 ? STAGES : 2;  // row-data ring
  static constexpr size_t KEY_ELEMS =
      (size_t)KPK * BKV * LDQ + (size_t)(KPL - KPK) * BKV * LDV;
  static constexpr size_t STAGE_ELEMS = (size_t)NT * BQ * (LDQ + LDV);   // Q, dO
  static constexpr int XS = (DQ - DMAX) / 8 * 4 * THREADS;
  static constexpr size_t BYTES =
      (KEY_ELEMS + STAGES * STAGE_ELEMS) * sizeof(bf16) +
      (size_t)(MS * QMETA * BQ + MS + 8 * WARPS + BAND_TABLE / 4 + BAND_TABLE / 2 + 1 + XS) *
          sizeof(int);
};

// The wide class's gradient columns past DMAX (dQ in the dq pass; dK, or
// dK_nope, in the dk/dv pass) in shared memory, so that the accumulators a
// thread holds in registers are those of the 128 class: this thread's
// fragment element e of n-tile NT_V + j lies at xs[(4 j + e) THREADS +
// tid] (a warp's accesses conflict-free). Each thread reads and writes its
// own elements only: no barrier. A k-step's products go into fresh
// registers, added here in round-to-nearest.
template <int THREADS>
struct XsAcc {
  float* xs;
  int tid;
  __device__ __forceinline__ float& at(int j, int e) const {
    return xs[(4 * j + e) * THREADS + tid];
  }
  __device__ __forceinline__ void add(int j, const float (&c)[4]) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) at(j, e) += c[e];
  }
  template <int NJ>
  __device__ __forceinline__ void clear() const {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) at(j, e) = 0.f;
  }
};

// ---------------------------------------------------------------------------
// the dq pass
// ---------------------------------------------------------------------------

template <typename T, bool NOPE, bool RESET, int DQ>
__global__ void __launch_bounds__(DqCfg<T, NOPE, RESET, DQ>::THREADS,
                                  DqCfg<T, NOPE, RESET, DQ>::CTAS)
dq_kernel(const Args<T> a) {
  using C = DqCfg<T, NOPE, RESET, DQ>;
  constexpr int BQ = C::BQ, NT = C::NT, NP = C::NP, ST = C::STAGES, MS = C::MS;
  constexpr int THREADS = C::THREADS, WARPS = C::WARPS, LDQ = C::LDQ;
  // planes of a stage: K terms, K_nope terms (LDQ wide), V terms, V0 terms
  // (LDV wide)
  constexpr int PK = 0, PKN = NT, PV = NT + (NOPE ? NT : 0), PV0 = PV + NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_p = reinterpret_cast<bf16*>(smem_raw);   // q (q_nope on [SUM] rows)
  bf16* do_p = q_p + (size_t)NT * BQ * LDQ;         // dO
  bf16* st_p = q_p + C::ROW_ELEMS;
  int* meta = reinterpret_cast<int*>(st_p + ST * C::STAGE_ELEMS);
  int* pos_r = meta + MS * META * BK;
  int* sum_r = pos_r + BQ;
  int* seg_r = sum_r + BQ;
  float* lse_r = reinterpret_cast<float*>(seg_r + BQ);
  float* dl_r = lse_r + BQ;
  int* red = reinterpret_cast<int*>(dl_r + BQ);   // per warp of rows: least, greatest position, segment
  int* interior = red + BQ / 8;   // per ring slot: every pair of the tile attends
  const XsAcc<THREADS> xs{reinterpret_cast<float*>(interior + MS), (int)threadIdx.x};
  auto plane = [&](int st, int p) {
    return st_p + st * C::STAGE_ELEMS +
           (p < C::KPL ? (size_t)p * BK * LDQ
                       : (size_t)C::KPL * BK * LDQ + (size_t)(p - C::KPL) * BK * LDV);
  };
  auto meta_of = [&](int i) { return meta + (i % MS) * META * BK; };

  const int h = blockIdx.x, iq = a.n_blocks - 1 - (int)blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hk);
  const int S = a.S, D = a.D, Dv = a.Dv;
  const int q0 = iq * BQ, nr = min(BQ, S - q0);
  const int DP = (D + 15) & ~15, DVP = (Dv + 15) & ~15;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, cq = lane & 3;
  const bool direct = !C::F32 && a.direct;     // copies by cp.async

  // the q tile's rows: position, [SUM] flag, segment, lse (times log2 e,
  // +1e30 past S), delta, and each warp's least and greatest position and
  // segment
  if (tid < BQ) {
    const bool in = tid < nr;
    const size_t bs = (size_t)b * S + q0 + tid;
    const size_t hr = ((size_t)b * a.H + h) * S + q0 + tid;
    const int p = in ? a.pos_q[bs] : 0;
    const int sm = (in && a.sum_q != nullptr) ? (a.sum_q[bs] != 0) : 0;
    const int sg = (in && a.use_seg) ? a.seg_q[bs] : 0;
    pos_r[tid] = p;
    sum_r[tid] = sm;
    seg_r[tid] = sg;
    lse_r[tid] = (in ? a.lse[hr] : 1e30f) * LOG2E;
    dl_r[tid] = in ? a.delta[hr] : 0.f;
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
    for (int i = tid; i < (int)(C::ROW_ELEMS + ST * C::STAGE_ELEMS); i += THREADS)
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

  // Q (q_nope on [SUM] rows, NoPE) and dO, zero past D, Dv and S: by
  // cp.async in tile 0's group, or converted into NT term planes.
  if (direct) {
    for (int idx = tid; idx < BQ * (D / 8); idx += THREADS) {
      const int r = idx / (D / 8), ch = idx - r * (D / 8);
      const bool in = r < nr;
      const T* src = (NOPE && sum_r[r]) ? a.qn : a.q;
      cp16(q_p + r * LDQ + ch * 8,
           src + (((size_t)b * S + q0 + (in ? r : 0)) * a.H + h) * D + ch * 8, in);
    }
    for (int idx = tid; idx < BQ * (Dv / 8); idx += THREADS) {
      const int r = idx / (Dv / 8), ch = idx - r * (Dv / 8);
      const bool in = r < nr;
      cp16(do_p + r * LDV + ch * 8,
           a.dout + (((size_t)b * S + q0 + (in ? r : 0)) * a.H + h) * Dv + ch * 8, in);
    }
  } else {
    for (int idx = tid; idx < BQ * DP; idx += THREADS) {
      const int r = idx / DP, d = idx - r * DP;
      float x = 0.f;
      if (r < nr && d < D) {
        const T* src = (NOPE && sum_r[r]) ? a.qn : a.q;
        x = to_f(src[(((size_t)b * S + q0 + r) * a.H + h) * D + d]);
      }
      split_store<NT>(x, q_p + r * LDQ + d, BQ * LDQ);
    }
    for (int idx = tid; idx < BQ * DVP; idx += THREADS) {
      const int r = idx / DVP, d = idx - r * DVP;
      const float x = (r < nr && d < Dv)
                          ? to_f(a.dout[(((size_t)b * S + q0 + r) * a.H + h) * Dv + d])
                          : 0.f;
      split_store<NT>(x, do_p + r * LDV + d, BQ * LDV);
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
  // (an interior tile), whose scores need no mask.
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
    for (int j = 0; j < BK / (THREADS / 16); ++j) {
      const int c = c0 + (THREADS / 16) * j, kj = k0 + c;
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
        split_store<NT>(on ? to_f(a.k[row * D + d]) : 0.f, plane(st, PK) + c * LDQ + d, BK * LDQ);
        if (NOPE && any_sum)
          split_store<NT>(on ? to_f(a.kn[row * D + d]) : 0.f, plane(st, PKN) + c * LDQ + d, BK * LDQ);
      }
      for (int d = lane; d < DVP; d += 32) {
        const bool on = ok && d < Dv;
        split_store<NT>(on ? to_f(a.v[row * Dv + d]) : 0.f, plane(st, PV) + c * LDV + d, BK * LDV);
        if (RESET && any_sum)
          split_store<NT>(on ? to_f(a.v0[row * Dv + d]) : 0.f, plane(st, PV0) + c * LDV + d, BK * LDV);
      }
    }
  };

  // this thread's rows: hh = 0, 1 is row g + 8 hh of the warp's 16
  const int wr0 = warp * 16;
  const bool w_live = wr0 < nr;
  int pq[2], sg[2];
  bool rin[2], rsum[2];
  float l2[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = wr0 + g + 8 * hh;
    rin[hh] = r < nr;
    pq[hh] = pos_r[r];
    sg[hh] = seg_r[r];
    rsum[hh] = sum_r[r] != 0;
    l2[hh] = lse_r[r];
    dl[hh] = dl_r[r];
  }
  // which products the warp's rows need: with a [SUM] row, Qn.Kn^T and
  // dS.Kn (NoPE) and dO.V0^T (reset)
  const bool w_sum = __any_sync(FULL, rsum[0] || rsum[1]);
  const bool w_n = NOPE && w_sum;
  const bool w_r = RESET && w_sum;
  const float sl2 = a.scale * LOG2E;
  const float al2 = NOPE ? a.alibi[h] * LOG2E : 0.f;
  const unsigned wlim = (unsigned)a.window;
  // dQ: columns below DMAX in registers, the wide class's rest in xs
  float acc[NT_V][4];
#pragma unroll
  for (int j = 0; j < NT_V; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  xs.template clear<(DQ - DMAX) / 8>();

  // fragment offsets in planes of LDQ (q, K, K_nope) and LDV (dO, V, V0)
  const int koffq = ((lane & 7) + (lane >> 4) * 8) * LDQ + ((lane >> 3) & 1) * 8;
  const int koffv = ((lane & 7) + (lane >> 4) * 8) * LDV + ((lane >> 3) & 1) * 8;
  const int voffq = ((lane & 7) + ((lane >> 3) & 1) * 8) * LDQ + (lane >> 4) * 8;
  const int arowq = (wr0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDQ + (lane >> 4) * 8;
  const int arowv = (wr0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDV + (lane >> 4) * 8;

  auto compute = [&](int i) {
    const int st = i % ST;
    const int* mt_ = meta_of(i);
    float sc[4][4], dp[4][4], d0[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = d0[j][e] = 0.f;
    // S = Q.K^T; with [SUM] rows in the warp, Qn.Kn^T on their rows
    for (int kd = 0; kd < DP / 16; ++kd) {
      uint32_t fq[NT][4], fk[2][NT][4];
      ldsm_terms<NT>(fq, q_p + arowq + kd * 16, BQ * LDQ);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
        ldsm_terms<NT>(fk[jp], plane(st, PK) + jp * 16 * LDQ + koffq + kd * 16, BK * LDQ);
      if (w_n) {
        uint32_t fn[2][NT][4], fo[NT][4], fs[NT][4];
#pragma unroll
        for (int jp = 0; jp < 2; ++jp)
          ldsm_terms<NT>(fn[jp], plane(st, PKN) + jp * 16 * LDQ + koffq + kd * 16, BK * LDQ);
        // A fragments: registers 0 and 2 hold row g, 1 and 3 row g + 8
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool s = rsum[e & 1];
            fo[t][e] = s ? 0u : fq[t][e];
            fs[t][e] = s ? fq[t][e] : 0u;
          }
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          mma2<NT, NT>(sc[2 * jp], sc[2 * jp + 1], fo, fk[jp]);
          mma2<NT, NT>(sc[2 * jp], sc[2 * jp + 1], fs, fn[jp]);
        }
      } else {
#pragma unroll
        for (int jp = 0; jp < 2; ++jp)
          mma2<NT, NT>(sc[2 * jp], sc[2 * jp + 1], fq, fk[jp]);
      }
    }
    // dP = dO.V^T; with [SUM] rows in the warp and reset, dP0 = dO.V0^T
    for (int kd = 0; kd < DVP / 16; ++kd) {
      uint32_t fo[NT][4], fv[2][NT][4];
      ldsm_terms<NT>(fo, do_p + arowv + kd * 16, BQ * LDV);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
        ldsm_terms<NT>(fv[jp], plane(st, PV) + jp * 16 * LDV + koffv + kd * 16, BK * LDV);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
        mma2<NT, NT>(dp[2 * jp], dp[2 * jp + 1], fo, fv[jp]);
      if (w_r) {
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t f0[NT][4];
          ldsm_terms<NT>(f0, plane(st, PV0) + jp * 16 * LDV + koffv + kd * 16, BK * LDV);
          mma2<NT, NT>(d0[2 * jp], d0[2 * jp + 1], fo, f0);
        }
      }
    }

    // P and dS = scale P (dP - delta), in place of the scores; element
    // (j, 2 hh + e) is row g + 8 hh, key column j * 8 + 2 cq + e
    int cpk[4][2], cfl[4][2], csg[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
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
    auto pds = [&](auto all) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int f = cfl[j][e], dd = pq[hh] - cpk[j][e];
            // valid, causal and in the window (one unsigned compare),
            // isolated [SUM] keys only at distance 0, the same segment
            const bool ok = decltype(all)::value ||
                            ((f & 1) && (unsigned)dd <= wlim &&
                             (!(f & 2) || dd == 0) && csg[j][e] == sg[hh]);
            float x = sc[j][2 * hh + e] * sl2;
            if (NOPE && rsum[hh]) x -= al2 * (float)dd;
            const float p = ok ? ex2(x - l2[hh]) : 0.f;
            float dpx = dp[j][2 * hh + e];
            if (w_r && rsum[hh]) dpx += reset_w(a, dd) * (d0[j][2 * hh + e] - dpx);
            sc[j][2 * hh + e] = a.scale * p * (dpx - dl[hh]);
          }
    };
    if (interior[i % MS]) pds(std::true_type());
    else pds(std::false_type());

    // dQ += dS.K (dS.Kn on [SUM] rows), K through ldmatrix.trans: 16
    // output columns at a time, both k-steps of 16 keys each
    uint32_t pa[BK / 16][NP][4], po[BK / 16][NP][4], ps[BK / 16][NP][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      a_frags<NP>(sc, kk, pa[kk]);
      if (w_n) {
#pragma unroll
        for (int t = 0; t < NP; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool s = rsum[e & 1];
            po[kk][t][e] = s ? 0u : pa[kk][t][e];
            ps[kk][t][e] = s ? pa[kk][t][e] : 0u;
          }
      }
    }
#pragma unroll
    for (int c16 = 0; c16 < NT_V / 2; ++c16) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        if (c16 * 16 < DP) {
          uint32_t bk[NT][4];
          ldsm_terms_t<NT>(bk, plane(st, PK) + kk * 16 * LDQ + voffq + c16 * 16, BK * LDQ);
          if (w_n) {
            uint32_t bn[NT][4];
            ldsm_terms_t<NT>(bn, plane(st, PKN) + kk * 16 * LDQ + voffq + c16 * 16, BK * LDQ);
            mma2_acc<C::F32, NP, NT>(acc[2 * c16], acc[2 * c16 + 1], po[kk], bk);
            mma2_acc<C::F32, NP, NT>(acc[2 * c16], acc[2 * c16 + 1], ps[kk], bn);
          } else {
            mma2_acc<C::F32, NP, NT>(acc[2 * c16], acc[2 * c16 + 1], pa[kk], bk);
          }
        }
      }
    }
    // the wide class's columns past DMAX: each k-step into fresh
    // registers, added to xs
#pragma unroll
    for (int c16 = NT_V / 2; c16 < DQ / 16; ++c16) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        if (c16 * 16 < DP) {
          float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
          uint32_t bk[NT][4];
          ldsm_terms_t<NT>(bk, plane(st, PK) + kk * 16 * LDQ + voffq + c16 * 16, BK * LDQ);
          if (w_n) {
            uint32_t bn[NT][4];
            ldsm_terms_t<NT>(bn, plane(st, PKN) + kk * 16 * LDQ + voffq + c16 * 16, BK * LDQ);
            mma2<NP, NT>(t0, t1, po[kk], bk);   // row-masked: each element
            mma2<NP, NT>(t0, t1, ps[kk], bn);   // takes one of the two
          } else {
            mma2<NP, NT>(t0, t1, pa[kk], bk);
          }
          xs.add(2 * c16 - NT_V, t0);
          xs.add(2 * c16 + 1 - NT_V, t1);
        }
      }
    }
  };

  // The pipeline (cp.async groups, one per tile, Q and dO in the first):
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

  // a [SUM] row's gradient is dq_nope's, an ordinary row's dq's; the
  // other output's row is 0
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (!rin[hh]) continue;
    const int qi = q0 + wr0 + g + 8 * hh;
    const size_t ob = (((size_t)b * S + qi) * a.H + h) * D;
    const bool to_n = NOPE && rsum[hh];
#pragma unroll
    for (int j = 0; j < DQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * cq + e;
        if (col < D) {
          const float x = j < NT_V ? acc[j < NT_V ? j : 0][2 * hh + e]
                                   : xs.at(j - NT_V, 2 * hh + e);
          store(a.g0 + ob + col, to_n ? 0.f : x);
          if (NOPE) store(a.g1 + ob + col, to_n ? x : 0.f);
        }
      }
  }
}

// ---------------------------------------------------------------------------
// the dk/dv pass
// ---------------------------------------------------------------------------

template <typename T, bool NOPE, bool RESET, int DQ>
__global__ void __launch_bounds__(DkvCfg<T, NOPE, RESET, DQ>::THREADS,
                                  DkvCfg<T, NOPE, RESET, DQ>::CTAS)
dkv_kernel(const Args<T> a) {
  using C = DkvCfg<T, NOPE, RESET, DQ>;
  constexpr int WARPS = C::WARPS, THREADS = C::THREADS, BKV = C::BKV, BQ = C::BQ;
  constexpr int NT = C::NT, NP = C::NP, ST = C::STAGES, MS = C::MS, LDQ = C::LDQ;
  constexpr bool SUMC = NOPE || RESET;    // [SUM] columns' dS goes to phase B
  // key planes: K, K_nope terms (LDQ wide), V, V0 terms (LDV wide); stage
  // planes: Q terms (LDQ), dO terms (LDV)
  constexpr int PK = 0, PKN = NT, PV = NT + (NOPE ? NT : 0), PV0 = PV + NT;
  constexpr int PQ = 0, PDO = NT;
  constexpr int RPT = BQ * 16 / THREADS;    // q-tile rows a thread copies
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_p = reinterpret_cast<bf16*>(smem_raw);
  bf16* st_p = k_p + C::KEY_ELEMS;
  int* qmeta = reinterpret_cast<int*>(st_p + ST * C::STAGE_ELEMS);
  int* tinfo = qmeta + MS * QMETA * BQ;   // per ring slot: interior, [SUM] rows (all, per half)
  int* red = tinfo + MS;                  // per warp: the keys' least, greatest position, segment; plain
  unsigned char* bflag = reinterpret_cast<unsigned char*>(red + 8 * WARPS);
  short* btile = reinterpret_cast<short*>(bflag + BAND_TABLE);
  int* nbv = reinterpret_cast<int*>(btile + BAND_TABLE);
  const XsAcc<THREADS> xs{reinterpret_cast<float*>(nbv + 1), (int)threadIdx.x};
  auto kplane = [&](int p) {
    return k_p + (p < C::KPK ? (size_t)p * BKV * LDQ
                             : (size_t)C::KPK * BKV * LDQ + (size_t)(p - C::KPK) * BKV * LDV);
  };
  auto splane = [&](int st, int p) {
    return st_p + st * C::STAGE_ELEMS +
           (p < NT ? (size_t)p * BQ * LDQ : (size_t)NT * BQ * LDQ + (size_t)(p - NT) * BQ * LDV);
  };
  // q tile item i's rows in ring slot i % MS: positions, [SUM] flags,
  // segments, lse, delta (fp32 bits)
  auto meta_of = [&](int i) { return qmeta + (i % MS) * QMETA * BQ; };

  const int ik = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_rep = a.H / a.Hk;
  const int S = a.S, D = a.D, Dv = a.Dv;
  const int k0 = ik * BKV;
  const int DP = (D + 15) & ~15, DVP = (Dv + 15) & ~15;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, cq = lane & 3;
  const bool direct = !C::F32 && a.direct;     // copies by cp.async

  // this thread's keys: hh = 0, 1 is key g + 8 hh of the warp's 16; flag
  // bit 0 an attendable key, bit 1 an isolated [SUM] key
  const int wk0 = warp * 16;
  int kpos[2], kfl[2], ksg[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kj = k0 + wk0 + g + 8 * hh;
    const bool in = kj < S;
    const size_t bs = (size_t)b * S + (in ? kj : 0);
    kpos[hh] = in ? a.pos_k[bs] : 0;
    const bool ok = in && (a.valid_k == nullptr || a.valid_k[bs] != 0);
    const int sk = (in && a.sum_isolated) ? (a.sum_k[bs] != 0) : 0;
    kfl[hh] = ok ? (1 | (sk << 1)) : 0;
    ksg[hh] = (in && a.use_seg) ? a.seg_k[bs] : 0;
  }
  // the CTA's attendable keys: least and greatest position and segment,
  // and whether every key is plain (< S, valid, not an isolated [SUM] key)
  {
    int lo = INT_MAX, hi = INT_MIN, slo = INT_MAX, shi = INT_MIN;
    bool plain = true;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (kfl[hh] & 1) {
        lo = min(lo, kpos[hh]);
        hi = max(hi, kpos[hh]);
        slo = min(slo, ksg[hh]);
        shi = max(shi, ksg[hh]);
      }
      plain = plain && kfl[hh] == 1;
    }
    lo = __reduce_min_sync(FULL, lo);
    hi = __reduce_max_sync(FULL, hi);
    slo = __reduce_min_sync(FULL, slo);
    shi = __reduce_max_sync(FULL, shi);
    plain = __all_sync(FULL, plain);
    if (lane == 0) {
      red[8 * warp] = lo;
      red[8 * warp + 1] = hi;
      red[8 * warp + 2] = slo;
      red[8 * warp + 3] = shi;
      red[8 * warp + 4] = plain;
    }
  }

  // the transposed band: q tiles holding rows [k0, k0 + BKV - 1 + window]
  const int qb_lo = k0 / BQ;
  const int qb_hi = (int)(min((long long)k0 + BKV - 1 + a.window, (long long)S - 1) / BQ);
  const int n_band = qb_hi - qb_lo + 1;
  const bool table = n_band <= BAND_TABLE;
  // which of them hold a [SUM] row (a warp per tile, a lane per row)
  if (SUMC && table) {
    for (int t = warp; t < n_band; t += WARPS) {
      const int row = (qb_lo + t) * BQ + lane;
      const bool f = row < S && a.sum_q[(size_t)b * S + row] != 0;
      const bool any = __any_sync(FULL, f);
      if (lane == 0) bflag[t] = any;
    }
  }
  if (direct && ((D | Dv) & 15)) {   // pads cp.async never writes
    for (int i = tid; i < (int)(C::KEY_ELEMS + ST * C::STAGE_ELEMS); i += THREADS)
      k_p[i] = __ushort_as_bfloat16((unsigned short)0);
  }
  __syncthreads();
  int kmin = INT_MAX, kmax = INT_MIN, ksmin = INT_MAX, ksmax = INT_MIN;
  bool kplain = true;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    kmin = min(kmin, red[8 * w]);
    kmax = max(kmax, red[8 * w + 1]);
    ksmin = min(ksmin, red[8 * w + 2]);
    ksmax = max(ksmax, red[8 * w + 3]);
    kplain = kplain && red[8 * w + 4] != 0;
  }
  // phase B's table: the band's q tiles that hold a [SUM] row, in order
  if (SUMC && table && warp == 0) {
    int base = 0;
    for (int c = 0; c < n_band; c += 32) {
      const bool f = c + lane < n_band && bflag[c + lane];
      const unsigned m = __ballot_sync(FULL, f);
      if (f) btile[base + __popc(m & ((1u << lane) - 1u))] = (short)(c + lane);
      base += __popc(m);
    }
    if (lane == 0) *nbv = base;
  }
  __syncthreads();
  // items: phase A, every (query head, q tile) of the band; phase B, every
  // (query head, q tile with a [SUM] row); a band longer than the table
  // revisits every tile in phase B
  const int nB = !SUMC ? 0 : (table ? *nbv : n_band);
  const int nA = n_rep * n_band, n_items = nA + n_rep * nB;
  const bool kx = nB > 0;     // K_nope, V0 are read
  auto item = [&](int i, int& rep, int& qt) {
    if constexpr (SUMC) {
      if (i >= nA) {
        const int k = i - nA;
        rep = k / nB;
        const int t = k - rep * nB;
        qt = qb_lo + (table ? (int)btile[t] : t);
        return;
      }
    }
    rep = i / n_band;
    qt = qb_lo + (i - rep * n_band);
  };

  // the CTA's keys, once: by cp.async in item 0's group, or converted into
  // NT term planes (zero past D, Dv and S)
  if (direct) {
    const int ch = tid & 15;
    for (int c = tid >> 4; c < BKV; c += THREADS / 16) {
      const int kj = k0 + c;
      const bool ok = kj < S;
      const size_t row = ((size_t)b * S + (ok ? kj : 0)) * a.Hk + hk;
#pragma unroll
      for (int u = 0; u < (DQ / 8 + 15) / 16; ++u) {   // K rows past 128 values
        const int cu = ch + 16 * u;
        if (cu < D / 8) {
          cp16(kplane(PK) + c * LDQ + cu * 8, a.k + row * D + cu * 8, ok);
          if (NOPE && kx) cp16(kplane(PKN) + c * LDQ + cu * 8, a.kn + row * D + cu * 8, ok);
        }
      }
      if (ch < Dv / 8) {
        cp16(kplane(PV) + c * LDV + ch * 8, a.v + row * Dv + ch * 8, ok);
        if (RESET && kx) cp16(kplane(PV0) + c * LDV + ch * 8, a.v0 + row * Dv + ch * 8, ok);
      }
    }
  } else {
    for (int c = warp; c < BKV; c += WARPS) {
      const int kj = k0 + c;
      const bool ok = kj < S;
      const size_t row = ((size_t)b * S + (ok ? kj : 0)) * a.Hk + hk;
      for (int d = lane; d < DP; d += 32) {
        const bool on = ok && d < D;
        split_store<NT>(on ? to_f(a.k[row * D + d]) : 0.f, kplane(PK) + c * LDQ + d, BKV * LDQ);
        if (NOPE && kx)
          split_store<NT>(on ? to_f(a.kn[row * D + d]) : 0.f, kplane(PKN) + c * LDQ + d, BKV * LDQ);
      }
      for (int d = lane; d < DVP; d += 32) {
        const bool on = ok && d < Dv;
        split_store<NT>(on ? to_f(a.v[row * Dv + d]) : 0.f, kplane(PV) + c * LDV + d, BKV * LDV);
        if (RESET && kx)
          split_store<NT>(on ? to_f(a.v0[row * Dv + d]) : 0.f, kplane(PV0) + c * LDV + d, BKV * LDV);
      }
    }
  }

  // [SUM] flags of the rows this thread copies for item i (NoPE: those
  // rows take q_nope), loaded an item ahead of the copies
  auto row_flags = [&](int i, int (&fl)[RPT]) {
    int rep, qt;
    item(i, rep, qt);
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int row = qt * BQ + (tid >> 4) + (THREADS / 16) * j;
      fl[j] = (NOPE && row < S) ? (a.sum_q[(size_t)b * S + row] != 0) : 0;
    }
  };
  // item i's copies into stage i % ST and ring slot i % MS: thread tid < BQ
  // copies row tid's data, every thread chunk tid % 16 of rows tid / 16 +
  // (THREADS / 16) j of Q and dO; rows past S are zero-filled
  auto issue = [&](int i, const int (&fl)[RPT]) {
    int rep, qt;
    item(i, rep, qt);
    const int h = hk * n_rep + rep, q0 = qt * BQ, st = i % ST;
    int* m = meta_of(i);
    if (tid < BQ) {
      const int row = q0 + tid;
      const bool in = row < S;
      const size_t bs = (size_t)b * S + (in ? row : 0);
      const size_t hr = ((size_t)b * a.H + h) * S + (in ? row : 0);
      cp4(m + tid, a.pos_q + bs, in);
      if (SUMC) cp4(m + BQ + tid, a.sum_q + bs, in);
      if (a.use_seg) cp4(m + 2 * BQ + tid, a.seg_q + bs, in);
      cp4(m + 3 * BQ + tid, a.lse + hr, in);
      cp4(m + 4 * BQ + tid, a.delta + hr, in);
    }
    const int ch = tid & 15;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int r = (tid >> 4) + (THREADS / 16) * j, row = q0 + r;
      const bool ok = row < S;
      const size_t qr = ((size_t)b * S + (ok ? row : 0)) * a.H + h;
#pragma unroll
      for (int u = 0; u < (DQ / 8 + 15) / 16; ++u) {   // q rows past 128 values
        const int cu = ch + 16 * u;
        if (cu < D / 8)
          cp16(splane(st, PQ) + r * LDQ + cu * 8, ((NOPE && fl[j]) ? a.qn : a.q) + qr * D + cu * 8,
               ok);
      }
      if (ch < Dv / 8)
        cp16(splane(st, PDO) + r * LDV + ch * 8, a.dout + qr * Dv + ch * 8, ok);
    }
  };
  // the fp32 (and unaligned bf16) path: item i's row data, then its rows
  // converted into the term planes of stage i % ST, a warp per row
  auto meta_sync = [&](int i) {
    if (tid >= BQ) return;
    int rep, qt;
    item(i, rep, qt);
    const int h = hk * n_rep + rep, row = qt * BQ + tid;
    const bool in = row < S;
    const size_t bs = (size_t)b * S + (in ? row : 0);
    const size_t hr = ((size_t)b * a.H + h) * S + (in ? row : 0);
    int* m = meta_of(i);
    m[tid] = in ? a.pos_q[bs] : 0;
    if (SUMC) m[BQ + tid] = in ? a.sum_q[bs] : 0;
    if (a.use_seg) m[2 * BQ + tid] = in ? a.seg_q[bs] : 0;
    m[3 * BQ + tid] = in ? __float_as_int(a.lse[hr]) : 0;
    m[4 * BQ + tid] = in ? __float_as_int(a.delta[hr]) : 0;
  };
  auto convert = [&](int i) {
    int rep, qt;
    item(i, rep, qt);
    const int h = hk * n_rep + rep, q0 = qt * BQ, st = i % ST;
    for (int r = warp; r < BQ; r += WARPS) {
      const int row = q0 + r;
      const bool ok = row < S;
      const size_t qr = ((size_t)b * S + (ok ? row : 0)) * a.H + h;
      const T* src = (NOPE && ok && a.sum_q[(size_t)b * S + row] != 0) ? a.qn : a.q;
      for (int d = lane; d < DP; d += 32) {
        const bool on = ok && d < D;
        split_store<NT>(on ? to_f(src[qr * D + d]) : 0.f, splane(st, PQ) + r * LDQ + d, BQ * LDQ);
      }
      for (int d = lane; d < DVP; d += 32) {
        const bool on = ok && d < Dv;
        split_store<NT>(on ? to_f(a.dout[qr * Dv + d]) : 0.f, splane(st, PDO) + r * LDV + d, BQ * LDV);
      }
    }
  };
  // Warp 0, a lane per query row, once item i's row data has landed (its
  // own copies): whether some key of the CTA may be attended by a row of
  // the tile (returned), and in tinfo whether every pair attends (an
  // interior tile) and which 16-row halves hold a [SUM] row
  auto tile_live = [&](int i) {
    if (warp != 0) return false;
    int rep, qt;
    item(i, rep, qt);
    const int* m = meta_of(i);
    const bool in = qt * BQ + lane < S;
    const int pq = m[lane];
    const int sgq = a.use_seg ? m[2 * BQ + lane] : 0;
    const bool sm = SUMC && in && m[BQ + lane] != 0;
    bool live = in && pq >= kmin && (long long)pq - a.window <= kmax;
    bool all = in && kplain && pq >= kmax && (long long)pq - kmin <= a.window;
    if (a.use_seg) {
      live = live && sgq >= ksmin && sgq <= ksmax;
      all = all && sgq == ksmin && ksmin == ksmax;
    }
    all = __all_sync(FULL, all);
    const unsigned bal = __ballot_sync(FULL, sm);
    if (lane == 0)
      tinfo[i % MS] = (int)all | ((bal != 0u) << 1) | (((bal & 0xffffu) != 0u) << 2) |
                      (((bal >> 16) != 0u) << 3);
    return live;
  };

  const bool w_live = k0 + wk0 < S;
  const float sl2 = a.scale * LOG2E;
  const unsigned wlim = (unsigned)a.window;
  // phase A: X = dK, Y = dV; phase B: X = dK_nope (dK without NoPE),
  // Y = dV0. X's columns past DMAX (the wide class) lie in xs.
  float X[NT_V][4], Y[NT_V][4];
#pragma unroll
  for (int j = 0; j < NT_V; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) X[j][e] = Y[j][e] = 0.f;
  xs.template clear<(DQ - DMAX) / 8>();

  // fragment offsets in planes of LDQ (K, K_nope, q) and LDV (V, V0, dO)
  const int koffq = ((lane & 7) + (lane >> 4) * 8) * LDQ + ((lane >> 3) & 1) * 8;
  const int koffv = ((lane & 7) + (lane >> 4) * 8) * LDV + ((lane >> 3) & 1) * 8;
  const int voffq = ((lane & 7) + ((lane >> 3) & 1) * 8) * LDQ + (lane >> 4) * 8;
  const int voffv = ((lane & 7) + ((lane >> 3) & 1) * 8) * LDV + (lane >> 4) * 8;
  const int arowq = (wk0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDQ + (lane >> 4) * 8;
  const int arowv = (wk0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDV + (lane >> 4) * 8;

  // columns past DMAX (only X's reach them) are read from xs
  auto write = [&](const float (&acc)[NT_V][4], T* out, int dim) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int kj = k0 + wk0 + g + 8 * hh;
      if (kj >= S) continue;
      const size_t ob = (((size_t)b * S + kj) * a.Hk + hk) * dim;
#pragma unroll
      for (int j = 0; j < DQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = j * 8 + 2 * cq + e;
          if (col < dim)
            store(out + ob + col, j < NT_V ? acc[j < NT_V ? j : 0][2 * hh + e]
                                           : xs.at(j - NT_V, 2 * hh + e));
        }
    }
  };
  auto clear = [&](float (&acc)[NT_V][4]) {
#pragma unroll
    for (int j = 0; j < NT_V; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  };
  // end of phase A: dV, and dK with NoPE, are final
  auto flush_a = [&]() {
    write(Y, a.g1, Dv);
    clear(Y);
    if (NOPE) {
      write(X, a.g0, D);
      clear(X);
      xs.template clear<(DQ - DMAX) / 8>();
    }
  };

  // Phase A, item i: S^T = K.Q^T (Kn.Qn^T on [SUM] columns), dP^T = V.dO^T
  // over the tile's 32 query columns; element (j, 2 hh + e) is key g + 8 hh,
  // query column j * 8 + 2 cq + e
  auto phase_a = [&](int i, int q0, float al2) {
    const int st = i % ST;
    const int* m = meta_of(i);
    const int info = tinfo[i % MS];
    const bf16* qp = splane(st, PQ);
    const bf16* dop = splane(st, PDO);
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    if (NOPE && (info & 2)) {
      // the B fragments' column (n-tile j, column j * 8 + g): [SUM] or not
      int bsum = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) bsum |= (m[BQ + j * 8 + g] != 0) << j;
      for (int kd = 0; kd < DP / 16; ++kd) {
        uint32_t fk[NT][4], fn[NT][4];
        ldsm_terms<NT>(fk, kplane(PK) + arowq + kd * 16, BKV * LDQ);
        ldsm_terms<NT>(fn, kplane(PKN) + arowq + kd * 16, BKV * LDQ);
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t fq[NT][4], bo[NT][4], bs[NT][4];
          ldsm_terms<NT>(fq, qp + jp * 16 * LDQ + koffq + kd * 16, BQ * LDQ);
#pragma unroll
          for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const bool s = (bsum >> (2 * jp + (r >> 1))) & 1;
              bo[t][r] = s ? 0u : fq[t][r];
              bs[t][r] = s ? fq[t][r] : 0u;
            }
          mma2<NT, NT>(sc[2 * jp], sc[2 * jp + 1], fk, bo);
          mma2<NT, NT>(sc[2 * jp], sc[2 * jp + 1], fn, bs);
        }
      }
    } else {
      for (int kd = 0; kd < DP / 16; ++kd) {
        uint32_t fk[NT][4];
        ldsm_terms<NT>(fk, kplane(PK) + arowq + kd * 16, BKV * LDQ);
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t fq[NT][4];
          ldsm_terms<NT>(fq, qp + jp * 16 * LDQ + koffq + kd * 16, BQ * LDQ);
          mma2<NT, NT>(sc[2 * jp], sc[2 * jp + 1], fk, fq);
        }
      }
    }
    for (int kd = 0; kd < DVP / 16; ++kd) {
      uint32_t fv[NT][4];
      ldsm_terms<NT>(fv, kplane(PV) + arowv + kd * 16, BKV * LDV);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t fo[NT][4];
        ldsm_terms<NT>(fo, dop + jp * 16 * LDV + koffv + kd * 16, BQ * LDV);
        mma2<NT, NT>(dp[2 * jp], dp[2 * jp + 1], fv, fo);
      }
    }
    // P^T (1 - a sigma) in place of the scores, scale dS^T in place of dP^T
    // (0 on [SUM] columns, phase B's)
    auto pds = [&](auto all) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = j * 8 + 2 * cq;
        const int2 p2 = *reinterpret_cast<const int2*>(m + c);
        const int2 s2 = SUMC ? *reinterpret_cast<const int2*>(m + BQ + c) : make_int2(0, 0);
        const int2 g2 = a.use_seg ? *reinterpret_cast<const int2*>(m + 2 * BQ + c)
                                  : make_int2(0, 0);
        const float2 l2 = *reinterpret_cast<const float2*>(m + 3 * BQ + c);
        const float2 d2 = *reinterpret_cast<const float2*>(m + 4 * BQ + c);
        const int cp_[2] = {p2.x, p2.y}, cs_[2] = {s2.x, s2.y}, cg_[2] = {g2.x, g2.y};
        const float cl_[2] = {l2.x * LOG2E, l2.y * LOG2E}, cd_[2] = {d2.x, d2.y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool cin = q0 + c + e < S;
          const bool qs = SUMC && cs_[e] != 0;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int f = kfl[hh], dd = cp_[e] - kpos[hh];
            const bool ok = decltype(all)::value ||
                            (cin && (f & 1) && (unsigned)dd <= wlim &&
                             (!(f & 2) || dd == 0) && cg_[e] == ksg[hh]);
            float x = sc[j][2 * hh + e] * sl2;
            if (NOPE && qs) x -= al2 * (float)dd;
            const float p = ok ? ex2(x - cl_[e]) : 0.f;
            const float as = (RESET && qs) ? reset_w(a, dd) : 0.f;
            sc[j][2 * hh + e] = p - p * as;
            dp[j][2 * hh + e] = qs ? 0.f : a.scale * p * (dp[j][2 * hh + e] - cd_[e]);
          }
        }
      }
    };
    if (info & 1) pds(std::true_type());
    else pds(std::false_type());
    // dV += (P (1 - a sigma))^T.dO, dK += dS^T.Q: 16 output columns at a
    // time, both products and both k-steps of 16 queries each, so that
    // every fragment load feeds independent mma chains
    uint32_t pa[BQ / 16][NP][4], da[BQ / 16][NP][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      a_frags<NP>(sc, kk, pa[kk]);
      a_frags<NP>(dp, kk, da[kk]);
    }
#pragma unroll
    for (int c16 = 0; c16 < NT_V / 2; ++c16) {
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        if (c16 * 16 < DVP) {
          uint32_t bo[NT][4];
          ldsm_terms_t<NT>(bo, dop + kk * 16 * LDV + voffv + c16 * 16, BQ * LDV);
          mma2_acc<C::F32, NP, NT>(Y[2 * c16], Y[2 * c16 + 1], pa[kk], bo);
        }
        if (c16 * 16 < DP) {
          uint32_t bq[NT][4];
          ldsm_terms_t<NT>(bq, qp + kk * 16 * LDQ + voffq + c16 * 16, BQ * LDQ);
          mma2_acc<C::F32, NP, NT>(X[2 * c16], X[2 * c16 + 1], da[kk], bq);
        }
      }
    }
    // the wide class's dK columns past DMAX: each k-step into fresh
    // registers, added to xs
#pragma unroll
    for (int c16 = NT_V / 2; c16 < DQ / 16; ++c16) {
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        if (c16 * 16 < DP) {
          float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
          uint32_t bq[NT][4];
          ldsm_terms_t<NT>(bq, qp + kk * 16 * LDQ + voffq + c16 * 16, BQ * LDQ);
          mma2<NP, NT>(t0, t1, da[kk], bq);
          xs.add(2 * c16 - NT_V, t0);
          xs.add(2 * c16 + 1 - NT_V, t1);
        }
      }
    }
  };

  // Phase B, item i: the [SUM] columns of each 16-row half that holds one;
  // S^T = Kn.Qn^T - ALiBi d (K.Q^T without NoPE), dP^T = V.dO^T (+ a sigma
  // (V0 - V).dO^T); X += scale dS^T.Q, Y += (P a sigma)^T.dO
  auto phase_b = [&](int i, int q0, float al2) {
    const int st = i % ST;
    const int* m = meta_of(i);
    const int info = tinfo[i % MS];
    const bf16* qp = splane(st, PQ);
    const bf16* dop = splane(st, PDO);
    constexpr int PS = NOPE ? PKN : PK;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (!(info & (4 << half))) continue;
      float sc[2][4], dp[2][4], d0[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = d0[j][e] = 0.f;
      for (int kd = 0; kd < DP / 16; ++kd) {
        uint32_t fk[NT][4], fq[NT][4];
        ldsm_terms<NT>(fk, kplane(PS) + arowq + kd * 16, BKV * LDQ);
        ldsm_terms<NT>(fq, qp + half * 16 * LDQ + koffq + kd * 16, BQ * LDQ);
        mma2<NT, NT>(sc[0], sc[1], fk, fq);
      }
      for (int kd = 0; kd < DVP / 16; ++kd) {
        uint32_t fv[NT][4], fo[NT][4];
        ldsm_terms<NT>(fv, kplane(PV) + arowv + kd * 16, BKV * LDV);
        ldsm_terms<NT>(fo, dop + half * 16 * LDV + koffv + kd * 16, BQ * LDV);
        mma2<NT, NT>(dp[0], dp[1], fv, fo);
        if (RESET) {
          ldsm_terms<NT>(fv, kplane(PV0) + arowv + kd * 16, BKV * LDV);
          mma2<NT, NT>(d0[0], d0[1], fv, fo);
        }
      }
      auto pds = [&](auto all) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = half * 16 + j * 8 + 2 * cq;
          const int2 p2 = *reinterpret_cast<const int2*>(m + c);
          const int2 s2 = *reinterpret_cast<const int2*>(m + BQ + c);
          const int2 g2 = a.use_seg ? *reinterpret_cast<const int2*>(m + 2 * BQ + c)
                                    : make_int2(0, 0);
          const float2 l2 = *reinterpret_cast<const float2*>(m + 3 * BQ + c);
          const float2 d2 = *reinterpret_cast<const float2*>(m + 4 * BQ + c);
          const int cp_[2] = {p2.x, p2.y}, cs_[2] = {s2.x, s2.y}, cg_[2] = {g2.x, g2.y};
          const float cl_[2] = {l2.x * LOG2E, l2.y * LOG2E}, cd_[2] = {d2.x, d2.y};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool cin = q0 + c + e < S;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int f = kfl[hh], dd = cp_[e] - kpos[hh];
              const bool ok = cs_[e] != 0 &&
                              (decltype(all)::value ||
                               (cin && (f & 1) && (unsigned)dd <= wlim &&
                                (!(f & 2) || dd == 0) && cg_[e] == ksg[hh]));
              float x = sc[j][2 * hh + e] * sl2;
              if (NOPE) x -= al2 * (float)dd;
              const float p = ok ? ex2(x - cl_[e]) : 0.f;
              const float as = RESET ? reset_w(a, dd) : 0.f;
              float dpx = dp[j][2 * hh + e];
              if (RESET) dpx += as * (d0[j][2 * hh + e] - dpx);
              dp[j][2 * hh + e] = a.scale * p * (dpx - cd_[e]);
              sc[j][2 * hh + e] = p * as;
            }
          }
        }
      };
      if (info & 1) pds(std::true_type());
      else pds(std::false_type());
      uint32_t da[NP][4], pa[NP][4];
      a_frags<NP>(dp, 0, da);
      if (RESET) a_frags<NP>(sc, 0, pa);
#pragma unroll
      for (int c16 = 0; c16 < NT_V / 2; ++c16) {
        if (c16 * 16 < DP) {
          uint32_t bq[NT][4];
          ldsm_terms_t<NT>(bq, qp + half * 16 * LDQ + voffq + c16 * 16, BQ * LDQ);
          mma2_acc<C::F32, NP, NT>(X[2 * c16], X[2 * c16 + 1], da, bq);
        }
        if (RESET && c16 * 16 < DVP) {
          uint32_t bo[NT][4];
          ldsm_terms_t<NT>(bo, dop + half * 16 * LDV + voffv + c16 * 16, BQ * LDV);
          mma2_acc<C::F32, NP, NT>(Y[2 * c16], Y[2 * c16 + 1], pa, bo);
        }
      }
#pragma unroll
      for (int c16 = NT_V / 2; c16 < DQ / 16; ++c16) {   // X past DMAX, in xs
        if (c16 * 16 < DP) {
          float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
          uint32_t bq[NT][4];
          ldsm_terms_t<NT>(bq, qp + half * 16 * LDQ + voffq + c16 * 16, BQ * LDQ);
          mma2<NP, NT>(t0, t1, da, bq);
          xs.add(2 * c16 - NT_V, t0);
          xs.add(2 * c16 + 1 - NT_V, t1);
        }
      }
    }
  };

  // The pipeline (cp.async groups, one per item, the keys in the first):
  // item i + ST - 1's copies are in flight while item i is computed. Each
  // item has one barrier, which also tells every thread whether the tile
  // holds a row some key may be attended by.
  int fl[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) fl[j] = 0;
  if (direct) {
#pragma unroll
    for (int i = 0; i < ST - 1; ++i) {
      if (i < n_items) {
        row_flags(i, fl);
        issue(i, fl);
      }
      cp_commit();
    }
    if (ST - 1 < n_items) row_flags(ST - 1, fl);
  }
  for (int i = 0; i < n_items; ++i) {
    if (direct)
      cp_wait<(ST > 1 ? ST - 2 : 0)>();   // item i's group
    else
      meta_sync(i);
    const bool mine = tile_live(i);
    const int live = __syncthreads_or(mine);
    if (direct) {
      if (i + ST - 1 < n_items) issue(i + ST - 1, fl);
      cp_commit();
      if (i + ST < n_items) row_flags(i + ST, fl);
    }
    if (i == nA) flush_a();
    if (!live) continue;
    if (!direct) {
      convert(i);
      __syncthreads();
    }
    if (!w_live) continue;
    int rep, qt;
    item(i, rep, qt);
    const float al2 = NOPE ? a.alibi[hk * n_rep + rep] * LOG2E : 0.f;
    if (i < nA) phase_a(i, qt * BQ, al2);
    else phase_b(i, qt * BQ, al2);
  }
  if (direct) cp_wait<0>();
  if (n_items == nA) flush_a();
  write(X, NOPE ? a.g2 : a.g0, D);
  if (RESET) write(Y, a.g3, Dv);
}

// ---------------------------------------------------------------------------
// the bf16 wide class on wgmma
// ---------------------------------------------------------------------------

// Three warpgroups a CTA: two consumers of 64 rows each (wgmma's M: keys
// in the dk/dv pass, query rows in the dq pass) and one producer, which
// copies each tile's rows and metadata into a ring of stages; full and
// empty mbarriers per stage order the two sides, so that the consumers
// never wait at a CTA-wide barrier and drift apart. setmaxnreg moves the
// producer's registers to the consumers (40 and 232 a thread); a consumer
// reads its rows' (keys') metadata from shared memory rather than hold
// it. Planes hold 8 x 8 core matrices (8 rows of 16 bytes, 128 contiguous
// bytes: what wgmma reads without a swizzle), LQ of them along a row group of a q/k plane (q, K, q_nope,
// K_nope), LV along one of a value plane (V, V0, dO); wgmma reads a plane
// K-major (the products' K its columns) or MN-major (its rows) from the
// same core matrices.
constexpr int WG_CONSUMERS = 256, WG_PRODUCERS = 128;
constexpr int WG_THREADS = WG_CONSUMERS + WG_PRODUCERS;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int LQ = DWIDE / 8, LV = DMAX / 8;

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// wgmma's shared-memory matrix descriptor, no swizzle, of the operand at
// shared address a: `lbo` the bytes between core matrices along K, `sbo`
// along M/N (for a K-major operand; an MN-major one, read transposed,
// takes the same two strides). Shared addresses stay below 2^18, so a
// k-step moves the descriptor by its byte offset / 16.
__device__ __forceinline__ uint64_t sdesc(uint32_t a, int lbo, int sbo) {
  return (uint64_t)(a >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}
// a K-major operand whose rows start at a (a k-step of 16 columns: two
// core matrices, 256 bytes further), and an MN-major one (a k-step of 16
// rows: + MN_Q or MN_V, two row groups further)
__device__ __forceinline__ uint64_t desc_k(uint32_t a, int ldc) { return sdesc(a, 128, ldc * 128); }
__device__ __forceinline__ uint64_t desc_mn(uint32_t a, int ldc) { return sdesc(a, ldc * 128, 128); }
constexpr uint64_t MN_Q = (2 * LQ * 128) >> 4, MN_V = (2 * LV * 128) >> 4;

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

// mbarriers: `count` arrivals complete a phase; a waiter names the phase's
// parity (phases alternate 0, 1, 0, ...)
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(saddr(b)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(saddr(b)) : "memory");
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

// d += A.B for m64n32k16 over 12 k-steps: A (64 x 192) and B
// (32 x 192), both K-major from shared memory, their descriptors
// advanced 256 bytes a k-step inside one asm block (so that the compiler
// holds two descriptors, not 24)
__device__ __forceinline__ void wg_ss32x12(float (&d)[4][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 a, b;\nsetp.ne.b32 p, %18, 0;\nmov.b64 a, %16;\nmov.b64 b, %17;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, a, b, p, 1, 1, 0, 0;\n"
      "add.s64 a, a, 16;\nadd.s64 b, b, 16;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, a, b, p, 1, 1, 0, 0;\n"
      "add.s64 a, a, 16;\nadd.s64 b, b, 16;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, a, b, p, 1, 1, 0, 0;\n"
      "add.s64 a, a, 16;\nadd.s64 b, b, 16;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, a, b, p, 1, 1, 0, 0;\n"
      "add.s64 a, a, 16;\nadd.s64 b, b, 16;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, a, b, p, 1, 1, 0, 0;\n"
      "add.s64 a, a, 16;\nadd.s64 b, b, 16;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, a, b, p, 1, 1, 0, 0;\n"
      "add.s64 a, a, 16;\nadd.s64 b, b, 16;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, a, b, p, 1, 1, 0, 0;\n"
      "add.s64 a, a, 16;\nadd.s64 b, b, 16;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, a, b, p, 1, 1, 0, 0;\n"
      "add.s64 a, a, 16;\nadd.s64 b, b, 16;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, a, b, p, 1, 1, 0, 0;\n"
      "add.s64 a, a, 16;\nadd.s64 b, b, 16;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, a, b, p, 1, 1, 0, 0;\n"
      "add.s64 a, a, 16;\nadd.s64 b, b, 16;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, a, b, p, 1, 1, 0, 0;\n"
      "add.s64 a, a, 16;\nadd.s64 b, b, 16;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, a, b, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(1));
}

// d += A.B for m64n32k16 over 8 k-steps: A (64 x 128) and B
// (32 x 128), both K-major from shared memory, their descriptors
// advanced 256 bytes a k-step inside one asm block (so that the compiler
// holds two descriptors, not 16)
__device__ __forceinline__ void wg_ss32x8(float (&d)[4][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 a, b;\nsetp.ne.b32 p, %18, 0;\nmov.b64 a, %16;\nmov.b64 b, %17;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, a, b, p, 1, 1, 0, 0;\n"
      "add.s64 a, a, 16;\nadd.s64 b, b, 16;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, a, b, p, 1, 1, 0, 0;\n"
      "add.s64 a, a, 16;\nadd.s64 b, b, 16;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, a, b, p, 1, 1, 0, 0;\n"
      "add.s64 a, a, 16;\nadd.s64 b, b, 16;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, a, b, p, 1, 1, 0, 0;\n"
      "add.s64 a, a, 16;\nadd.s64 b, b, 16;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, a, b, p, 1, 1, 0, 0;\n"
      "add.s64 a, a, 16;\nadd.s64 b, b, 16;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, a, b, p, 1, 1, 0, 0;\n"
      "add.s64 a, a, 16;\nadd.s64 b, b, 16;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, a, b, p, 1, 1, 0, 0;\n"
      "add.s64 a, a, 16;\nadd.s64 b, b, 16;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, a, b, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(1));
}


// d += A.B for m64n128k16: A (64 x 16 bf16) from registers in the
// accumulator-derived fragment layout, B (16 x 128) MN-major from shared memory
__device__ __forceinline__ void wg_rs128(float (&d)[16][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A.B for m64n192k16: A (64 x 16 bf16) from registers in the
// accumulator-derived fragment layout, B (16 x 192) MN-major from shared memory
__device__ __forceinline__ void wg_rs192(float (&d)[24][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Rows [0, R) of a plane, `len` values each (zero past them, and rows for
// which src(r, ptr, ok) clears ok), by threads t of NT: eight threads a
// core matrix (conflict-free stores), so eight rows of one 16-byte column
// chunk each; by cp.async (direct: len a multiple of 8, rows 16-byte
// aligned) or by loads of the raw bits (the same values)
template <int R, int LDC, int NT, typename Src>
__device__ __forceinline__ void stage_plane(bf16* pl, int t, int len, bool direct, Src&& src) {
  if (direct) {
#pragma unroll 1
    for (int i = t; i < R * LDC; i += NT) {
      const int rest = i >> 3, c = rest % LDC;
      const bf16* s;
      bool ok;
      src(rest / LDC * 8 + (i & 7), s, ok);
      cp16(pl + rest * 64 + (i & 7) * 8, s + c * 8, ok && c * 8 < len);
    }
    return;
  }
  for (int i = t; i < R * LDC; i += NT) {
    const int rest = i >> 3, c = rest % LDC;
    const bf16* s;
    bool ok;
    src(rest / LDC * 8 + (i & 7), s, ok);
    const unsigned short* u = reinterpret_cast<const unsigned short*>(s + c * 8);
    const int n = len - c * 8;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t lo = (ok && 2 * e < n) ? u[2 * e] : 0u;
      const uint32_t hi = (ok && 2 * e + 1 < n) ? u[2 * e + 1] : 0u;
      w[e] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(pl + rest * 64 + (i & 7) * 8) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// the reset weight a(d) sigma at distance dd with the fast exponential and
// division (~1e-7 relative: far below bf16's rounding)
__device__ __forceinline__ float reset_fast(const Args<bf16>& a, int dd) {
  return a.y_min + __fdividef(a.y_max - a.y_min, 1.f + ex2((a.midpoint - (float)dd) * LOG2E));
}

// Tiles, stages and shared memory of the bf16 wide class (see the header;
// `windowed_bwd_plan` mirrors both). dq: 128 query rows, their Q (q_nope
// on [SUM] rows) and dO planes staged once, kv tiles of BK keys (K, K_nope,
// V, V0) in three stages, each slot's four words (position, valid, [SUM],
// segment) a stage. dk/dv: 128 keys, their K, K_nope, V and V0 staged
// once, q tiles of BQT rows (Q, dO) in three stages, each row's five words
// a stage; three words a key. Both: a full and an empty mbarrier a
// stage.
template <bool NOPE, bool RESET>
struct WgDqCfg {
  static constexpr int BQ = 128;                        // query rows per CTA
  static constexpr int KPK = 1 + NOPE, KPL = 2 + NOPE + RESET;
  static constexpr int STAGES = 3;
  static constexpr size_t ROW_ELEMS = (size_t)BQ * (DWIDE + DMAX);   // Q, dO
  static constexpr size_t STAGE_ELEMS = (size_t)BK * (KPK * DWIDE + (KPL - KPK) * DMAX);
  static constexpr size_t BYTES = (ROW_ELEMS + STAGES * STAGE_ELEMS) * sizeof(bf16) +
                                  (size_t)(STAGES * (4 + META * BK) + 5 * BQ +
                                           5 * (BQ / 32) + 10) *
                                      sizeof(int);
};

template <bool NOPE, bool RESET>
struct WgDkvCfg {
  static constexpr int BKV = 128, BQ = BQT;             // keys per CTA, rows per q tile
  static constexpr int KPK = 1 + NOPE, KPL = 2 + NOPE + RESET;
  static constexpr int STAGES = 3;
  static constexpr size_t KEY_ELEMS = (size_t)BKV * (KPK * DWIDE + (KPL - KPK) * DMAX);
  static constexpr size_t STAGE_ELEMS = (size_t)BQ * (DWIDE + DMAX);   // Q, dO
  static constexpr size_t BYTES =
      (KEY_ELEMS + STAGES * STAGE_ELEMS) * sizeof(bf16) +
      (size_t)(STAGES * (4 + QMETA * BQ) + 8 * (WG_CONSUMERS / 32) + 10 + 3 * BKV +
               BAND_TABLE / 4 + BAND_TABLE / 2 + 2) *
          sizeof(int);
};

template <bool NOPE, bool RESET>
__global__ void __launch_bounds__(WG_THREADS, 1) dq_wg_kernel(const Args<bf16> a) {
  using C = WgDqCfg<NOPE, RESET>;
  constexpr int BQ = C::BQ, ST = C::STAGES;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_p = reinterpret_cast<bf16*>(smem_raw);   // q (q_nope on [SUM] rows)
  bf16* do_p = q_p + BQ * DWIDE;                    // dO
  bf16* st_p = q_p + C::ROW_ELEMS;
  uint64_t* full = reinterpret_cast<uint64_t*>(st_p + ST * C::STAGE_ELEMS);
  uint64_t* empty = full + ST;
  int* meta = reinterpret_cast<int*>(empty + ST);  // per stage: slots' position, valid, [SUM], segment
  int* pos_r = meta + ST * META * BK;
  int* sum_r = pos_r + BQ;
  int* seg_r = sum_r + BQ;
  float* lse_r = reinterpret_cast<float*>(seg_r + BQ);
  float* dl_r = lse_r + BQ;
  int* red = reinterpret_cast<int*>(dl_r + BQ);   // per warp of rows: least, greatest position and segment, any [SUM]
  int* agg = red + 5 * (BQ / 32);                 // the same per consumer warpgroup
  // a stage: K, K_nope (NoPE), V, V0 (reset) planes of BK keys
  auto k_st = [&](int st) { return st_p + st * C::STAGE_ELEMS; };
  auto v_st = [&](int st) { return k_st(st) + C::KPK * BK * DWIDE; };

  const int h = blockIdx.x, iq = a.n_blocks - 1 - (int)blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hk);
  const int S = a.S, D = a.D, Dv = a.Dv;
  const int q0 = iq * BQ, nr = min(BQ, S - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, cq = lane & 3;
  const bool direct = a.direct;

  // the q tile's rows (threads below BQ, a warp per 32): position, [SUM]
  // flag, segment, lse (times log2 e, +1e30 past S), delta
  if (tid < BQ) {
    const bool in = tid < nr;
    const size_t bs = (size_t)b * S + q0 + tid;
    const size_t hr = ((size_t)b * a.H + h) * S + q0 + tid;
    const int p = in ? a.pos_q[bs] : 0;
    const int sm = (in && a.sum_q != nullptr) ? (a.sum_q[bs] != 0) : 0;
    const int sg = (in && a.use_seg) ? a.seg_q[bs] : 0;
    pos_r[tid] = p;
    sum_r[tid] = sm;
    seg_r[tid] = sg;
    lse_r[tid] = (in ? a.lse[hr] : 1e30f) * LOG2E;
    dl_r[tid] = in ? a.delta[hr] : 0.f;
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
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], WG_PRODUCERS);
      mbar_init(&empty[s], WG_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Q (q_nope on [SUM] rows, NoPE) and dO, zero past D, Dv and S, by every
  // thread
  stage_plane<BQ, LQ, WG_THREADS>(q_p, tid, D, direct, [&](int r, const bf16*& s, bool& ok) {
    ok = r < nr;
    s = ((NOPE && ok && sum_r[r]) ? a.qn : a.q) + (((size_t)b * S + q0 + (ok ? r : 0)) * a.H + h) * D;
  });
  stage_plane<BQ, LV, WG_THREADS>(do_p, tid, Dv, direct, [&](int r, const bf16*& s, bool& ok) {
    ok = r < nr;
    s = a.dout + (((size_t)b * S + q0 + (ok ? r : 0)) * a.H + h) * Dv;
  });
  cp_commit();
  cp_wait<0>();
  fence_async_smem();
  __syncthreads();
  const bool any_sum = (agg[4] | agg[9]) != 0;
  // physical band: kv tiles holding rows [q0 - window, q0 + nr - 1]
  const int kb_lo = max(q0 - a.window, 0) / BK;
  const int n_t = (q0 + nr - 1) / BK - kb_lo + 1;
  // the warpgroup, warp-uniform to the compiler: wgmma on a path it must
  // take as divergent is serialized
  const int wg = __shfl_sync(FULL, warp >> 2, 0);

  if (wg == 2) {
    // The producer: for each tile, once its stage is free, the slots'
    // metadata and the K, K_nope, V, V0 rows by cp.async (4-byte copies of
    // the metadata); the stage is full once a tile's copies have landed,
    // one tile later. Slots past S are zero-filled without a read.
    regs_dec<PRODUCER_REGS>();
    const int pt = tid - WG_CONSUMERS;
    for (int i = 0; i < n_t; ++i) {
      const int s = i % ST;
      if (i >= ST) mbar_wait(&empty[s], (i / ST - 1) & 1);
      const int kt0 = (kb_lo + i) * BK;
      if (pt < 32) {
        const bool in = kt0 + lane < S;
        const size_t bs = (size_t)b * S + (in ? kt0 + lane : 0);
        int* m = meta + s * META * BK;
        cp4(m + lane, a.pos_k + bs, in);
        if (a.valid_k != nullptr) cp4(m + BK + lane, a.valid_k + bs, in);
        else m[BK + lane] = in;
        if (a.sum_isolated) cp4(m + 2 * BK + lane, a.sum_k + bs, in);
        if (a.use_seg) cp4(m + 3 * BK + lane, a.seg_k + bs, in);
      }
      auto row = [&](int r, bool& ok) {
        ok = kt0 + r < S;
        return ((size_t)b * S + (ok ? kt0 + r : 0)) * a.Hk + hk;
      };
      stage_plane<BK, LQ, WG_PRODUCERS>(k_st(s), pt, D, direct,
                                        [&](int r, const bf16*& p, bool& ok) { p = a.k + row(r, ok) * D; });
      if (NOPE && any_sum)
        stage_plane<BK, LQ, WG_PRODUCERS>(k_st(s) + BK * DWIDE, pt, D, direct,
                                          [&](int r, const bf16*& p, bool& ok) { p = a.kn + row(r, ok) * D; });
      stage_plane<BK, LV, WG_PRODUCERS>(v_st(s), pt, Dv, direct,
                                        [&](int r, const bf16*& p, bool& ok) { p = a.v + row(r, ok) * Dv; });
      if (RESET && any_sum)
        stage_plane<BK, LV, WG_PRODUCERS>(v_st(s) + BK * DMAX, pt, Dv, direct,
                                          [&](int r, const bf16*& p, bool& ok) { p = a.v0 + row(r, ok) * Dv; });
      cp_commit();
      if (i > 0) {
        cp_wait<1>();
        fence_async_smem();
        mbar_arrive(&full[(i - 1) % ST]);
      }
    }
    cp_wait<0>();
    fence_async_smem();
    mbar_arrive(&full[(n_t - 1) % ST]);
  } else {
    regs_inc<CONSUMER_REGS>();
    // this thread's rows: hh = 0, 1 is row g + 8 hh of the warp's 16; their
    // data is read from shared memory where needed, not held
    const int wr0 = warp * 16;
    const bool w_sum = __shfl_sync(FULL, agg[5 * wg + 4], 0) != 0;   // this warpgroup holds a [SUM] row
    const bool wg_live = 64 * wg < nr;
    const float sl2 = a.scale * LOG2E;
    const float al2 = NOPE ? a.alibi[h] * LOG2E : 0.f;
    const unsigned wlim = (unsigned)a.window;
    float acc[DWIDE / 8][4];    // dQ (dQ_nope on [SUM] rows)
    zero(acc);

    // Stage s's tile for this warpgroup: S = Q.K^T and dP = dO.V^T, with a
    // [SUM] row Sn = Q.Kn^T (its Q row holds q_nope; NoPE) and dP0 = dO.V0^T
    // (reset), every k-step from shared memory before one wait; P and dS in
    // registers; dQ += scale dS.K (dS.Kn on [SUM] rows: the A operand
    // masked by row), K read MN-major. WN and WR are the warpgroup's NoPE
    // and reset products.
    auto compute = [&](int s, int kt0, bool interior, auto wn, auto wr) {
      constexpr bool WN = decltype(wn)::value, WR = decltype(wr)::value;
      const int* mt_ = meta + s * META * BK;
      const uint32_t ks = saddr(k_st(s)), vs = saddr(v_st(s));
      const uint32_t kns = ks + BK * DWIDE * 2, v0s = vs + BK * DMAX * 2;
      const uint64_t dqa = desc_k(saddr(q_p) + wg * 64 * DWIDE * 2, LQ);
      const uint64_t doa = desc_k(saddr(do_p) + wg * 64 * DMAX * 2, LV);
      float sc[4][4], dp[4][4], d0[4][4];
      zero(sc);
      zero(dp);
      if constexpr (WR) zero(d0);
      wg_fence();
      wg_ss32x12(sc, dqa, desc_k(ks, LQ));
      if constexpr (WN) {
        // Sn = Q.Kn^T, taken for the [SUM] rows' scores before dP is
        // issued: no more than three score tiles live
        float sn[4][4];
        zero(sn);
        wg_ss32x12(sn, dqa, desc_k(kns, LQ));
        wg_commit();
        wg_wait0();
        hold(sc);
        hold(sn);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool sr = sum_r[wr0 + g + 8 * (e >> 1)] != 0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (sr) sc[j][e] = sn[j][e];
        }
        wg_fence();
      }
      wg_ss32x8(dp, doa, desc_k(vs, LV));
      if constexpr (WR) wg_ss32x8(d0, doa, desc_k(v0s, LV));
      wg_commit();
      wg_wait0();
      hold(sc);
      hold(dp);
      if constexpr (WR) hold(d0);

      // P and dS = scale P (dP - delta), in place of the scores; element
      // (j, 2 hh + e) is row g + 8 hh, key column j * 8 + 2 cq + e
      auto pds = [&](auto all) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = wr0 + g + 8 * hh;
          const int pq = pos_r[r], sg = seg_r[r];
          const bool rs = sum_r[r] != 0;
          const float l2 = lse_r[r], dl = dl_r[r];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = j * 8 + 2 * cq;
            const int2 p2 = *reinterpret_cast<const int2*>(mt_ + c);
            const int2 v2 = *reinterpret_cast<const int2*>(mt_ + BK + c);
            const int2 i2 = a.sum_isolated ? *reinterpret_cast<const int2*>(mt_ + 2 * BK + c)
                                           : make_int2(0, 0);
            const int2 s2 = a.use_seg ? *reinterpret_cast<const int2*>(mt_ + 3 * BK + c)
                                      : make_int2(0, 0);
            const int cpk[2] = {p2.x, p2.y}, csg[2] = {s2.x, s2.y};
            // bit 0 an attendable slot (< S, valid), bit 1 an isolated [SUM] key
            const int cfl[2] = {(kt0 + c < S && v2.x != 0) ? (1 | ((i2.x != 0) << 1)) : 0,
                                (kt0 + c + 1 < S && v2.y != 0) ? (1 | ((i2.y != 0) << 1)) : 0};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int f = cfl[e], dd = pq - cpk[e];
              // valid, causal and in the window (one unsigned compare),
              // isolated [SUM] keys only at distance 0, the same segment
              const bool ok = decltype(all)::value ||
                              ((f & 1) && (unsigned)dd <= wlim &&
                               (!(f & 2) || dd == 0) && csg[e] == sg);
              float x = sc[j][2 * hh + e] * sl2;
              if constexpr (WN) {
                if (rs) x -= al2 * (float)dd;
              }
              const float p = ok ? ex2(x - l2) : 0.f;
              float dpx = dp[j][2 * hh + e];
              if constexpr (WR) {
                if (rs) dpx += reset_fast(a, dd) * (d0[j][2 * hh + e] - dpx);
              }
              sc[j][2 * hh + e] = a.scale * p * (dpx - dl);
            }
          }
        }
      };
      if (interior) pds(std::true_type());
      else pds(std::false_type());

      // dS as hi + lo A fragments, two k-steps of 16 keys; with NoPE rows
      // masked into the ordinary rows' (x K) and the [SUM] rows' (x Kn)
      uint32_t pa[2][2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) a_frags<2>(sc, kk, pa[kk]);
      const uint64_t mk = desc_mn(ks, LQ), mkn = desc_mn(kns, LQ);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int t = 1; t >= 0; --t) {
          if constexpr (WN) {
            uint32_t po[4], ps[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const bool sr = sum_r[wr0 + g + 8 * (e & 1)] != 0;
              po[e] = sr ? 0u : pa[kk][t][e];
              ps[e] = sr ? pa[kk][t][e] : 0u;
            }
            wg_rs192(acc, po, mk + kk * MN_Q);
            wg_rs192(acc, ps, mkn + kk * MN_Q);
          } else {
            wg_rs192(acc, pa[kk][t], mk + kk * MN_Q);
          }
        }
      wg_commit();
      wg_wait0();
      hold(acc);
    };

    const int lo = agg[5 * wg], hi = agg[5 * wg + 1], slo = agg[5 * wg + 2], shi = agg[5 * wg + 3];
    for (int i = 0; i < n_t; ++i) {
      const int s = i % ST;
      mbar_wait(&full[s], (i / ST) & 1);
      // whether some row of this warpgroup may attend a slot of the tile,
      // and whether every row attends every slot (an interior tile, whose
      // scores need no mask): each warp, a lane per slot
      const int kt0 = (kb_lo + i) * BK;
      const int* m = meta + s * META * BK;
      const int pk = m[lane];
      const int sk = a.sum_isolated ? (m[2 * BK + lane] != 0) : 0;
      const int f = (kt0 + lane < S && m[BK + lane] != 0) ? (1 | (sk << 1)) : 0;
      const int sgk = a.use_seg ? m[3 * BK + lane] : 0;
      bool live = (f & 1) && pk <= hi && (long long)pk >= (long long)lo - a.window;
      if (f & 2) live = live && pk >= lo;
      bool all = f == 1 && pk <= lo && (long long)hi - pk <= a.window;
      if (a.use_seg) {
        live = live && sgk >= slo && sgk <= shi;
        all = all && sgk == slo && slo == shi;
      }
      if (wg_live && __any_sync(FULL, live)) {
        const bool interior = __all_sync(FULL, all);
        if (w_sum)
          compute(s, kt0, interior, std::integral_constant<bool, NOPE>(),
                  std::integral_constant<bool, RESET>());
        else
          compute(s, kt0, interior, std::false_type(), std::false_type());
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // a [SUM] row's gradient is dq_nope's, an ordinary row's dq's; the
    // other output's row is 0
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = wr0 + g + 8 * hh;
      if (r >= nr) continue;
      const size_t ob = (((size_t)b * S + q0 + r) * a.H + h) * D;
      const bool to_n = NOPE && sum_r[r] != 0;
#pragma unroll
      for (int j = 0; j < DWIDE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = j * 8 + 2 * cq + e;
          if (col < D) {
            const float x = acc[j][2 * hh + e];
            store(a.g0 + ob + col, to_n ? 0.f : x);
            if (NOPE) store(a.g1 + ob + col, to_n ? x : 0.f);
          }
        }
    }
  }
}

template <bool NOPE, bool RESET>
__global__ void __launch_bounds__(WG_THREADS, 1) dkv_wg_kernel(const Args<bf16> a) {
  using C = WgDkvCfg<NOPE, RESET>;
  constexpr int BKV = C::BKV, BQ = C::BQ, ST = C::STAGES;
  constexpr int CWARPS = WG_CONSUMERS / 32;
  constexpr bool SUMC = NOPE || RESET;    // [SUM] columns' dS goes to phase B
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* k_p = reinterpret_cast<bf16*>(smem_raw);   // K, K_nope (NoPE), V, V0 (reset)
  bf16* kn_p = k_p + BKV * DWIDE;
  bf16* v_p = kn_p + (NOPE ? BKV * DWIDE : 0);
  bf16* v0_p = v_p + BKV * DMAX;
  bf16* st_p = k_p + C::KEY_ELEMS;                 // stages: Q, dO
  uint64_t* full = reinterpret_cast<uint64_t*>(st_p + ST * C::STAGE_ELEMS);
  uint64_t* empty = full + ST;
  int* qmeta = reinterpret_cast<int*>(empty + ST);   // per stage: rows' position, [SUM], segment, lse, delta
  int* red = qmeta + ST * QMETA * BQ;     // per consumer warp: the keys' least, greatest position, segment; plain
  int* kagg = red + 8 * CWARPS;           // the same per consumer warpgroup
  int* kmeta = kagg + 10;                 // per key: position, flags, segment
  unsigned char* bflag = reinterpret_cast<unsigned char*>(kmeta + 3 * BKV);
  short* btile = reinterpret_cast<short*>(bflag + BAND_TABLE);
  int* nbv = reinterpret_cast<int*>(btile + BAND_TABLE);   // phase B's tiles; then the band's
  int* nband_s = nbv + 1;
  auto q_st = [&](int st) { return st_p + st * C::STAGE_ELEMS; };
  auto do_st = [&](int st) { return st_p + st * C::STAGE_ELEMS + BQ * DWIDE; };

  const int ik = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_rep = a.H / a.Hk;
  const int S = a.S, D = a.D, Dv = a.Dv;
  const int k0 = ik * BKV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, cq = lane & 3;
  const bool direct = a.direct;

  // a consumer thread's keys: hh = 0, 1 is key g + 8 hh of the warp's 16;
  // flag bit 0 an attendable key, bit 1 an isolated [SUM] key
  const int wk0 = warp * 16;
  int kpos[2], kfl[2], ksg[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kj = k0 + wk0 + g + 8 * hh;
    const bool in = warp < CWARPS && kj < S;
    const size_t bs = (size_t)b * S + (in ? kj : 0);
    kpos[hh] = in ? a.pos_k[bs] : 0;
    const bool ok = in && (a.valid_k == nullptr || a.valid_k[bs] != 0);
    const int sk = (in && a.sum_isolated) ? (a.sum_k[bs] != 0) : 0;
    kfl[hh] = ok ? (1 | (sk << 1)) : 0;
    ksg[hh] = (in && a.use_seg) ? a.seg_k[bs] : 0;
    if (warp < CWARPS) {
      const int k = wk0 + g + 8 * hh;
      kmeta[k] = kpos[hh];
      kmeta[BKV + k] = kfl[hh];
      kmeta[2 * BKV + k] = ksg[hh];
    }
  }
  // each consumer warp's attendable keys: least and greatest position and
  // segment, and whether every key is plain (< S, valid, not an isolated
  // [SUM] key)
  if (warp < CWARPS) {
    int lo = INT_MAX, hi = INT_MIN, slo = INT_MAX, shi = INT_MIN;
    bool plain = true;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (kfl[hh] & 1) {
        lo = min(lo, kpos[hh]);
        hi = max(hi, kpos[hh]);
        slo = min(slo, ksg[hh]);
        shi = max(shi, ksg[hh]);
      }
      plain = plain && kfl[hh] == 1;
    }
    lo = __reduce_min_sync(FULL, lo);
    hi = __reduce_max_sync(FULL, hi);
    slo = __reduce_min_sync(FULL, slo);
    shi = __reduce_max_sync(FULL, shi);
    plain = __all_sync(FULL, plain);
    if (lane == 0) {
      red[8 * warp] = lo;
      red[8 * warp + 1] = hi;
      red[8 * warp + 2] = slo;
      red[8 * warp + 3] = shi;
      red[8 * warp + 4] = plain;
    }
  }

  // the transposed band: q tiles holding rows [k0, k0 + BKV - 1 + window]
  const int qb_lo = k0 / BQ;
  const int qb_hi = (int)(min((long long)k0 + BKV - 1 + a.window, (long long)S - 1) / BQ);
  const int n_band = qb_hi - qb_lo + 1;
  const bool table = n_band <= BAND_TABLE;
  if (tid == 0) *nband_s = n_band;
  // which of them hold a [SUM] row (a warp per tile, a lane per row);
  // whether any does (K_nope and V0 are read)
  bool any_sum = false;
  if (SUMC && table) {
    for (int t = warp; t < n_band; t += WG_THREADS / 32) {
      const int row = (qb_lo + t) * BQ + lane;
      const bool f = row < S && a.sum_q[(size_t)b * S + row] != 0;
      const bool any = __any_sync(FULL, f);
      any_sum = any_sum || any;
      if (lane == 0) bflag[t] = any;
    }
  }
  const int any_band = __syncthreads_or(any_sum);
  const bool kx = SUMC && (!table || any_band);
  if (tid < 2) {   // consumer warpgroup tid: warps 4 tid .. 4 tid + 3
    int lo = INT_MAX, hi = INT_MIN, slo = INT_MAX, shi = INT_MIN, plain = 1;
    for (int w = 4 * tid; w < 4 * tid + 4; ++w) {
      lo = min(lo, red[8 * w]);
      hi = max(hi, red[8 * w + 1]);
      slo = min(slo, red[8 * w + 2]);
      shi = max(shi, red[8 * w + 3]);
      plain = plain && red[8 * w + 4] != 0;
    }
    kagg[5 * tid] = lo;
    kagg[5 * tid + 1] = hi;
    kagg[5 * tid + 2] = slo;
    kagg[5 * tid + 3] = shi;
    kagg[5 * tid + 4] = plain;
  }
  if (tid == 64) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], WG_PRODUCERS);
      mbar_init(&empty[s], CWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // phase B's table: the band's q tiles that hold a [SUM] row, in order
  if (SUMC && table && warp == 1) {
    int base = 0;
    for (int c = 0; c < n_band; c += 32) {
      const bool f = c + lane < n_band && bflag[c + lane];
      const unsigned m = __ballot_sync(FULL, f);
      if (f) btile[base + __popc(m & ((1u << lane) - 1u))] = (short)(c + lane);
      base += __popc(m);
    }
    if (lane == 0) *nbv = base;
  }
  // the CTA's keys, once, by every thread (zero past D, Dv and S)
  {
    auto row = [&](int r, bool& ok) {
      const int kj = k0 + r;
      ok = kj < S;
      return ((size_t)b * S + (ok ? kj : 0)) * a.Hk + hk;
    };
    stage_plane<BKV, LQ, WG_THREADS>(k_p, tid, D, direct, [&](int r, const bf16*& s, bool& ok) {
      s = a.k + row(r, ok) * D;
    });
    if (NOPE && kx)
      stage_plane<BKV, LQ, WG_THREADS>(kn_p, tid, D, direct,
                                       [&](int r, const bf16*& s, bool& ok) { s = a.kn + row(r, ok) * D; });
    stage_plane<BKV, LV, WG_THREADS>(v_p, tid, Dv, direct, [&](int r, const bf16*& s, bool& ok) {
      s = a.v + row(r, ok) * Dv;
    });
    if (RESET && kx)
      stage_plane<BKV, LV, WG_THREADS>(v0_p, tid, Dv, direct,
                                       [&](int r, const bf16*& s, bool& ok) { s = a.v0 + row(r, ok) * Dv; });
  }
  cp_commit();
  cp_wait<0>();
  fence_async_smem();
  __syncthreads();
  // items: phases V and K, every (query head, q tile) of the band each;
  // phase B1 and, with reset, B2, every (query head, q tile with a [SUM]
  // row); a band longer than the table revisits every tile in phase B.
  // Each role reads the counts from shared memory (values held across the
  // role split would be spilled there).
  struct Items {
    int n_band, nB, nA, nB1, n_items;
    bool table;
  };
  auto items = [&]() {
    Items it;
    it.n_band = __shfl_sync(FULL, *reinterpret_cast<volatile int*>(nband_s), 0);
    it.table = it.n_band <= BAND_TABLE;
    it.nB = !SUMC ? 0
                  : (it.table ? __shfl_sync(FULL, *reinterpret_cast<volatile int*>(nbv), 0)
                              : it.n_band);
    it.nA = n_rep * it.n_band;
    it.nB1 = n_rep * it.nB;
    it.n_items = 2 * it.nA + (RESET ? 2 : 1) * it.nB1;
    return it;
  };
  auto item = [&](const Items& it, int i, int& rep, int& qt) {
    const int qb0 = (int)blockIdx.x * BKV / BQ;
    if constexpr (SUMC) {
      if (i >= 2 * it.nA) {
        const int k = i - 2 * it.nA < it.nB1 ? i - 2 * it.nA : i - 2 * it.nA - it.nB1;
        rep = k / it.nB;
        const int t = k - rep * it.nB;
        qt = qb0 + (it.table ? (int)btile[t] : t);
        return;
      }
    }
    const int k = i < it.nA ? i : i - it.nA;
    rep = k / it.n_band;
    qt = qb0 + (k - rep * it.n_band);
  };
  // the warpgroup, warp-uniform to the compiler: wgmma on a path it must
  // take as divergent is serialized
  const int wg = __shfl_sync(FULL, warp >> 2, 0);

  if (wg == 2) {
    // The producer: for each item, once its stage is free, the rows' five
    // words (4-byte copies) and the Q (q_nope on [SUM] rows, NoPE) and dO
    // rows by cp.async; the stage is full once an item's copies have
    // landed, one item later. Rows past S are zero-filled without a read.
    regs_dec<PRODUCER_REGS>();
    const int pt = tid - WG_CONSUMERS;
    const Items it = items();
    const int n_items = it.n_items;
    for (int i = 0; i < n_items; ++i) {
      const int s = i % ST;
      if (i >= ST) mbar_wait(&empty[s], (i / ST - 1) & 1);
      int rep, qt;
      item(it, i, rep, qt);
      const int h = hk * n_rep + rep, q0 = qt * BQ, row = q0 + lane;
      const bool in = row < S;
      const size_t bs = (size_t)b * S + (in ? row : 0);
      // row lane's [SUM] flag (each producer warp: the rows it copies take
      // q or q_nope by it)
      const int sm = (NOPE && in) ? (a.sum_q[bs] != 0) : 0;
      if (pt < 32) {
        const size_t hr = ((size_t)b * a.H + h) * S + (in ? row : 0);
        int* m = qmeta + s * QMETA * BQ;
        cp4(m + lane, a.pos_q + bs, in);
        if (SUMC) cp4(m + BQ + lane, a.sum_q + bs, in);
        if (a.use_seg) cp4(m + 2 * BQ + lane, a.seg_q + bs, in);
        cp4(m + 3 * BQ + lane, a.lse + hr, in);
        cp4(m + 4 * BQ + lane, a.delta + hr, in);
      }
      auto qrow = [&](int r, bool& ok) {
        ok = q0 + r < S;
        return ((size_t)b * S + (ok ? q0 + r : 0)) * a.H + h;
      };
      stage_plane<BQ, LQ, WG_PRODUCERS>(q_st(s), pt, D, direct, [&](int r, const bf16*& p, bool& ok) {
        const int fr = __shfl_sync(FULL, sm, r);   // row r's [SUM] flag
        p = ((NOPE && fr) ? a.qn : a.q) + qrow(r, ok) * D;
      });
      stage_plane<BQ, LV, WG_PRODUCERS>(do_st(s), pt, Dv, direct, [&](int r, const bf16*& p, bool& ok) {
        p = a.dout + qrow(r, ok) * Dv;
      });
      cp_commit();
      if (i > 0) {
        cp_wait<1>();
        fence_async_smem();
        mbar_arrive(&full[(i - 1) % ST]);
      }
    }
    cp_wait<0>();
    fence_async_smem();
    mbar_arrive(&full[(n_items - 1) % ST]);
  } else {
    regs_inc<CONSUMER_REGS>();
    const float sl2 = a.scale * LOG2E;
    const unsigned wlim = (unsigned)a.window;
    // this warpgroup's 64 keys (8 row groups) of each key plane (shared
    // addresses, recomputed where used)
    auto kw_ = [&]() { return saddr(k_p) + wg * 64 * DWIDE * 2; };
    auto knw = [&]() { return saddr(kn_p) + wg * 64 * DWIDE * 2; };
    auto vw = [&]() { return saddr(v_p) + wg * 64 * DMAX * 2; };
    auto v0w = [&]() { return saddr(v0_p) + wg * 64 * DMAX * 2; };

    // this thread's keys' rows of acc (its first `dim` columns) into out
    auto write = [&](const auto& acc, bf16* out, int dim) {
      constexpr int NJ = std::extent<std::remove_reference_t<decltype(acc)>>::value;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int kj = k0 + wk0 + g + 8 * hh;
        if (kj >= S) continue;
        const size_t ob = (((size_t)b * S + kj) * a.Hk + hk) * dim;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = j * 8 + 2 * cq + e;
            if (col < dim) store(out + ob + col, acc[j][2 * hh + e]);
          }
      }
    };
    // Per element of a tile's 64 x 32 scores: key g + 8 hh of the warp's
    // 16, query column j * 8 + 2 cq + e; a column's row data from stage s
    struct Col {
      int pos[2], sum[2], seg[2];
      float l2[2], dl[2];
    };
    auto col = [&](const int* m, int j) {
      const int c = j * 8 + 2 * cq;
      const int2 p2 = *reinterpret_cast<const int2*>(m + c);
      const int2 s2 = SUMC ? *reinterpret_cast<const int2*>(m + BQ + c) : make_int2(0, 0);
      const int2 g2 = a.use_seg ? *reinterpret_cast<const int2*>(m + 2 * BQ + c)
                                : make_int2(0, 0);
      const float2 l2 = *reinterpret_cast<const float2*>(m + 3 * BQ + c);
      const float2 d2 = *reinterpret_cast<const float2*>(m + 4 * BQ + c);
      return Col{{p2.x, p2.y}, {s2.x, s2.y}, {g2.x, g2.y}, {l2.x * LOG2E, l2.y * LOG2E},
                 {d2.x, d2.y}};
    };
    // this thread's key hh (g + 8 hh of the warp's 16), from shared
    // memory; whether it and column e may attend
    struct Key {
      int pos, fl, seg;
    };
    auto key = [&](int hh) {
      const int k = wk0 + g + 8 * hh;
      return Key{kmeta[k], kmeta[BKV + k], kmeta[2 * BKV + k]};
    };
    auto attends = [&](const Col& cc, int e, const Key& ky, bool cin) {
      const int dd = cc.pos[e] - ky.pos;
      return cin && (ky.fl & 1) && (unsigned)dd <= wlim && (!(ky.fl & 2) || dd == 0) &&
             cc.seg[e] == ky.seg;
    };

    // dV (phase V), dK (phase K), dK_nope (B1; dK continued without NoPE)
    // and dV0 (B2): an accumulator each, so that each has one life (one
    // reused across phases is read between wgmma and written again, and the
    // compiler then serializes the wgmma)
    float Y[DMAX / 8][4], X[DWIDE / 8][4], XB[DWIDE / 8][4], YB[DMAX / 8][4];

    // Phase V, stage s, for this warpgroup's 64 keys: S^T = K.Q^T over the
    // tile's 32 query columns (on a tile with a [SUM] column and NoPE,
    // Sn^T = Kn.Q^T too, the column's Q row holding q_nope, taken for its
    // scores), every k-step from shared memory before one wait; P^T
    // (1 - a sigma) in registers; dV += (P (1 - a sigma))^T.dO as hi + lo A
    // fragments, dO read MN-major. WS: the tile holds a [SUM] column.
    auto phase_v = [&](int s, int q0, float al2, int info, auto ws) {
      constexpr bool WS = decltype(ws)::value && SUMC, WN = WS && NOPE;
      const int* m = qmeta + s * QMETA * BQ;
      const uint32_t qs = saddr(q_st(s)), ds = saddr(do_st(s));
      float sc[4][4];
      zero(sc);
      wg_fence();
      wg_ss32x12(sc, desc_k(kw_(), LQ), desc_k(qs, LQ));
      if constexpr (WN) {
        float sn[4][4];
        zero(sn);
        wg_ss32x12(sn, desc_k(knw(), LQ), desc_k(qs, LQ));
        wg_commit();
        wg_wait0();
        hold(sc);
        hold(sn);
        // (bit selects: a branch here would be a divergent path to the
        // compiler, which then serializes the wgmma)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int2 s2 = *reinterpret_cast<const int2*>(m + BQ + j * 8 + 2 * cq);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int sel = -(int)((e & 1 ? s2.y : s2.x) != 0);
            sc[j][e] = __int_as_float((__float_as_int(sc[j][e]) & ~sel) |
                                      (__float_as_int(sn[j][e]) & sel));
          }
        }
      } else {
        wg_commit();
        wg_wait0();
        hold(sc);
      }
      auto pv = [&](auto all) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const Key ky = key(hh);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const Col cc = col(m, j);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool cin = q0 + j * 8 + 2 * cq + e < S;
              const bool qs_ = WS && cc.sum[e] != 0;
              const int dd = cc.pos[e] - ky.pos;
              const bool ok = decltype(all)::value || attends(cc, e, ky, cin);
              float x = sc[j][2 * hh + e] * sl2;
              if (WN && qs_) x -= al2 * (float)dd;
              const float p = ok ? ex2(x - cc.l2[e]) : 0.f;
              float w = p;
              if constexpr (WS && RESET) {
                if (qs_) w = p - p * reset_fast(a, dd);
              }
              sc[j][2 * hh + e] = w;
            }
          }
        }
      };
      if (info & 2) pv(std::true_type());
      else pv(std::false_type());
      uint32_t pa[2][2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) a_frags<2>(sc, kk, pa[kk]);
      const uint64_t md = desc_mn(ds, LV);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int t = 1; t >= 0; --t) wg_rs128(Y, pa[kk][t], md + kk * MN_V);
      wg_commit();
      wg_wait0();
      hold(Y);
    };

    // Phase K, stage s: S^T = K.Q^T and dP^T = V.dO^T, every k-step before
    // one wait; scale dS^T = scale P^T (dP^T - delta) on ordinary columns
    // (0 on [SUM] columns, phase B1's); dK += dS^T.Q, Q read MN-major.
    auto phase_k = [&](int s, int q0, int info) {
      const int* m = qmeta + s * QMETA * BQ;
      const uint32_t qs = saddr(q_st(s)), ds = saddr(do_st(s));
      float sc[4][4], dp[4][4];
      zero(sc);
      zero(dp);
      wg_fence();
      wg_ss32x12(sc, desc_k(kw_(), LQ), desc_k(qs, LQ));
      wg_ss32x8(dp, desc_k(vw(), LV), desc_k(ds, LV));
      wg_commit();
      wg_wait0();
      hold(sc);
      hold(dp);
      auto ds_ = [&](auto all) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const Key ky = key(hh);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const Col cc = col(m, j);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool cin = q0 + j * 8 + 2 * cq + e < S;
              const bool plain = !SUMC || cc.sum[e] == 0;
              const bool ok = plain && (decltype(all)::value || attends(cc, e, ky, cin));
              const float p = ok ? ex2(sc[j][2 * hh + e] * sl2 - cc.l2[e]) : 0.f;
              dp[j][2 * hh + e] = a.scale * p * (dp[j][2 * hh + e] - cc.dl[e]);
            }
          }
        }
      };
      if (info & 2) ds_(std::true_type());
      else ds_(std::false_type());
      uint32_t da[2][2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) a_frags<2>(dp, kk, da[kk]);
      const uint64_t mq = desc_mn(qs, LQ);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int t = 1; t >= 0; --t) wg_rs192(X, da[kk][t], mq + kk * MN_Q);
      wg_commit();
      wg_wait0();
      hold(X);
    };

    // Phase B, stage s: the [SUM] columns' S^T = Kn.Qn^T - ALiBi d (K.Q^T
    // without NoPE) and P. B1 (X): dP^T = V.dO^T (+ a sigma (V0 - V).dO^T),
    // X += scale dS^T.Q. B2 (Y, reset): Y += (P a sigma)^T.dO.
    auto phase_b = [&](int s, int q0, float al2, int info, auto b2) {
      constexpr bool B2 = decltype(b2)::value;
      const int* m = qmeta + s * QMETA * BQ;
      const uint32_t qs = saddr(q_st(s)), ds = saddr(do_st(s));
      const uint32_t ps_ = NOPE ? knw() : kw_();
      float sc[4][4], dp[4][4], d0[4][4];
      zero(sc);
      if constexpr (!B2) zero(dp);
      if constexpr (!B2 && RESET) zero(d0);
      wg_fence();
      wg_ss32x12(sc, desc_k(ps_, LQ), desc_k(qs, LQ));
      if constexpr (!B2) {
        wg_ss32x8(dp, desc_k(vw(), LV), desc_k(ds, LV));
        if constexpr (RESET) wg_ss32x8(d0, desc_k(v0w(), LV), desc_k(ds, LV));
      }
      wg_commit();
      wg_wait0();
      hold(sc);
      if constexpr (!B2) hold(dp);
      if constexpr (!B2 && RESET) hold(d0);
      auto pds = [&](auto all) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const Key ky = key(hh);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const Col cc = col(m, j);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool cin = q0 + j * 8 + 2 * cq + e < S;
              const int dd = cc.pos[e] - ky.pos;
              const bool ok = cc.sum[e] != 0 && (decltype(all)::value || attends(cc, e, ky, cin));
              float x = sc[j][2 * hh + e] * sl2;
              if (NOPE) x -= al2 * (float)dd;
              const float p = ok ? ex2(x - cc.l2[e]) : 0.f;
              if constexpr (B2) {
                sc[j][2 * hh + e] = p * reset_fast(a, dd);
              } else {
                float dpx = dp[j][2 * hh + e];
                if constexpr (RESET) dpx += reset_fast(a, dd) * (d0[j][2 * hh + e] - dpx);
                dp[j][2 * hh + e] = a.scale * p * (dpx - cc.dl[e]);
              }
            }
          }
        }
      };
      if (info & 2) pds(std::true_type());
      else pds(std::false_type());
      uint32_t fa[2][2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) a_frags<2>(B2 ? sc : dp, kk, fa[kk]);
      const uint64_t md = desc_mn(ds, LV), mq = desc_mn(qs, LQ);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int t = 1; t >= 0; --t) {
          if constexpr (B2) wg_rs128(YB, fa[kk][t], md + kk * MN_V);
          else wg_rs192(XB, fa[kk][t], mq + kk * MN_Q);
        }
      wg_commit();
      wg_wait0();
      if constexpr (B2) hold(YB);
      else hold(XB);
    };

    // Item i: wait until its stage is full; q0 and al2 of its (query head,
    // q tile), and its tile's bits for this warpgroup (each warp, a lane
    // per query row): bit 0 some key of it may be attended by a row of the
    // tile, bit 1 every pair attends (an interior tile), bit 2 the tile
    // holds a [SUM] row; -1 where the warpgroup skips the tile. Release
    // the stage once done (every consumer warp). A loop per phase, so that
    // one accumulator is live in each.
    const bool wg_live = k0 + 64 * wg < S;
    const Items it = items();
    const int nA = it.nA, nB1 = it.nB1, n_items = it.n_items;
    auto acquire = [&](int i, int& q0, float& al2) {
      // (the warpgroup's key ranges read here, not held through the loop)
      const int* ka = kagg + 5 * wg;
      const int kmin = ka[0], kmax = ka[1], ksmin = ka[2], ksmax = ka[3];
      const bool kplain = ka[4] != 0;
      const int s = i % ST;
      mbar_wait(&full[s], (i / ST) & 1);
      int rep, qt;
      item(it, i, rep, qt);
      q0 = qt * BQ;
      al2 = NOPE ? a.alibi[hk * n_rep + rep] * LOG2E : 0.f;
      const int* m = qmeta + s * QMETA * BQ;
      const bool in = q0 + lane < S;
      const int pq = m[lane];
      const int sgq = a.use_seg ? m[2 * BQ + lane] : 0;
      bool live = in && pq >= kmin && (long long)pq - a.window <= kmax;
      bool all = in && kplain && pq >= kmax && (long long)pq - kmin <= a.window;
      if (a.use_seg) {
        live = live && sgq >= ksmin && sgq <= ksmax;
        all = all && sgq == ksmin && ksmin == ksmax;
      }
      const bool sm = SUMC && in && m[BQ + lane] != 0;
      if (!wg_live || !__any_sync(FULL, live)) return -1;
      return 1 | (__all_sync(FULL, all) << 1) | (__any_sync(FULL, sm) << 2);
    };
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[i % ST]);
    };
    zero(Y);
    int i = 0;
    for (; i < nA; ++i) {
      int q0;
      float al2;
      const int info = acquire(i, q0, al2);
      if (info >= 0) {
        if (info & 4) phase_v(i % ST, q0, al2, info, std::true_type());
        else phase_v(i % ST, q0, al2, info, std::false_type());
      }
      release(i);
    }
    write(Y, a.g1, Dv);
    zero(X);
    for (; i < 2 * nA; ++i) {
      int q0;
      float al2;
      const int info = acquire(i, q0, al2);
      if (info >= 0) phase_k(i % ST, q0, info);
      release(i);
    }
    // dK_nope starts at 0 with NoPE; without, B1 continues dK
    if (NOPE) {
      write(X, a.g0, D);
      zero(XB);
    } else {
#pragma unroll
      for (int j = 0; j < DWIDE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) XB[j][e] = X[j][e];
    }
    for (; i < 2 * nA + nB1; ++i) {
      int q0;
      float al2;
      const int info = acquire(i, q0, al2);
      if (info >= 0) phase_b(i % ST, q0, al2, info, std::false_type());
      release(i);
    }
    write(XB, NOPE ? a.g2 : a.g0, D);
    if constexpr (RESET) {
      zero(YB);
      for (; i < n_items; ++i) {
        int q0;
        float al2;
        const int info = acquire(i, q0, al2);
        if (info >= 0) phase_b(i % ST, q0, al2, info, std::true_type());
        release(i);
      }
      write(YB, a.g3, Dv);
    }
  }
}

template <bool NOPE, bool RESET>
int launch_wg(const Args<bf16>& a, bool dkv, int smem, cudaStream_t stream) {
  // the plan must be this source's (windowed_bwd_plan)
  if (dkv) {
    using C = WgDkvCfg<NOPE, RESET>;
    if (smem != (int)C::BYTES || a.n_blocks != (a.S + C::BKV - 1) / C::BKV)
      return (int)cudaErrorInvalidValue;
    auto kern = dkv_wg_kernel<NOPE, RESET>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<dim3(a.n_blocks, a.Hk, a.B), WG_THREADS, smem, stream>>>(a);
  } else {
    using C = WgDqCfg<NOPE, RESET>;
    if (smem != (int)C::BYTES || a.n_blocks != (a.S + C::BQ - 1) / C::BQ)
      return (int)cudaErrorInvalidValue;
    auto kern = dq_wg_kernel<NOPE, RESET>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<dim3(a.H, a.n_blocks, a.B), WG_THREADS, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <typename T, bool NOPE, bool RESET, int DQ>
int launch(const Args<T>& a, bool dkv, int smem, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value && DQ == DWIDE) {
    return launch_wg<NOPE, RESET>(a, dkv, smem, stream);
  } else {
    // the plan must be this source's (windowed_bwd_plan)
    if (dkv) {
      using C = DkvCfg<T, NOPE, RESET, DQ>;
      if (smem != (int)C::BYTES || a.n_blocks != (a.S + C::BKV - 1) / C::BKV)
        return (int)cudaErrorInvalidValue;
      auto kern = dkv_kernel<T, NOPE, RESET, DQ>;
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      kern<<<dim3(a.n_blocks, a.Hk, a.B), C::THREADS, smem, stream>>>(a);
    } else {
      using C = DqCfg<T, NOPE, RESET, DQ>;
      if (smem != (int)C::BYTES || a.n_blocks != (a.S + C::BQ - 1) / C::BQ)
        return (int)cudaErrorInvalidValue;
      auto kern = dq_kernel<T, NOPE, RESET, DQ>;
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      kern<<<dim3(a.H, a.n_blocks, a.B), C::THREADS, smem, stream>>>(a);
    }
    return (int)cudaGetLastError();
  }
}

template <typename T, int DQ>
int dispatch_flags(const Args<T>& a, bool nope, bool reset, bool dkv, int smem, cudaStream_t st) {
  if (nope)
    return reset ? launch<T, true, true, DQ>(a, dkv, smem, st)
                 : launch<T, true, false, DQ>(a, dkv, smem, st);
  return reset ? launch<T, false, true, DQ>(a, dkv, smem, st)
               : launch<T, false, false, DQ>(a, dkv, smem, st);
}

// the head-dim class of q and K: DMAX up to 128, else DWIDE
template <typename T>
int dispatch(const Args<T>& a, bool nope, bool reset, bool dkv, int smem, cudaStream_t st) {
  return a.D <= DMAX ? dispatch_flags<T, DMAX>(a, nope, reset, dkv, smem, st)
                     : dispatch_flags<T, DWIDE>(a, nope, reset, dkv, smem, st);
}

template <typename T>
int run(const void* const* p, const int* n, const float* f, bool dkv, void* stream) {
  Args<T> a;
  a.q = static_cast<const T*>(p[0]);
  a.qn = static_cast<const T*>(p[1]);
  a.k = static_cast<const T*>(p[2]);
  a.kn = static_cast<const T*>(p[3]);
  a.v = static_cast<const T*>(p[4]);
  a.v0 = static_cast<const T*>(p[5]);
  a.dout = static_cast<const T*>(p[6]);
  a.lse = static_cast<const float*>(p[7]);
  a.delta = static_cast<const float*>(p[8]);
  a.alibi = static_cast<const float*>(p[9]);
  a.pos_q = static_cast<const int*>(p[10]);
  a.pos_k = static_cast<const int*>(p[11]);
  a.sum_q = static_cast<const int*>(p[12]);
  a.sum_k = static_cast<const int*>(p[13]);
  a.valid_k = static_cast<const int*>(p[14]);
  a.seg_q = static_cast<const int*>(p[15]);
  a.seg_k = static_cast<const int*>(p[16]);
  a.g0 = static_cast<T*>(const_cast<void*>(p[17]));
  a.g1 = static_cast<T*>(const_cast<void*>(p[18]));
  a.g2 = static_cast<T*>(const_cast<void*>(p[19]));
  a.g3 = static_cast<T*>(const_cast<void*>(p[20]));
  a.B = n[0]; a.S = n[1]; a.H = n[2]; a.Hk = n[3]; a.D = n[4]; a.Dv = n[5];
  a.window = n[6]; a.sum_isolated = n[9]; a.use_seg = n[10]; a.n_blocks = n[11];
  a.scale = f[0]; a.y_min = f[1]; a.y_max = f[2]; a.midpoint = f[3];
  // 16-byte copies need 16-byte rows and bases
  uintptr_t al = 0;
  for (int i = 0; i < 7; ++i) al |= (uintptr_t)p[i];
  a.direct = sizeof(T) == 2 && a.D % 8 == 0 && a.Dv % 8 == 0 && al % 16 == 0;
  return dispatch(a, n[7] != 0, n[8] != 0, dkv, n[12], static_cast<cudaStream_t>(stream));
}

int entry(bool dkv, const void* q, const void* qn, const void* k, const void* kn,
          const void* v, const void* v0, const void* dout, const void* lse,
          const void* delta, const void* alibi, const void* pos_q, const void* pos_k,
          const void* sum_q, const void* sum_k, const void* valid_k, const void* seg_q,
          const void* seg_k, void* g0, void* g1, void* g2, void* g3, int B, int S,
          int H, int Hk, int D, int Dv, int window, int use_nope, int use_reset,
          int sum_isolated, int use_seg, int is_bf16, int n_blocks, int smem,
          float scale, float y_min, float y_max, float midpoint, void* stream) {
  const bool outs_ok = dkv ? (g0 && g1 && (!use_nope || g2) && (!use_reset || g3))
                           : (g0 && (!use_nope || g1));
  if (D > DWIDE || Dv > DMAX || D <= 0 || Dv <= 0 || Hk <= 0 || H % Hk != 0 ||
      window <= 0 || !outs_ok || alibi == nullptr ||
      (use_nope && (qn == nullptr || kn == nullptr || sum_q == nullptr)) ||
      (use_reset && (v0 == nullptr || sum_q == nullptr)) ||
      (sum_isolated && sum_k == nullptr) ||
      (use_seg && (seg_q == nullptr || seg_k == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  const void* p[21] = {q, qn, k, kn, v, v0, dout, lse, delta, alibi, pos_q, pos_k,
                       sum_q, sum_k, valid_k, seg_q, seg_k, g0, g1, g2, g3};
  const int n[13] = {B, S, H, Hk, D, Dv, window, use_nope, use_reset, sum_isolated,
                     use_seg, n_blocks, smem};
  const float f[4] = {scale, y_min, y_max, midpoint};
  return is_bf16 ? run<bf16>(p, n, f, dkv, stream)
                 : run<float>(p, n, f, dkv, stream);
}

}  // namespace

// Both entry points return the launch's cudaError_t (0 = launched).
// Operands the flags switch off may be null; valid_k may be null (every
// key valid). lse and delta are fp32 (B, H, S); alibi fp32 (H,). The plan
// (n_blocks: q tiles of the dq pass, kv tiles of the dk/dv pass; `smem`
// bytes of dynamic shared memory) comes from `windowed_bwd_plan`; a plan
// this source does not make is refused.
// windowed_attn_dq: g0 = dq, g1 = dq_nope (use_nope), shaped as q.
// windowed_attn_dkv: g0 = dk, g1 = dv, g2 = dk_nope (use_nope), g3 = dv0
// (use_reset), shaped as k / v.
#define WINDOWED_BWD_PARAMS                                                        \
  const void *q, const void *qn, const void *k, const void *kn, const void *v,     \
      const void *v0, const void *dout, const void *lse, const void *delta,        \
      const void *alibi, const void *pos_q, const void *pos_k, const void *sum_q,  \
      const void *sum_k, const void *valid_k, const void *seg_q, const void *seg_k, \
      void *g0, void *g1, void *g2, void *g3, int B, int S, int H, int Hk, int D,  \
      int Dv, int window, int use_nope, int use_reset, int sum_isolated,           \
      int use_seg, int is_bf16, int n_blocks, int smem, float scale, float y_min,  \
      float y_max, float midpoint, void *stream
#define WINDOWED_BWD_ARGS                                                          \
  q, qn, k, kn, v, v0, dout, lse, delta, alibi, pos_q, pos_k, sum_q, sum_k,        \
      valid_k, seg_q, seg_k, g0, g1, g2, g3, B, S, H, Hk, D, Dv, window, use_nope, \
      use_reset, sum_isolated, use_seg, is_bf16, n_blocks, smem, scale, y_min,     \
      y_max, midpoint, stream

extern "C" int windowed_attn_dq(WINDOWED_BWD_PARAMS) {
  return entry(false, WINDOWED_BWD_ARGS);
}

extern "C" int windowed_attn_dkv(WINDOWED_BWD_PARAMS) {
  return entry(true, WINDOWED_BWD_ARGS);
}
