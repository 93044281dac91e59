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
// 1.64 and 2.06 TFLOP meet 7-8 GB of operands and gradients near the
// ridge.) So every product goes to the tensor cores, on kernel 1's design
// (windowed_attn.cu):
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
//   (DWIDE): the q, K, q_nope and K_nope planes' rows hold DQ + 8 values
//   (200: conflict-free for ldmatrix too), V's, V0's and dO's stay at 136.
//   A thread keeps the 128 class's accumulators in registers (dQ; dK and
//   dV); the wide class's dQ and dK columns past 128, another 32 fp32 a
//   thread, live in shared memory as this thread's fragments (XsAcc), each
//   k-step's products added there from fresh registers. So ptxas gives
//   both classes 160-242 registers and no spill (-Xptxas -v, sm_90a). At
//   192 a bf16 CTA takes 119-149 KiB: one CTA (4 warps) per SM. fp32's dq
//   CTA takes 2 warps (32 query rows): 4 would need 245-270 KiB with NoPE.
// * Occupancy (the 128 class). bf16: 87-105 KiB of shared memory and
//   160-236 registers (nvcc -Xptxas -v, no spills), 2 CTAs (8 warps) per
//   SM. The fp32 instantiation (and bf16 rows that are not 16-byte
//   aligned) converts each tile straight from memory into its term
//   planes; fp32 takes one stage (and its dk/dv pass 2 warps, 32 keys a
//   CTA): 104-206 KiB, 1 CTA per SM. `windowed_bwd_plan` in windowed_attn.py computes the grids,
//   stages and shared memory of the `Cfg`s below; the entry points refuse
//   a plan that differs.
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

template <typename T, bool NOPE, bool RESET, int DQ>
int launch(const Args<T>& a, bool dkv, int smem, cudaStream_t stream) {
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
