// Decode/burst attention into the KV cache for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attn/decode_attn.py, `_kernel`
// (launched by `decode_attention_bshd`), the Pallas TPU kernel, in both
// its modes: bf16/fp32 KV (entry point `decode_attn_fwd`) and int8 KV
// (`decode_attn_q8_fwd`, the same kernel template with QUANT set), at
// head dims up to 128 (GQA), and at the absorbed-MLA geometry
// (`decode_attn_mla_fwd`, `decode_attn_mla_q8_fwd`: WIDE set; see the
// end of this header).
//
// Computes, for s burst queries per batch row, an online-softmax pass over
// the row's cache in its native (B, cap, Hk, D) layout: a slot is
// attendable iff filled (pos_k >= 0), causal, within `window` when
// window > 0, and segment-compatible (seg_k < 0 shared, else equal to the
// query's). [SUM] rows score the NoPE stream minus ALiBi * distance. Rows
// with no key give 0.
//
// int8 mode: K and V arrive as raw int8 codes with fp32 scale sidecars,
// k_scale (B, cap, Hk, G) and v_scale (B, cap, Hk); keys are unroped. Each
// staged K slot is widened to fp32, every (x1, x2) half pair of the span
// [rope_start, D) is rotated by float(max(pos_k, 0)) * rope_inv[j] (one
// fp32 product, sincosf: the angle reaches thousands of radians, where
// the fast intrinsics lose digits), and the per-dim scale is applied:
// k_scale[..., 0] below rope_start, k_scale[..., G - 1] from it on. The
// NoPE stream of [SUM] rows is the same codes times the scale, unrotated.
// V's codes are staged as they are (integers in [-127, 127] are exact in
// bf16) and v_scale, one per slot, folds into the probabilities:
// P'[r, c] = P[r, c] * v_scale[c].
//
// What bounds it on this card: bytes. At the decode shape (B=8, cap=2048,
// s=64, H=32, Hk=8, D=128, a NoPE stream, window 1024) the attended K,
// K_nope and V are ~62 MB against ~8.6 GFLOP, ~140 FLOP/byte, under the
// ~295 FLOP/byte ridge. The design:
//
// * Split work. One CTA (4 warps, 16 query rows each) serves a block of
//   64 query rows over one kv range of one (kv head, batch row).
//   `decode_split_plan` in `decode_attn.py` picks the number of row blocks
//   (ceil(n_rep * s / 64)) and of kv splits, so that the grid covers the
//   card's SMs: row blocks re-read the same K/V tiles, from L2 when their
//   CTAs run together (blockIdx.x puts them side by side), and need no
//   workspace; kv splits are added only where row blocks are too few
//   (small s), and write fp32 partial (m, l, acc) rows to a workspace that
//   a second kernel of the same entry point combines in split order. No
//   float atomics: the result is deterministic.
// * Rows in product order. The n_rep heads x s queries of a (kv head,
//   batch row) are taken ordinary queries first, [SUM] queries after, so
//   all row blocks but one need only K or only K_nope, and all warps but
//   one only one of the two products (a warp computes the NoPE product
//   only if its 16 rows hold a [SUM] row).
// * Tensor-core products. Q.K^T and P.V are mma.sync m16n8k16 (bf16 in,
//   fp32 accumulate). An operand that is not exact in bf16 is split into
//   a sum of bf16 terms (x = hi + lo [+ lo2], each term the bf16 rounding
//   of what the previous ones left) and the products of the leading term
//   pairs are accumulated: bf16 q and K are one term each (their products
//   are exact in fp32); P is two terms (its error ~2^-17 of p, where one
//   term would add 2^-9); the int8 mode's roped, dequantized K is two
//   terms; the fp32 instantiation splits q, K, P and V into three terms
//   each and takes the six leading term pairs, an error ~2^-24 of each
//   product, the order of an fp32 product's own rounding (no TF32). The
//   softmax runs in base 2 (scores times log2 e, ex2.approx).
// * Only tiles that matter. A prologue lists the 32-slot tiles of the kv
//   range that hold a filled position some row may attend (from the
//   least query position minus the window to the greatest); the loop
//   walks that list only. Within a tile, slots no row may attend are
//   zero-filled without a read.
// * Overlap. Each listed tile is copied by 16-byte cp.async into one of
//   three shared-memory stages, two tiles ahead of the one being
//   computed, its copies issued once the current tile's Q.K^T mmas are
//   queued: in the bf16 mode K, K_nope and V straight into the planes the
//   mmas read; in the int8 mode the codes and scales, which a conversion
//   pass (widen, rope, dequantize, split) turns into planes. A tile's slot
//   positions travel S tiles ahead of its rows, so no copy waits on a
//   load. The fp32 mode (and rows not 16-byte aligned) convert straight
//   from memory.
//
// The absorbed-MLA mode (WIDE). `repro/serve/engine.py::_mla_decode_layer`
// calls the kernel as MQA (Hk = 1, Hq = n_heads) with q = [q_abs | q_pe]
// against the latent cache: Dqk = kv_lora_rank + qk_rope_dim (288 for
// minicpm3-4b), Dv = kv_lora_rank (256), and in int8 two scale groups
// split at rope_start = kv_lora_rank. Same algorithm, same pipeline; what
// differs is sized by `Geo<true>`:
//
// * Planes of Q, K and K_nope are DQ = 288 values wide (row stride 296,
//   conflict-free for ldmatrix); Q.K^T runs 18 k-steps of 16 from them.
// * The value columns are split over CTAs, DMAX = 128 per CTA (a grid
//   axis of n_dv chunks, `decode_split_plan`): each CTA keeps the 16 x 128
//   fp32 accumulator of a warp in 64 registers, as the GQA mode does, and
//   recomputes the scores of its rows. The chunks' m and l are equal bit
//   for bit (the same arithmetic on the same data); chunk 0 writes them to
//   the kv-split workspace.
// * Rows wider than 16 copy chunks are copied as (slot, chunk) pairs
//   strided over the block; Q is staged into its plane after the first
//   tiles' copies are issued.
// * fp32 (three bf16 terms) would need 3 x 64 x 296 x 2 bytes of Q planes
//   beside three-term K, K_nope and V planes, past 227 KB; so the fp32
//   instantiation has no Q plane and splits each A fragment from the
//   query rows in memory (L1) at every k-step.
//
// What bounds the MLA mode: operations. At the MLA decode shape (B=8,
// cap=2048, s=64, 40 heads on one latent key, window 1024) about 20 k
// query rows share each key, ~20 GFLOP against ~15 MB. The value split
// costs a second Q.K^T (1.53x the needed products); wgmma, TMA and reading
// V from K's tile (V is the first 256 columns of the same latent) are
// left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;             // cache slots per kv tile
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int RB = 16 * WARPS;     // query rows per CTA
constexpr int DMAX = 128;          // largest head dim (qk and v); value
                                   // columns per CTA in both modes
constexpr int NT_S = BK / 8;       // score n-tiles per warp and tile
constexpr int KK = BK / 16;        // P.V k-steps per tile
constexpr int MAX_TILES = 256;     // tiles of one kv range (decode_split_plan)
constexpr int NT_V = DMAX / 8;     // value n-tiles
constexpr int MLA_DQK = 288;       // the MLA mode's largest qk head dim
constexpr int MLA_DV = 256;        // and value head dim
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }

// Terms of each operand per instantiation (see the header).
template <typename T, bool QUANT>
struct Mode {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int NQ = F32 ? 3 : 1;
  static constexpr int NK = F32 ? 3 : (QUANT ? 2 : 1);
  static constexpr int NP = F32 ? 3 : 2;
  static constexpr int NV = (F32 && !QUANT) ? 3 : 1;
  static constexpr int STAGES = (F32 && !QUANT) ? 1 : 3;   // copy stages
  static constexpr int PSTAGES = (!F32 && !QUANT) ? 3 : 1;  // plane stages
};

// Plane widths per geometry: the GQA mode (head dims up to DMAX) and the
// MLA mode (qk dims up to MLA_DQK, values in DMAX-column chunks)
template <bool WIDE>
struct Geo {
  static constexpr int DQ = WIDE ? MLA_DQK : DMAX;   // Q, K, K_nope planes
  static constexpr int LDK = DQ + 8;       // their row stride: conflict-free
  static constexpr int LDV = DMAX + 8;     // the V planes' row stride
  // int8 mode, one copy stage: K codes (BK x DQ bytes), V codes (BK x
  // DMAX), K scales (BK x 2) and V scales (BK), as cp.async leaves them
  static constexpr int RAW_BYTES = BK * (DQ + DMAX) + 3 * BK * (int)sizeof(float);
};

// 8 values from p[0..n) (zero past n) as floats: one 16-byte load (bf16)
// or two (fp32) where p is 16-byte aligned and n >= 8
__device__ __forceinline__ void load8(const bf16* p, int n, float (&x)[8]) {
  if (n >= 8 && ((uintptr_t)p & 15) == 0) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = i < n ? __bfloat162float(p[i]) : 0.f;
  }
}
__device__ __forceinline__ void load8(const float* p, int n, float (&x)[8]) {
  if (n >= 8 && ((uintptr_t)p & 15) == 0) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    const float4 v = *reinterpret_cast<const float4*>(p + 4);
    x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
    x[4] = v.x; x[5] = v.y; x[6] = v.z; x[7] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = i < n ? p[i] : 0.f;
  }
}

// The MLA mode's fp32 A fragment of a k-step: rows (g, g + 8) from r[0],
// r[1] (null: a row past the block), columns c, c + 1, c + 8, c + 9 (zero
// from n on), each pair as N bf16 terms (see the header)
template <int N>
__device__ __forceinline__ void a_frag_rows(const float* const (&r)[2], int c,
                                            int n, uint32_t (&f)[N][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* p = r[i & 1];
    const int cc = c + (i >> 1) * 8;
    float x0 = (p != nullptr && cc < n) ? p[cc] : 0.f;
    float x1 = (p != nullptr && cc + 1 < n) ? p[cc + 1] : 0.f;
#pragma unroll
    for (int t = 0; t < N; ++t) {
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);   // x0 low
      f[t][i] = *reinterpret_cast<const uint32_t*>(&h2);
      x0 -= __low2float(h2);
      x1 -= __high2float(h2);
    }
  }
}

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
  const T *q, *qn, *k, *kn, *v;
  const signed char *kq, *vq;          // int8 mode: codes in place of k, v
  const float *ks, *vs, *rinv;         // int8 mode: scales, RoPE inverse freqs
  const float* alibi;
  const int *pos_q, *pos_k, *seg_q, *seg_k;
  const unsigned char* sum_q;          // bool flags
  T* o;
  float *ws_acc, *ws_m, *ws_l;         // kv-split partials (n_split > 1)
  int B, s, H, Hk, cap, D, Dv, window, use_seg, G, rope_start;
  int n_rb, n_split, span, n_dv, direct;
  float scale;
};

template <typename T, bool NOPE, bool QUANT, bool WIDE>
struct Smem {
  using M = Mode<T, QUANT>;
  using G = Geo<WIDE>;
  // the MLA mode's fp32 instantiation reads Q from memory (see the header)
  static constexpr bool QPLANE = !(WIDE && M::F32);
  static constexpr int NKN = NOPE ? M::NK : 0;
  static constexpr size_t Q_ELEMS = QPLANE ? (size_t)M::NQ * RB * G::LDK : 0;
  static constexpr size_t STAGE_ELEMS =
      (size_t)(M::NK + NKN) * BK * G::LDK + (size_t)M::NV * BK * G::LDV;
  static constexpr size_t RAW = QUANT ? (size_t)M::STAGES * G::RAW_BYTES : 0;
  static constexpr size_t BYTES =
      (Q_ELEMS + M::PSTAGES * STAGE_ELEMS) * sizeof(bf16) + RAW +
      (4 * M::STAGES * BK + BK + G::DQ / 2 + 6 * RB + 4 + 3 * MAX_TILES + 1) * sizeof(int);
};

template <typename T, bool NOPE, bool QUANT, bool WIDE>
__global__ void __launch_bounds__(THREADS, 2)
decode_attn_kernel(const Args<T> a) {
  using M = Mode<T, QUANT>;
  using L = Smem<T, NOPE, QUANT, WIDE>;
  using GE = Geo<WIDE>;
  constexpr int NQ = M::NQ, NK = M::NK, NP = M::NP, NV = M::NV;
  constexpr int S = M::STAGES, PS = M::PSTAGES, MS = 2 * S;
  constexpr int TQK = NQ > NK ? NQ : NK;     // term pairs i + j < TQK
  constexpr int TPV = NP > NV ? NP : NV;
  constexpr int LDK = GE::LDK, LDV = GE::LDV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_p = reinterpret_cast<bf16*>(smem_raw);
  bf16* st_p = q_p + L::Q_ELEMS;
  unsigned char* raw_p = reinterpret_cast<unsigned char*>(st_p + PS * L::STAGE_ELEMS);
  int* pos_ks = reinterpret_cast<int*>(raw_p + L::RAW);   // MS tiles' slots
  int* seg_ks = pos_ks + MS * BK;
  float* vs_s = reinterpret_cast<float*>(seg_ks + MS * BK);
  float* rinv_s = vs_s + BK;                              // int8: RoPE freqs
  int* pos_r = reinterpret_cast<int*>(rinv_s + GE::DQ / 2);
  int* sum_r = pos_r + RB;
  int* seg_r = sum_r + RB;
  float* alibi_r = reinterpret_cast<float*>(seg_r + RB);
  int* pq_span = reinterpret_cast<int*>(alibi_r + RB);   // min, max pos_q
  int* rq = pq_span + 2;                  // block row -> query, head
  int* rh = rq + RB;
  int* nps = rh + RB;                     // ordinary queries of the row
  int* tl = nps + 2;                      // the live tiles, then their count
  int* tlo = tl + MAX_TILES + 1;          // per tile: least, greatest
  int* thi = tlo + MAX_TILES;             // filled position
  // sized at launch: the row's queries, ordinary first, their positions
  // and segments (s each), the kv head's ALiBi slopes (n_rep)
  int* qlist = thi + MAX_TILES;
  int* qpos = qlist + a.s;
  int* qseg = qpos + a.s;
  float* qal = reinterpret_cast<float*>(qseg + a.s);
  auto k_pl = [&](int st, int t) { return st_p + st * L::STAGE_ELEMS + t * BK * LDK; };
  auto kn_pl = [&](int st, int t) { return k_pl(st, NK + t); };
  auto v_pl = [&](int st, int t) { return k_pl(st, NK + L::NKN) + t * BK * LDV; };
  auto raw_kq = [&](int st) {
    return reinterpret_cast<signed char*>(raw_p + st * GE::RAW_BYTES);
  };
  auto raw_vq = [&](int st) { return raw_kq(st) + BK * GE::DQ; };
  auto raw_ks = [&](int st) {    // [BK][2]
    return reinterpret_cast<float*>(raw_vq(st) + BK * DMAX);
  };
  auto raw_vs = [&](int st) { return raw_ks(st) + 2 * BK; };

  // blockIdx.x: row block, then (MLA mode) value chunk, then kv range
  const int rb = blockIdx.x % a.n_rb;
  const int dvc = WIDE ? (blockIdx.x / a.n_rb) % a.n_dv : 0;
  const int split = WIDE ? blockIdx.x / a.n_rb / a.n_dv : blockIdx.x / a.n_rb;
  const int hk = blockIdx.y, b = blockIdx.z;
  // Dv: this CTA's value columns [dv0, dv0 + Dv) of the a.Dv of a row
  const int dv0 = dvc * DMAX;
  const int n_rep = a.H / a.Hk, s = a.s, D = a.D, cap = a.cap;
  const int Dv = WIDE ? min(DMAX, a.Dv - dv0) : a.Dv;
  const int r0 = rb * RB, nr = min(RB, n_rep * s - r0);
  const int kv0 = split * a.span, kv1 = min(cap, kv0 + a.span);
  const int n_t = kv1 > kv0 ? (kv1 - kv0 + BK - 1) / BK : 0;
  const int DP = (D + 15) & ~15, DVP = (Dv + 15) & ~15;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, cq = lane & 3;
  const bool direct = S > 1 && a.direct;           // copies by cp.async
  const bool planes_direct = direct && PS > 1;       // straight into planes

  // The prologue makes two rounds of memory loads. First, with no
  // dependency: each warp's share of the positions (and segments) of the
  // kv range's first 16 * WARPS tiles, kept in registers for the first
  // ring slots and reduced to each tile's least and greatest filled
  // position; warp 0 the queries' flags, positions and segments; warp 1
  // the slopes.
  int pp[16], ps[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int t = warp + WARPS * i, slot = kv0 + t * BK + lane;
    const bool in = t < n_t && slot < kv1;
    pp[i] = in ? a.pos_k[(size_t)b * cap + slot] : -1;
    ps[i] = (in && a.use_seg) ? a.seg_k[(size_t)b * cap + slot] : -1;
  }
  // The rows of this (kv head, batch row), n_rep heads x s queries, are
  // taken by the row blocks in this order: every (head, ordinary query),
  // then every (head, [SUM] query). All blocks but one then need only one
  // of the two products and only one of K and K_nope, and all warps but
  // one only one product. Warp 0 lists the ordinary queries from the
  // front, the [SUM] ones from the back, keeping each one's position and
  // segment.
  if (warp == 0) {
    int n_plain = 0, n_sum = 0;
    for (int tb = 0; tb < s; tb += 64) {
      int f[2], qp[2], qs[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = tb + 32 * u + lane;
        f[u] = qp[u] = qs[u] = 0;
        if (t < s) {
          const size_t bs = (size_t)b * s + t;
          f[u] = (NOPE && a.sum_q != nullptr) ? (a.sum_q[bs] != 0) : 0;
          qp[u] = a.pos_q[bs];
          qs[u] = a.use_seg ? a.seg_q[bs] : 0;
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = tb + 32 * u + lane;
        if (t < s) {
          qpos[t] = qp[u];
          qseg[t] = qs[u];
        }
        const unsigned pb = __ballot_sync(FULL, t < s && !f[u]);
        const unsigned sb = __ballot_sync(FULL, t < s && f[u]);
        const unsigned below = (1u << lane) - 1u;
        if (t < s && !f[u]) qlist[n_plain + __popc(pb & below)] = t;
        if (t < s && f[u]) qlist[s - 1 - n_sum - __popc(sb & below)] = t;
        n_plain += __popc(pb);
        n_sum += __popc(sb);
      }
    }
    if (lane == 0) {
      nps[0] = n_plain;
      pq_span[0] = INT_MAX;
      pq_span[1] = INT_MIN;
    }
  } else if (warp == 1) {
    for (int i = lane; i < n_rep; i += 32) qal[i] = a.alibi[hk * n_rep + i];
  }
  // per tile: the least and greatest filled position (INT_MAX, -1: none);
  // tiles past the first 16 * WARPS in further rounds
  for (int tb = 0; tb < n_t; tb += 16 * WARPS) {
    int p[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int t = tb + warp + WARPS * i, slot = kv0 + t * BK + lane;
      p[i] = tb == 0 ? pp[i]
                     : (t < n_t && slot < kv1) ? a.pos_k[(size_t)b * cap + slot] : -1;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int t = tb + warp + WARPS * i;
      const int lo = __reduce_min_sync(FULL, p[i] >= 0 ? p[i] : INT_MAX);
      const int hi = __reduce_max_sync(FULL, p[i]);
      if (lane == 0 && t < n_t) {
        tlo[t] = lo;
        thi[t] = hi;
      }
    }
  }
  __syncthreads();
  {
    const int n_plain = nps[0], n_sq = s - n_plain;
    for (int r = tid; r < RB; r += THREADS) {
      int t = 0, h = 0, sm = 0;
      if (r < nr) {
        const int k = r0 + r;
        if (k < n_rep * n_plain) {
          h = k / n_plain;
          t = qlist[k - h * n_plain];
        } else {
          const int k2 = k - n_rep * n_plain;
          h = k2 / n_sq;
          t = qlist[n_plain + k2 - h * n_sq];
          sm = 1;
        }
        atomicMin(pq_span, qpos[t]);      // integer: the result is order-free
        atomicMax(pq_span + 1, qpos[t]);
      }
      rq[r] = t;
      rh[r] = h;
      sum_r[r] = sm;
      pos_r[r] = r < nr ? qpos[t] : 0;
      seg_r[r] = r < nr ? qseg[t] : 0;
      alibi_r[r] = r < nr ? qal[h] : 0.f;
    }
  }
  if (QUANT)
    for (int i = tid; i < (D - a.rope_start) / 2; i += THREADS) rinv_s[i] = a.rinv[i];
  if (planes_direct && (D % 16 || Dv % 16)) {   // pads cp.async never writes
    for (int i = tid; i < PS * (int)L::STAGE_ELEMS; i += THREADS)
      st_p[i] = __ushort_as_bfloat16((unsigned short)0);
  }
  const int any_sum = NOPE ? __syncthreads_or(tid < nr && sum_r[tid]) : 0;
  const int any_plain = __syncthreads_or(tid < nr && !sum_r[tid]);
  const int pq_min = pq_span[0], pq_max = pq_span[1];
  // Second round: this block's Q rows, loaded into registers now and
  // written to the Q planes once the first tiles' copies are on their way.
  // Q planes ([SUM] rows hold q_nope), zero past D and past the last row:
  // thread tid takes 8 values (chunk tid % 16) of rows tid / 16 + 8 i.
  // (The MLA mode's rows are wider: it loads them when it writes them.)
  const int qch = tid & 15, qr = tid >> 4;
  // block row r's query vector (q_nope for a [SUM] row)
  auto q_row = [&](int r) {
    return ((NOPE && sum_r[r]) ? a.qn : a.q) +
           (((size_t)b * s + rq[r]) * a.H + hk * n_rep + rh[r]) * D;
  };
  float qx[WIDE ? 1 : RB / 8][8];
  if constexpr (!WIDE) {
#pragma unroll
    for (int i = 0; i < RB / 8; ++i) {
      const int r = qr + 8 * i;
      if (r < nr && qch * 8 < D) {
        load8(q_row(r) + qch * 8, D - qch * 8, qx[i]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) qx[i][e] = 0.f;
      }
    }
  }
  // The tiles of this kv range that hold a filled position in
  // [pq_min - window, pq_max] (some row may attend them), listed in order
  // by warp 0. The loop below walks this list only: "tile kt" is the kt-th
  // listed tile, from slot t0(kt) on.
  auto live = [&](int pk) {
    return pk >= 0 && pk <= pq_max && (a.window <= 0 || pq_min - pk <= a.window);
  };
  if (warp == 0) {
    int base = 0;
    for (int tb = 0; tb < n_t; tb += 32) {
      const int tt = tb + lane;
      const bool on = tt < n_t && thi[tt] >= 0 && tlo[tt] <= pq_max &&
                      (a.window <= 0 || pq_min - thi[tt] <= a.window);
      const unsigned bal = __ballot_sync(FULL, on);
      if (on) tl[base + __popc(bal & ((1u << lane) - 1u))] = tt;
      base += __popc(bal);
    }
    if (lane == 0) tl[MAX_TILES] = base;
  }
  __syncthreads();
  const int n_live = tl[MAX_TILES];
  auto t0 = [&](int kt) { return kv0 + tl[kt] * BK; };

  // live tile j's slot positions and segments into ring slot j % MS: by
  // cp.async (4 bytes a slot, zero past the range), or by loads
  auto meta_issue = [&](int j) {
    const int c = tid & (BK - 1), slot = j < n_live ? t0(j) + c : kv1;
    const bool ok = slot < kv1;
    const size_t off = (size_t)b * cap + (ok ? slot : 0);
    if (tid < BK)
      cp4(pos_ks + (j % MS) * BK + c, a.pos_k + off, ok);
    else if (tid < 2 * BK && a.use_seg)
      cp4(seg_ks + (j % MS) * BK + c, a.seg_k + off, ok);
  };
  auto meta_sync = [&](int j) {
    const int c = tid & (BK - 1), slot = t0(j) + c;
    const size_t off = (size_t)b * cap + slot;
    if (tid < BK)
      pos_ks[(j % MS) * BK + c] = slot < kv1 ? a.pos_k[off] : -1;
    else if (tid < 2 * BK && a.use_seg)
      seg_ks[(j % MS) * BK + c] = slot < kv1 ? a.seg_k[off] : -1;
  };
  // slot c of live tile j if some row of the block may attend it, else -1
  auto pk_at = [&](int j, int c) {
    const int p = pos_ks[(j % MS) * BK + c];
    return (t0(j) + c < kv1 && live(p)) ? p : -1;
  };
  // cp.async of tile kt: bf16 K, K_nope and V rows into plane stage kt % S,
  // or int8 codes and scales into copy stage kt % S; slots no row attends
  // are zero-filled without a read
  // Thread tid copies 16-byte chunk tid % 16 of slots tid / 16 + 8 i; in
  // the MLA mode the (slot, chunk) pairs of K, then V, in turn.
  // int8 mode: the tile's K scales (G a slot) and V scales into copy stage
  // kt % S
  auto issue_scales = [&](int kt) {
    const int st = kt % S, k0 = t0(kt);
    if (tid < BK * a.G) {
      const int c = a.G == 1 ? tid : tid >> 1, gi = tid - c * a.G;
      const bool on = pk_at(kt, c) >= 0;
      const size_t sh = ((size_t)b * cap + (on ? k0 + c : 0)) * a.Hk + hk;
      cp4(raw_ks(st) + 2 * c + gi, a.ks + sh * a.G + gi, on);
      if (gi == 0) cp4(raw_vs(st) + c, a.vs + sh, on);
    }
  };
  auto issue_wide = [&](int kt) {
    const int st = kt % S, k0 = t0(kt);
    const int kc = QUANT ? D / 16 : D / 8, vc = QUANT ? Dv / 16 : Dv / 8;
    const bf16* k = reinterpret_cast<const bf16*>(a.k);
    const bf16* kn = reinterpret_cast<const bf16*>(a.kn);
    const bf16* v = reinterpret_cast<const bf16*>(a.v);
    for (int i = tid; i < BK * (kc + vc); i += THREADS) {
      const bool is_k = i < BK * kc;
      const int j = is_k ? i : i - BK * kc, w = is_k ? kc : vc;
      const int c = j / w, ch = j - c * w;
      const bool ok = pk_at(kt, c) >= 0;
      const size_t row = ((size_t)b * cap + (ok ? k0 + c : 0)) * a.Hk + hk;
      if (QUANT) {
        if (is_k)
          cp16(raw_kq(st) + c * D + ch * 16, a.kq + row * D + ch * 16, ok);
        else
          cp16(raw_vq(st) + c * Dv + ch * 16, a.vq + row * a.Dv + dv0 + ch * 16, ok);
      } else if (is_k) {
        if (any_plain)
          cp16(k_pl(st, 0) + c * LDK + ch * 8, k + row * D + ch * 8, ok);
        if (NOPE && any_sum)
          cp16(kn_pl(st, 0) + c * LDK + ch * 8, kn + row * D + ch * 8, ok);
      } else {
        cp16(v_pl(st, 0) + c * LDV + ch * 8, v + row * a.Dv + dv0 + ch * 8, ok);
      }
    }
  };
  auto issue = [&](int kt) {
    const int st = kt % S, k0 = t0(kt);
    if constexpr (WIDE) {
      issue_wide(kt);
      if (QUANT) issue_scales(kt);
      return;
    }
    const int ch = tid & 15, c0 = tid >> 4;
    bool ok[BK / 8];
    size_t row[BK / 8];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      const int c = c0 + 8 * i;
      ok[i] = pk_at(kt, c) >= 0;
      row[i] = ((size_t)b * cap + (ok[i] ? k0 + c : 0)) * a.Hk + hk;
    }
    if (QUANT) {
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        const int c = c0 + 8 * i;
        if (ch < D / 16)
          cp16(raw_kq(st) + c * D + ch * 16, a.kq + row[i] * D + ch * 16, ok[i]);
        if (ch < Dv / 16)
          cp16(raw_vq(st) + c * Dv + ch * 16, a.vq + row[i] * a.Dv + ch * 16, ok[i]);
      }
      issue_scales(kt);
    } else {
      const bf16* k = reinterpret_cast<const bf16*>(a.k);
      const bf16* kn = reinterpret_cast<const bf16*>(a.kn);
      const bf16* v = reinterpret_cast<const bf16*>(a.v);
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        const int c = c0 + 8 * i;
        if (ch < D / 8) {
          if (any_plain)
            cp16(k_pl(st, 0) + c * LDK + ch * 8, k + row[i] * D + ch * 8, ok[i]);
          if (NOPE && any_sum)
            cp16(kn_pl(st, 0) + c * LDK + ch * 8, kn + row[i] * D + ch * 8, ok[i]);
        }
        if (ch < Dv / 8)
          cp16(v_pl(st, 0) + c * LDV + ch * 8, v + row[i] * a.Dv + ch * 8, ok[i]);
      }
    }
  };
  // the conversion pass: every mode, from the tile's pos_ks
  // A warp per slot, lanes along the head dim: the slot's test is uniform
  // and no index needs a division.
  auto convert = [&](int kt) {
    const int st = kt % PS, cs = kt % S, k0 = t0(kt);
    const int* pks = pos_ks + (kt % MS) * BK;
    for (int c = warp; c < BK; c += WARPS) {
      const int pk = pks[c];
      const size_t sh = ((size_t)b * cap + k0 + c) * a.Hk + hk;
      bf16* kr = k_pl(st, 0) + c * LDK;
      bf16* kx = kn_pl(st, 0) + c * LDK;
      bf16* vr = v_pl(st, 0) + c * LDV;
      const bool kn_on = NOPE && any_sum;
      if (pk < 0) {                       // nothing attends it: zeros
        for (int d = lane; d < DP; d += 32) {
          split_store<NK>(0.f, kr + d, BK * LDK);
          if (kn_on) split_store<NK>(0.f, kx + d, BK * LDK);
        }
        for (int d = lane; d < DVP; d += 32) split_store<NV>(0.f, vr + d, BK * LDV);
        if (QUANT && lane == 0) vs_s[c] = 0.f;
        continue;
      }
      if (QUANT) {
        // int8 operands: from the copy stage, or from memory
        const signed char* kq = direct ? raw_kq(cs) + c * D : a.kq + sh * D;
        const signed char* vq = direct ? raw_vq(cs) + c * Dv : a.vq + sh * a.Dv + dv0;
        const float* ksc = direct ? raw_ks(cs) + 2 * c : a.ks + sh * a.G;
        const int rs = a.rope_start, half = (D - rs) / 2;
        const float s0 = ksc[0], s1 = ksc[a.G - 1];
        // dims below rope_start: scale group 0, unrotated; then the pad
        for (int d = lane; d < rs + DP - D; d += 32) {
          const int dd = d < rs ? d : D + d - rs;
          const float x = dd < D ? (float)kq[dd] * s0 : 0.f;
          if (any_plain) split_store<NK>(x, kr + dd, BK * LDK);
          if (kn_on) split_store<NK>(x, kx + dd, BK * LDK);
        }
        // the span [rope_start, D): one rotation per half pair
        for (int j = lane; j < half; j += 32) {
          const float x1 = (float)kq[rs + j], x2 = (float)kq[rs + half + j];
          if (any_plain) {          // the roped keys serve ordinary rows only
            float sn, cn;
            sincosf((float)pk * rinv_s[j], &sn, &cn);
            split_store<NK>((x1 * cn - x2 * sn) * s1, kr + rs + j, BK * LDK);
            split_store<NK>((x1 * sn + x2 * cn) * s1, kr + rs + half + j, BK * LDK);
          }
          if (kn_on) {
            split_store<NK>(x1 * s1, kx + rs + j, BK * LDK);
            split_store<NK>(x2 * s1, kx + rs + half + j, BK * LDK);
          }
        }
        for (int d = lane; d < DVP; d += 32)
          split_store<NV>(d < Dv ? (float)vq[d] : 0.f, vr + d, BK * LDV);
        if (lane == 0) vs_s[c] = direct ? raw_vs(cs)[c] : a.vs[sh];
      } else {
        for (int d = lane; d < DP; d += 32) {
          if (any_plain)
            split_store<NK>(d < D ? to_f(a.k[sh * D + d]) : 0.f, kr + d, BK * LDK);
          if (kn_on)
            split_store<NK>(d < D ? to_f(a.kn[sh * D + d]) : 0.f, kx + d, BK * LDK);
        }
        for (int d = lane; d < DVP; d += 32)
          split_store<NV>(d < Dv ? to_f(a.v[sh * a.Dv + dv0 + d]) : 0.f, vr + d, BK * LDV);
      }
    }
  };

  // this thread's two rows (g, g + 8 of its warp's 16)
  const int wr0 = warp * 16;
  const bool w_live = wr0 < nr;
  __syncthreads();   // the row tiles are written
  // which products this warp's rows need: Q.K^T for ordinary rows,
  // Qn.Kn^T for [SUM] rows (both only where the sort leaves a mixed warp)
  const int wrow = min(wr0 + (lane & 15), RB - 1);
  const bool w_sum = NOPE && any_sum &&
                     __any_sync(FULL, wr0 + (lane & 15) < nr && sum_r[wrow]);
  const bool w_plain = __any_sync(FULL, wr0 + (lane & 15) < nr && !sum_r[wrow]);
  int pq[2], sg[2];
  bool rin[2], rsum[2];
  float al[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr0 + g + 8 * h;
    rin[h] = r < nr;
    pq[h] = pos_r[r];
    sg[h] = seg_r[r];
    rsum[h] = NOPE && sum_r[r] != 0;
    al[h] = alibi_r[r];
  }
  // the MLA mode's fp32 instantiation: this thread's two query rows in
  // memory, from which it builds its A fragments (no Q plane)
  const float* qg[2] = {nullptr, nullptr};
  if constexpr (!L::QPLANE) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (rin[h]) qg[h] = q_row(wr0 + g + 8 * h);
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NT_V][4];
#pragma unroll
  for (int j = 0; j < NT_V; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // copies of tile kt + S - 1 and positions of tile kt + 2S - 1: one
  // cp.async group per tile
  auto next = [&](int kt) {
    if (kt + S - 1 < n_live) issue(kt + S - 1);
    meta_issue(kt + 2 * S - 1);
    cp_commit();
  };
  // `issued`: the next tile's copies were issued once this tile's Q.K^T
  // mmas were queued, so that a stalled copy waits beside them
  auto compute = [&](int kt, bool& issued) {
    const int st = kt % PS;
    const int* pks = pos_ks + (kt % MS) * BK;
    const int* sks = seg_ks + (kt % MS) * BK;
    float sc[NT_S][4], sn[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = sn[j][e] = 0.f;
    // Q.K^T and Qn.Kn^T, as this warp's rows need them
    const int nkd = DP / 16;
    const bool w_n = NOPE && w_sum;
    const bf16* qrow = q_p + (wr0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDK + (lane >> 4) * 8;
    const int koff = ((lane & 7) + (lane >> 4) * 8) * LDK + ((lane >> 3) & 1) * 8;
    for (int kd = 0; kd < nkd; ++kd) {
      uint32_t fq[NQ][4], fk[NK][2][4], fn[NK][2][4];
      if constexpr (L::QPLANE) {
#pragma unroll
        for (int t = 0; t < NQ; ++t) ldsm_x4(fq[t], qrow + t * RB * LDK + kd * 16);
      } else {
        a_frag_rows<NQ>(qg, kd * 16 + 2 * cq, D, fq);
      }
#pragma unroll
      for (int tk = 0; tk < NK; ++tk)
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          if (w_plain) ldsm_x4(fk[tk][jp], k_pl(st, tk) + jp * 16 * LDK + koff + kd * 16);
          if (w_n) ldsm_x4(fn[tk][jp], kn_pl(st, tk) + jp * 16 * LDK + koff + kd * 16);
        }
#pragma unroll
      for (int tk = 0; tk < NK; ++tk)
#pragma unroll
        for (int tq = 0; tq < NQ; ++tq)
          if (tq + tk < TQK) {
            if (w_plain) {
#pragma unroll
              for (int jp = 0; jp < 2; ++jp) {
                mma(sc[2 * jp], fq[tq], fk[tk][jp][0], fk[tk][jp][1]);
                mma(sc[2 * jp + 1], fq[tq], fk[tk][jp][2], fk[tk][jp][3]);
              }
            }
            if (w_n) {
#pragma unroll
              for (int jp = 0; jp < 2; ++jp) {
                mma(sn[2 * jp], fq[tq], fn[tk][jp][0], fn[tk][jp][1]);
                mma(sn[2 * jp + 1], fq[tq], fn[tk][jp][2], fn[tk][jp][3]);
              }
            }
          }
    }

    if (direct) {
      next(kt);
      issued = true;
    }

    // masks, ALiBi, online softmax in base 2 (scores times log2 e);
    // element (j, 2h + e) is row g + 8h, column j * 8 + 2 cq + e
    int cpk[NT_S][2], csk[NT_S][2];
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        cpk[j][e] = pks[j * 8 + 2 * cq + e];
        csk[j][e] = a.use_seg ? sks[j * 8 + 2 * cq + e] : -1;
      }
    const unsigned wlim = a.window > 0 ? (unsigned)a.window : (unsigned)INT_MAX;
    const float sl2 = a.scale * LOG2E;
    uint32_t pa[NP][KK][4];
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int pk = cpk[j][e], dd = pq[h] - pk;
          // filled, causal and in the window in one unsigned compare
          const bool ok = rin[h] && pk >= 0 && (unsigned)dd <= wlim &&
                          (csk[j][e] < 0 || csk[j][e] == sg[h]);
          float x = (rsum[h] ? sn[j][2 * h + e] : sc[j][2 * h + e]) * sl2;
          if (NOPE && rsum[h]) x -= al[h] * LOG2E * (float)dd;
          sc[j][2 * h + e] = ok ? x : -INFINITY;
          tmax = fmaxf(tmax, sc[j][2 * h + e]);
        }
      tmax = fmaxf(tmax, __shfl_xor_sync(FULL, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(FULL, tmax, 2));
      const float m_new = fmaxf(m[h], tmax);
      float rs = 0.f;
      alpha[h] = 1.f;
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[j][2 * h + e];
          x = m_new == -INFINITY ? 0.f : ex2(x - m_new);
          rs += x;
        }
      if (m_new != -INFINITY) {
        alpha[h] = ex2(m[h] - m_new);
        m[h] = m_new;
      }
      rs += __shfl_xor_sync(FULL, rs, 1);
      rs += __shfl_xor_sync(FULL, rs, 2);
      l[h] = l[h] * alpha[h] + rs;
    }
    if (__any_sync(FULL, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < NT_V; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }
    }
    // P (times v_scale in the int8 mode) as NP bf16 terms, in the A layout
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 2 * kk + (i >> 1), h = i & 1;
        float x0 = sc[j][2 * h], x1 = sc[j][2 * h + 1];
        if (QUANT) {
          x0 *= vs_s[j * 8 + 2 * cq];
          x1 *= vs_s[j * 8 + 2 * cq + 1];
        }
#pragma unroll
        for (int t = 0; t < NP; ++t) {
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);   // x0 low
          pa[t][kk][i] = *reinterpret_cast<const uint32_t*>(&h2);
          x0 -= __low2float(h2);
          x1 -= __high2float(h2);
        }
      }
    // P.V: four 16-column pairs of V fragments loaded, then their mmas
    const int voff = ((lane & 7) + ((lane >> 3) & 1) * 8) * LDV + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int n4 = 0; n4 < NT_V / 8; ++n4) {
        if (n4 * 64 < DVP) {
          uint32_t bv[NV][4][4];
#pragma unroll
          for (int tv = 0; tv < NV; ++tv)
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if ((n4 * 4 + u) * 16 < DVP)
                ldsm_x4_t(bv[tv][u], v_pl(st, tv) + kk * 16 * LDV + voff + (n4 * 4 + u) * 16);
#pragma unroll
          for (int tv = 0; tv < NV; ++tv)
#pragma unroll
            for (int tp = 0; tp < NP; ++tp)
              if (tp + tv < TPV) {
#pragma unroll
                for (int u = 0; u < 4; ++u)
                  if ((n4 * 4 + u) * 16 < DVP) {
                    const int np = n4 * 4 + u;
                    mma(acc[2 * np], pa[tp][kk], bv[tv][u][0], bv[tv][u][1]);
                    mma(acc[2 * np + 1], pa[tp][kk], bv[tv][u][2], bv[tv][u][3]);
                  }
              }
        }
      }
  };

  // The pipeline (cp.async groups): tile kt + S - 1's rows and tile
  // kt + 2S - 1's slot positions are in flight while tile kt is computed;
  // a tile's rows are copied once its positions have arrived, so no copy
  // waits on a load.
  if (direct && n_live > 0) {
    // ring slots of the first S live tiles: from the registers kept above,
    // or by cp.async for a tile past the first 16 * WARPS
    for (int kt = 0; kt < S && kt < n_live; ++kt) {
      const int tt = tl[kt];
      if (tt >= 16 * WARPS) {
        meta_issue(kt);
        continue;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (warp + WARPS * i == tt) {
          pos_ks[kt * BK + lane] = pp[i];
          seg_ks[kt * BK + lane] = ps[i];
        }
    }
    cp_commit();
    cp_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kt = 0; kt < S - 1; ++kt) {
      if (kt < n_live) issue(kt);
      meta_issue(kt + S);
      cp_commit();
    }
  }
  // 8 Q values as bf16 terms at dst (one 16-byte store when one term)
  auto q_store = [&](bf16* dst, const float (&x)[8]) {
    if (NQ == 1) {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
        w[e] = *reinterpret_cast<const uint32_t*>(&h2);
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) split_store<NQ>(x[e], dst + e, RB * LDK);
    }
  };
  if constexpr (WIDE) {
    if constexpr (L::QPLANE) {   // (row, 8-value chunk) pairs over the block
      const int nch = DP / 8;
      for (int i = tid; i < RB * nch; i += THREADS) {
        const int r = i / nch, ch = i - r * nch;
        float x[8];
        if (r < nr && ch * 8 < D) {
          load8(q_row(r) + ch * 8, D - ch * 8, x);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) x[e] = 0.f;
        }
        q_store(q_p + r * LDK + ch * 8, x);
      }
    }
  } else if (qch * 8 < DP) {
#pragma unroll
    for (int i = 0; i < RB / 8; ++i) q_store(q_p + (qr + 8 * i) * LDK + qch * 8, qx[i]);
  }
  // the Q planes are read after the loop's first barrier
  for (int kt = 0; kt < n_live; ++kt) {
    if (direct)
      cp_wait<(S > 1 ? S - 2 : 0)>();   // tile kt's group
    else
      meta_sync(kt);
    // each of the first BK threads filters its own slot of this tile
    int pk = -1;
    if (tid < BK) {
      pk = pk_at(kt, tid);
      pos_ks[(kt % MS) * BK + tid] = pk;
    }
    bool issued = false;
    if (__syncthreads_or(pk >= 0)) {
      if (!planes_direct) {
        convert(kt);
        __syncthreads();
      }
      if (w_live) compute(kt, issued);
    }
    if (direct && !issued) next(kt);
    // no barrier here: tile kt + 1's barrier comes before any write to a
    // stage or ring slot that tile kt reads
  }
  if (direct) cp_wait<0>();

  const size_t rows = (size_t)a.B * s * a.H;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr0 + g + 8 * h;
    if (r >= nr) continue;
    const int hh = hk * n_rep + rh[r], t = rq[r];
    const size_t row = ((size_t)b * s + t) * a.H + hh;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
#pragma unroll
    for (int j = 0; j < NT_V; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * cq + e;
        if (col >= Dv) continue;
        if (a.n_split == 1)
          store(a.o + row * a.Dv + dv0 + col, acc[j][2 * h + e] * inv);
        else
          a.ws_acc[((size_t)split * rows + row) * a.Dv + dv0 + col] = acc[j][2 * h + e];
      }
    if (a.n_split > 1 && cq == 0 && dv0 == 0) {   // chunk 0's m and l
      a.ws_m[(size_t)split * rows + row] = m[h];
      a.ws_l[(size_t)split * rows + row] = l[h];
    }
  }
}

// The kv splits' partial rows (m in base 2) -> o, in split order.
template <typename T>
__global__ void __launch_bounds__(256)
combine_kernel(const float* __restrict__ ws_acc, const float* __restrict__ ws_m,
               const float* __restrict__ ws_l, T* __restrict__ o, size_t rows,
               int Dv, int n_split) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * Dv) return;
  const size_t row = idx / Dv;
  float mx = -INFINITY;
  for (int sp = 0; sp < n_split; ++sp) mx = fmaxf(mx, ws_m[sp * rows + row]);
  float lsum = 0.f, acc = 0.f;
  if (mx != -INFINITY) {
    for (int sp = 0; sp < n_split; ++sp) {
      const float ms = ws_m[sp * rows + row];
      const float w = ms == -INFINITY ? 0.f : exp2f(ms - mx);
      lsum += ws_l[sp * rows + row] * w;
      acc += ws_acc[sp * rows * Dv + idx] * w;
    }
  }
  store(o + idx, lsum > 0.f ? acc * (1.f / lsum) : 0.f);
}

template <typename T, bool NOPE, bool QUANT, bool WIDE>
int launch(const Args<T>& a, cudaStream_t stream) {
  const size_t smem = Smem<T, NOPE, QUANT, WIDE>::BYTES + (3 * (size_t)a.s + a.H / a.Hk) * 4;
  auto kern = decode_attn_kernel<T, NOPE, QUANT, WIDE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.n_rb * a.n_dv * a.n_split, a.Hk, a.B);
  kern<<<grid, THREADS, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.n_split == 1) return (int)e;
  const size_t rows = (size_t)a.B * a.s * a.H, n = rows * a.Dv;
  combine_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      a.ws_acc, a.ws_m, a.ws_l, a.o, rows, a.Dv, a.n_split);
  return (int)cudaGetLastError();
}

// The operands both modes share; k/v are T in the bf16/fp32 mode and int8
// codes (with ks/vs/rinv) in the int8 mode.
struct Ptrs {
  const void *q, *qn, *k, *kn, *v, *ks, *vs, *rinv, *alibi;
  const void *pos_q, *pos_k, *sum_q, *seg_q, *seg_k;
  void *o, *ws;
};

struct Plan {
  int n_rb, n_split, span, n_dv;
};

template <typename T, bool WIDE>
int run(const Ptrs& p, const Plan& pl, int B, int s, int H, int Hk, int cap,
        int D, int Dv, int G, int rope_start, int window, int use_nope,
        int use_seg, int quant, float scale, cudaStream_t st) {
  Args<T> a;
  a.q = static_cast<const T*>(p.q);
  a.qn = static_cast<const T*>(p.qn);
  a.k = static_cast<const T*>(p.k);
  a.kn = static_cast<const T*>(p.kn);
  a.v = static_cast<const T*>(p.v);
  a.kq = static_cast<const signed char*>(p.k);
  a.vq = static_cast<const signed char*>(p.v);
  a.ks = static_cast<const float*>(p.ks);
  a.vs = static_cast<const float*>(p.vs);
  a.rinv = static_cast<const float*>(p.rinv);
  a.alibi = static_cast<const float*>(p.alibi);
  a.pos_q = static_cast<const int*>(p.pos_q);
  a.pos_k = static_cast<const int*>(p.pos_k);
  a.sum_q = static_cast<const unsigned char*>(p.sum_q);
  a.seg_q = static_cast<const int*>(p.seg_q);
  a.seg_k = static_cast<const int*>(p.seg_k);
  a.o = static_cast<T*>(p.o);
  const size_t rows = (size_t)B * s * H;
  a.ws_acc = static_cast<float*>(p.ws);
  a.ws_m = a.ws_acc == nullptr ? nullptr : a.ws_acc + (size_t)pl.n_split * rows * Dv;
  a.ws_l = a.ws_m == nullptr ? nullptr : a.ws_m + (size_t)pl.n_split * rows;
  a.B = B; a.s = s; a.H = H; a.Hk = Hk; a.cap = cap; a.D = D; a.Dv = Dv;
  a.window = window; a.use_seg = use_seg; a.scale = scale;
  a.G = G; a.rope_start = rope_start;
  a.n_rb = pl.n_rb; a.n_split = pl.n_split; a.span = pl.span; a.n_dv = pl.n_dv;
  // 16-byte copies need 16-byte rows and bases
  const uintptr_t al = (uintptr_t)p.k | (uintptr_t)p.v |
                       (use_nope && !quant ? (uintptr_t)p.kn : 0);
  const int row = quant ? 16 : 8;    // elements in 16 bytes
  a.direct = (quant || sizeof(T) == 2) && D % row == 0 && Dv % row == 0 &&
             al % 16 == 0;
  if (quant)
    return use_nope ? launch<T, true, true, WIDE>(a, st) : launch<T, false, true, WIDE>(a, st);
  return use_nope ? launch<T, true, false, WIDE>(a, st) : launch<T, false, false, WIDE>(a, st);
}

// `wide`: the MLA mode (qk dims up to MLA_DQK, values up to MLA_DV in
// n_dv chunks of DMAX columns); else the GQA mode (both up to DMAX)
int dispatch(const Ptrs& p, const Plan& pl, int B, int s, int H, int Hk,
             int cap, int D, int Dv, int G, int rope_start, int window,
             int use_nope, int use_seg, int quant, int is_bf16, float scale,
             int wide, void* stream) {
  if (D > (wide ? MLA_DQK : DMAX) || Dv > (wide ? MLA_DV : DMAX) ||
      D <= 0 || Dv <= 0 || Hk <= 0 || H % Hk != 0 ||
      (use_nope && (p.qn == nullptr || p.sum_q == nullptr ||
                    (!quant && p.kn == nullptr))) ||
      (use_seg && (p.seg_q == nullptr || p.seg_k == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (quant && (p.ks == nullptr || p.vs == nullptr || p.rinv == nullptr ||
                (G != 1 && G != 2) || rope_start < 0 || rope_start >= D ||
                (D - rope_start) % 2 != 0))
    return (int)cudaErrorInvalidValue;
  // the plan must tile the rows and the cache exactly (decode_split_plan)
  if (pl.n_rb != (H / Hk * s + RB - 1) / RB || pl.n_split < 1 ||
      pl.n_dv != (Dv + DMAX - 1) / DMAX ||
      pl.span <= 0 || pl.span % BK != 0 || pl.span > MAX_TILES * BK ||
      (long long)pl.n_split * pl.span < cap ||
      (long long)(pl.n_split - 1) * pl.span >= (cap > 0 ? cap : 1) ||
      (pl.n_split > 1 && p.ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || s == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide)
    return is_bf16 ? run<bf16, true>(p, pl, B, s, H, Hk, cap, D, Dv, G, rope_start, window,
                                     use_nope, use_seg, quant, scale, st)
                   : run<float, true>(p, pl, B, s, H, Hk, cap, D, Dv, G, rope_start, window,
                                      use_nope, use_seg, quant, scale, st);
  if (is_bf16)
    return run<bf16, false>(p, pl, B, s, H, Hk, cap, D, Dv, G, rope_start, window,
                            use_nope, use_seg, quant, scale, st);
  return run<float, false>(p, pl, B, s, H, Hk, cap, D, Dv, G, rope_start, window,
                           use_nope, use_seg, quant, scale, st);
}

}  // namespace

// Every entry point returns the launch's cudaError_t (0 = launched).
// Pointers the flags switch off may be null. `is_bf16` is the type of q,
// q_nope and o. The split plan (n_rb row blocks of 64 rows, n_split kv
// ranges of `span` slots) comes from `decode_split_plan`; with n_split > 1
// `ws` holds n_split * B * s * H * (Dv + 2) fp32 partials, and a combine
// kernel runs after the main one on the same stream.
extern "C" int decode_attn_fwd(
    const void* q, const void* qn, const void* k, const void* kn,
    const void* v, const void* alibi, const void* pos_q, const void* pos_k,
    const void* sum_q, const void* seg_q, const void* seg_k, void* o,
    void* ws, int B, int s, int H, int Hk, int cap, int D, int Dv,
    int window, int use_nope, int use_seg, int is_bf16, int n_rb,
    int n_split, int span, float scale, void* stream) {
  const Ptrs p{q, qn, k, kn, v, nullptr, nullptr, nullptr, alibi,
               pos_q, pos_k, sum_q, seg_q, seg_k, o, ws};
  return dispatch(p, Plan{n_rb, n_split, span, 1}, B, s, H, Hk, cap, D, Dv, 1,
                  0, window, use_nope, use_seg, 0, is_bf16, scale, 0, stream);
}

// The int8 mode: kq/vq int8 codes (B, cap, Hk, D|Dv), ks (B, cap, Hk, G)
// and vs (B, cap, Hk) fp32 scales, rinv ((D - rope_start) / 2) fp32.
extern "C" int decode_attn_q8_fwd(
    const void* q, const void* qn, const void* kq, const void* vq,
    const void* ks, const void* vs, const void* rinv, const void* alibi,
    const void* pos_q, const void* pos_k, const void* sum_q,
    const void* seg_q, const void* seg_k, void* o, void* ws, int B, int s,
    int H, int Hk, int cap, int D, int Dv, int G, int rope_start,
    int window, int use_nope, int use_seg, int is_bf16, int n_rb,
    int n_split, int span, float scale, void* stream) {
  const Ptrs p{q, qn, kq, nullptr, vq, ks, vs, rinv, alibi,
               pos_q, pos_k, sum_q, seg_q, seg_k, o, ws};
  return dispatch(p, Plan{n_rb, n_split, span, 1}, B, s, H, Hk, cap, D, Dv, G,
                  rope_start, window, use_nope, use_seg, 1, is_bf16, scale, 0,
                  stream);
}

// The MLA mode of both: the same arguments, qk dims up to 288 and value
// dims up to 256, and the plan's n_dv value chunks of 128 columns.
extern "C" int decode_attn_mla_fwd(
    const void* q, const void* qn, const void* k, const void* kn,
    const void* v, const void* alibi, const void* pos_q, const void* pos_k,
    const void* sum_q, const void* seg_q, const void* seg_k, void* o,
    void* ws, int B, int s, int H, int Hk, int cap, int D, int Dv,
    int window, int use_nope, int use_seg, int is_bf16, int n_rb,
    int n_split, int span, int n_dv, float scale, void* stream) {
  const Ptrs p{q, qn, k, kn, v, nullptr, nullptr, nullptr, alibi,
               pos_q, pos_k, sum_q, seg_q, seg_k, o, ws};
  return dispatch(p, Plan{n_rb, n_split, span, n_dv}, B, s, H, Hk, cap, D,
                  Dv, 1, 0, window, use_nope, use_seg, 0, is_bf16, scale, 1,
                  stream);
}

extern "C" int decode_attn_mla_q8_fwd(
    const void* q, const void* qn, const void* kq, const void* vq,
    const void* ks, const void* vs, const void* rinv, const void* alibi,
    const void* pos_q, const void* pos_k, const void* sum_q,
    const void* seg_q, const void* seg_k, void* o, void* ws, int B, int s,
    int H, int Hk, int cap, int D, int Dv, int G, int rope_start,
    int window, int use_nope, int use_seg, int is_bf16, int n_rb,
    int n_split, int span, int n_dv, float scale, void* stream) {
  const Ptrs p{q, qn, kq, nullptr, vq, ks, vs, rinv, alibi,
               pos_q, pos_k, sum_q, seg_q, seg_k, o, ws};
  return dispatch(p, Plan{n_rb, n_split, span, n_dv}, B, s, H, Hk, cap, D,
                  Dv, G, rope_start, window, use_nope, use_seg, 1, is_bf16,
                  scale, 1, stream);
}
