// Decode/burst attention into the KV cache for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attn/decode_attn.py, `_kernel`
// (launched by `decode_attention_bshd`), the Pallas TPU kernel, in both
// its modes: bf16/fp32 KV (entry point `decode_attn_fwd`) and int8 KV
// (`decode_attn_q8_fwd`, the same kernel template with QUANT set), at
// head dims up to 128 (GQA), and at the absorbed-MLA geometry, which
// reads the latent cache in place (`decode_attn_mla_fwd`,
// `decode_attn_mla_q8_fwd`: `mla_kernel`; see the second half of this
// header).
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
// What bounds the GQA mode on this card: bytes. At the decode shape (B=8,
// cap=2048, s=64, H=32, Hk=8, D=128, a NoPE stream, window 1024) the
// attended K, K_nope and V are ~62 MB against ~8.6 GFLOP, ~140 FLOP/byte,
// under the ~295 FLOP/byte ridge. The design:
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
// * Only tiles that matter. A prologue (`prologue`, shared by both
//   kernels) lists the 32-slot tiles of the kv range that hold a filled
//   position some row may attend (from the least query position minus the
//   window to the greatest); the loop walks that list only. Within a tile,
//   slots no row may attend are zero-filled without a read.
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
// The absorbed-MLA mode (`mla_kernel`). `repro/serve/engine.py::
// _mla_decode_layer` calls the reference kernel as MQA (Hk = 1, Hq =
// n_heads) with q = [q_abs | q_pe] (Dqk = r + dr: kv_lora_rank + rope
// dims, 288 for minicpm3-4b) against the latent cache: K = [ckv |
// kpe_rope], K_nope = [ckv | kpe], V = ckv (Dv = r, 256), and in int8 two
// scale groups split at r. Here the kernel takes the cache's own tensors
// (ckv (B, cap, r), kpe_rope and kpe (B, cap, dr); in int8 the codes of
// ckv and kpe with one fp32 scale each per slot) and no copy is made.
//
// What bounds the MLA mode: operations. At the MLA decode shape (B=8,
// cap=2048, s=64, 40 heads on one latent key, window 1024) 2,560 query
// rows of a batch row share each latent key: ~23 GFLOP against ~37 MB,
// ~620 FLOP a byte, twice the ridge. So the design spends its effort on
// issuing no product twice, on Hopper's warpgroup products, and on two
// CTAs per SM:
//
// * Scores once per (row, key). A CTA (one warpgroup: 4 warps, 64 rows)
//   owns a block of rows over one cache range and all r value columns:
//   its 64 x 256 fp32 accumulator is 128 registers a thread (`acc`), and
//   Q.K^T is computed once for it. There is no grid axis over value
//   columns (PR 23's first version had two chunks of 128, each
//   recomputing Q.K^T, 1.53x the needed products).
// * wgmma (bf16 and int8 queries). Per 32-slot tile: S = Q.K^T as
//   m64n32k16, Q and K from shared memory (2 rope k-steps, 2 more for the
//   unroped keys where the CTA holds a [SUM] row, 16 latent ones), all
//   issued before one wait; then the softmax in registers (its S layout
//   is mma.sync's, per warp), P as hi + lo bf16 terms in registers, and
//   O += P.V as m64n256k16, P from registers and V from shared memory
//   read transposed. Every k-step is unrolled: a wgmma chain that crosses
//   a loop's back edge is serialized by ptxas.
// * One latent plane per stage. Planes hold 8 x 8 core matrices (128
//   contiguous bytes, the layout wgmma reads without a swizzle): a
//   stage's latent plane holds the tile's 32 latent rows once; Q.K^T
//   reads it K-major as K's first r columns, P.V MN-major as V (the same
//   core matrices, the descriptor's strides swapped). The rope span has
//   planes of its own: the roped keys (for ordinary rows) and, only in a
//   CTA that holds a [SUM] row, the unroped ones. [SUM] rows' latent
//   product reads the same plane (their Q rows hold q_nope), so only the
//   rope k-steps differ by row kind. A bf16 stage is 20 KB (with the
//   unroped span), the Q planes 36 KB: 103 KB a CTA, two CTAs per SM in
//   bf16 and int8 (`decode_attn_mla_ctas_per_sm` asks the runtime).
// * int8 with the scales factored out. The latent codes become bf16 (one
//   term, exact) in the latent plane and serve Q.K^T and P.V; score
//   columns are sl * ckv_scale + sx * kpe_scale, sl the latent product and
//   sx the rope span's, each in its own accumulator; ckv_scale, which is
//   V's scale too, folds into P. Only the rope span is rotated (in fp32,
//   sincosf as above) and split, into two terms; [SUM] rows read its
//   codes unrotated, one exact term. The conversion pass widens 16 codes
//   a thread at a time from a cp.async stage whose 16-byte chunks are
//   XOR-swizzled by slot, so eight slots' reads meet no bank twice.
// * Rows, tiles, pipeline and softmax as in the GQA mode: the prologue's
//   product order and live-tile list, three cp.async stages issued two
//   tiles ahead (bf16 straight into the planes; int8 codes and scales into
//   raw stages and one plane stage), base-2 softmax; the running max moves
//   only when a tile's passes it by more than 8, so most tiles rescale no
//   accumulator.
// * The plan (`mla_split_plan`): row blocks, times the fewest cache
//   ranges that fill one wave of resident CTAs (SMs x 2): none at s=64
//   (320 CTAs), 2 at s=32, 4 at s=16. More ranges, to fill the second
//   wave at s=64, measured slower (each pays a CTA's prologue, Q staging
//   and epilogue, and the partials' round trip).
// * fp32 (the gates' instantiation; its speed is not measured) keeps
//   mma.sync per warp on the same planes: three-term planes (codes: one
//   term), read by ldmatrix; one stage converted from memory (int8: three
//   raw stages); no Q plane (each A fragment is split from the query rows
//   in memory at every k-step); P.V in groups of one 16-column pair.
// Tried on the card and dropped (PERF.md, PR 24): a first mma.sync version
// of this design (1.27x slower than wgmma); tile kt + 1's Q.K^T beside
// tile kt's softmax (two sets of score registers: no faster, and int8
// spilled); descriptors held across the loop (spills).
//
// Two geometries (`MlaGeo`, the kernel's first template parameter): the
// narrow one above (a latent of up to 256, a rope span of up to 32:
// minicpm3-4b's 288 / 256), and a wide one for deepseek-v2's 576 / 512 (a
// latent of up to 512, a rope span of up to 64; `repro/serve/engine.py:
// 354,383` calls the reference kernel at Dqk 576, Dv 512, int8 scale
// groups split at 512). A 64 x 512 fp32 accumulator would be 256
// registers a thread, so a CTA keeps the narrow one's 256 value columns
// (`VW`), and the grid's fastest axis splits the latent's value columns
// over `n_vc` CTAs (two), side by side so that they read the same latent
// tiles from L2. Each computes its row block's scores over the whole
// latent and rope span itself: 1.53x the needed products at 576 / 512,
// and no exchange of P between CTAs or warpgroups (the design that
// avoids the repeat, two warpgroups sharing P through shared memory, is
// work for a redesign). Its Q planes (64 x 576) and three plane stages
// of 32 slots (latent 512 wide) take ~200 KB: one CTA per SM.

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
constexpr int DMAX = 128;          // the GQA mode's largest head dim
constexpr int NT_S = BK / 8;       // score n-tiles per warp and tile
constexpr int KK = BK / 16;        // P.V k-steps per tile
constexpr int MAX_TILES = 256;     // tiles of one kv range (the split plans)
constexpr int NT_V = DMAX / 8;     // value n-tiles
constexpr int LDK = DMAX + 8;      // the GQA planes' row stride: conflict-free
// int8 mode, one copy stage: K codes (BK x DMAX bytes), V codes (BK x
// DMAX), K scales (BK x 2) and V scales (BK), as cp.async leaves them
constexpr int RAW_BYTES = BK * 2 * DMAX + 3 * BK * (int)sizeof(float);
// The MLA mode's geometries (`mla_kernel`'s instances): a latent (value)
// width up to LAT and a rope span up to ROPE; a CTA owns VW value columns,
// so a latent wider than VW takes NVC CTAs per row block (the grid's
// value-column chunks), each computing the block's scores itself.
template <int LAT_, int ROPE_>
struct MlaGeo {
  static constexpr int LAT = LAT_;
  static constexpr int ROPE = ROPE_;
  static constexpr int VW = 256;
  static constexpr int NVC = (LAT + VW - 1) / VW;
  // Its planes hold 8 x 8 core matrices (8 rows of 16 bytes, 128 bytes
  // contiguous: what wgmma reads without a swizzle, and conflict-free for
  // ldmatrix), CL (CR) of them along a latent (rope span) row group
  static constexpr int CL = LAT / 8;
  static constexpr int CR = ROPE / 8;
  static constexpr int NT_L = VW / 8;      // value n-tiles of a CTA
  // int8, one copy stage: latent codes (BK x LAT bytes), rope codes (BK x
  // ROPE), the two scales (BK each)
  static constexpr int RAW = BK * (LAT + ROPE) + 2 * BK * (int)sizeof(float);
};
using MlaNarrow = MlaGeo<256, 32>;   // minicpm3-4b (288 / 256)
using MlaWide = MlaGeo<512, 64>;     // deepseek-v2 (576 / 512)
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// a compile-time count passed to a generic lambda
template <int N>
struct IC {
  static constexpr int value = N;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }
// two neighbouring values (one store where `two` and `vec`: an even row)
__device__ __forceinline__ void store2(float* p, float x, float y, bool two, bool vec) {
  if (two && vec) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  } else {
    p[0] = x;
    if (two) p[1] = y;
  }
}
__device__ __forceinline__ void store2(bf16* p, float x, float y, bool two, bool vec) {
  if (two && vec) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  } else {
    p[0] = __float2bfloat16(x);
    if (two) p[1] = __float2bfloat16(y);
  }
}

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

// The MLA mode's terms: query, latent plane (int8 codes are exact), roped
// and unroped rope span, P; copy and plane stages; 16-column pairs of V
// per fragment group in P.V
template <typename T, bool QUANT>
struct MlaMode {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int NQ = F32 ? 3 : 1;
  static constexpr int NL = (F32 && !QUANT) ? 3 : 1;
  static constexpr int NR = F32 ? 3 : (QUANT ? 2 : 1);
  static constexpr int NN = (F32 && !QUANT) ? 3 : 1;
  static constexpr int NP = F32 ? 3 : 2;
  static constexpr int S = (F32 && !QUANT) ? 1 : 3;       // copy stages
  static constexpr int PS = (!F32 && !QUANT) ? 3 : 1;      // plane stages
  static constexpr bool QPLANE = !F32;
  static constexpr int NG = F32 ? 1 : 4;
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
template <int N, typename T>
__device__ __forceinline__ void a_frag_rows(const T* const (&r)[2], int c,
                                            int n, uint32_t (&f)[N][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const T* p = r[i & 1];
    const int cc = c + (i >> 1) * 8;
    float x0 = (p != nullptr && cc < n) ? to_f(p[cc]) : 0.f;
    float x1 = (p != nullptr && cc + 1 < n) ? to_f(p[cc + 1]) : 0.f;
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

// 8 values as N bf16 terms at p, p + stride, ... (one 16-byte store a
// term when N is 1; p 16-byte aligned)
template <int N>
__device__ __forceinline__ void store8(bf16* p, int stride, const float (&x)[8]) {
  if (N == 1) {
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
      w[e] = *reinterpret_cast<const uint32_t*>(&h2);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) split_store<N>(x[e], p + e, stride);
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

// element (r, c) of a plane of core matrices, `ldc` of them a row group
__device__ __forceinline__ int cm(int r, int c, int ldc) {
  return ((r >> 3) * ldc + (c >> 3)) * 64 + (r & 7) * 8 + (c & 7);
}

// wgmma's shared-memory matrix descriptor, no swizzle: `lbo` the bytes
// between core matrices along K, `sbo` along M/N (for a K-major operand;
// an MN-major one, read transposed, takes the same two strides)
__device__ __forceinline__ uint64_t gdesc(const bf16* p, int lbo, int sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
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

// S += Q.K^T for 64 rows x 32 slots x 16 dims: A and B (K-major) from
// shared memory
__device__ __forceinline__ void wg_qk(float (&d)[4][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(1));
}

// O += P.V for 64 rows x 256 columns x 16 slots: P (A) from registers, V
// (B, MN-major: read transposed) from shared memory
__device__ __forceinline__ void wg_pv(float (&d)[32][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
      "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
      "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
      "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
      "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
      "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
      "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
      "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
      "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
      "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
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
  int n_rb, n_split, span, direct;
  float scale;
};

// The MLA mode's operands: the latent cache's own tensors
template <typename T>
struct MlaArgs {
  const T *q, *qn, *ckv, *kpr, *kpe;   // latent (B, cap, R); roped and raw
                                       // rope span (B, cap, DR)
  const signed char *ckq, *kpq;        // int8: latent and rope codes
  const float *cks, *kps, *rinv;       // int8: scales (B, cap), RoPE freqs
  const float* alibi;
  const int *pos_q, *pos_k, *seg_q, *seg_k;
  const unsigned char* sum_q;
  T* o;
  float *ws_acc, *ws_m, *ws_l;
  int B, s, H, cap, R, DR, window, use_seg;
  int n_rb, n_split, span, n_vc, direct;
  float scale;
};

// The row tables the prologue leaves in shared memory: per block row its
// position, [SUM] flag, segment, slope, query and head; the least and
// greatest query position; the ordinary queries' count; the live tiles,
// then their count, and per tile its least and greatest filled position;
// sized at launch: the row's queries (ordinary first), their positions and
// segments (s each), and the kv head's slopes (n_rep)
struct Tabs {
  int *pos_r, *sum_r, *seg_r;
  float* alibi_r;
  int *pq_span, *rq, *rh, *nps, *tl, *tlo, *thi, *qlist, *qpos, *qseg;
  float* qal;
};
constexpr int TAB_INTS = 6 * RB + 4 + 3 * MAX_TILES + 1;   // + 3 s + n_rep

__device__ __forceinline__ Tabs carve(int* p, int s) {
  Tabs t;
  t.pos_r = p;
  t.sum_r = p + RB;
  t.seg_r = p + 2 * RB;
  t.alibi_r = reinterpret_cast<float*>(p + 3 * RB);
  t.pq_span = p + 4 * RB;
  t.rq = t.pq_span + 2;
  t.rh = t.rq + RB;
  t.nps = t.rh + RB;
  t.tl = t.nps + 2;
  t.tlo = t.tl + MAX_TILES + 1;
  t.thi = t.tlo + MAX_TILES;
  t.qlist = t.thi + MAX_TILES;
  t.qpos = t.qlist + s;
  t.qseg = t.qpos + s;
  t.qal = reinterpret_cast<float*>(t.qseg + s);
  return t;
}

struct Live {
  int any_sum, any_plain, pq_min, pq_max, n_live;
};

// The prologue both kernels share. It makes two rounds of memory loads.
// First, with no dependency: each warp's share of the positions (and
// segments) of the kv range's first 16 * WARPS tiles, kept in registers
// (pp, ps) for the first ring slots and reduced to each tile's least and
// greatest filled position; warp 0 the queries' flags, positions and
// segments; warp 1 the slopes. Then the row tables; `mid` runs once they
// and the query span are known (the caller's second round of loads); then
// warp 0 lists the live tiles.
template <bool NOPE, typename A, typename Mid>
__device__ __forceinline__ Live prologue(const A& a, const Tabs& tb, int b, int hk,
                                         int n_rep, int kv0, int kv1, int n_t,
                                         int r0, int nr, int (&pp)[16], int (&ps)[16],
                                         Mid&& mid) {
  const int s = a.s, cap = a.cap;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
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
    for (int tb0 = 0; tb0 < s; tb0 += 64) {
      int f[2], qp[2], qs[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = tb0 + 32 * u + lane;
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
        const int t = tb0 + 32 * u + lane;
        if (t < s) {
          tb.qpos[t] = qp[u];
          tb.qseg[t] = qs[u];
        }
        const unsigned pb = __ballot_sync(FULL, t < s && !f[u]);
        const unsigned sb = __ballot_sync(FULL, t < s && f[u]);
        const unsigned below = (1u << lane) - 1u;
        if (t < s && !f[u]) tb.qlist[n_plain + __popc(pb & below)] = t;
        if (t < s && f[u]) tb.qlist[s - 1 - n_sum - __popc(sb & below)] = t;
        n_plain += __popc(pb);
        n_sum += __popc(sb);
      }
    }
    if (lane == 0) {
      tb.nps[0] = n_plain;
      tb.pq_span[0] = INT_MAX;
      tb.pq_span[1] = INT_MIN;
    }
  } else if (warp == 1) {
    for (int i = lane; i < n_rep; i += 32) tb.qal[i] = a.alibi[hk * n_rep + i];
  }
  // per tile: the least and greatest filled position (INT_MAX, -1: none);
  // tiles past the first 16 * WARPS in further rounds
  for (int tb0 = 0; tb0 < n_t; tb0 += 16 * WARPS) {
    int p[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int t = tb0 + warp + WARPS * i, slot = kv0 + t * BK + lane;
      p[i] = tb0 == 0 ? pp[i]
                      : (t < n_t && slot < kv1) ? a.pos_k[(size_t)b * cap + slot] : -1;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int t = tb0 + warp + WARPS * i;
      const int lo = __reduce_min_sync(FULL, p[i] >= 0 ? p[i] : INT_MAX);
      const int hi = __reduce_max_sync(FULL, p[i]);
      if (lane == 0 && t < n_t) {
        tb.tlo[t] = lo;
        tb.thi[t] = hi;
      }
    }
  }
  __syncthreads();
  {
    const int n_plain = tb.nps[0], n_sq = s - n_plain;
    for (int r = tid; r < RB; r += THREADS) {
      int t = 0, h = 0, sm = 0;
      if (r < nr) {
        const int k = r0 + r;
        if (k < n_rep * n_plain) {
          h = k / n_plain;
          t = tb.qlist[k - h * n_plain];
        } else {
          const int k2 = k - n_rep * n_plain;
          h = k2 / n_sq;
          t = tb.qlist[n_plain + k2 - h * n_sq];
          sm = 1;
        }
        atomicMin(tb.pq_span, tb.qpos[t]);   // integer: the result is order-free
        atomicMax(tb.pq_span + 1, tb.qpos[t]);
      }
      tb.rq[r] = t;
      tb.rh[r] = h;
      tb.sum_r[r] = sm;
      tb.pos_r[r] = r < nr ? tb.qpos[t] : 0;
      tb.seg_r[r] = r < nr ? tb.qseg[t] : 0;
      tb.alibi_r[r] = r < nr ? tb.qal[h] : 0.f;
    }
  }
  Live lv;
  lv.any_sum = NOPE ? __syncthreads_or(tid < nr && tb.sum_r[tid]) : 0;
  lv.any_plain = __syncthreads_or(tid < nr && !tb.sum_r[tid]);
  lv.pq_min = tb.pq_span[0];
  lv.pq_max = tb.pq_span[1];
  mid();
  // The tiles of this kv range that hold a filled position in
  // [pq_min - window, pq_max] (some row may attend them), listed in order
  // by warp 0. The loops walk this list only: "tile kt" is the kt-th
  // listed tile, from slot t0(kt) on.
  if (warp == 0) {
    int base = 0;
    for (int t0 = 0; t0 < n_t; t0 += 32) {
      const int tt = t0 + lane;
      const bool on = tt < n_t && tb.thi[tt] >= 0 && tb.tlo[tt] <= lv.pq_max &&
                      (a.window <= 0 || lv.pq_min - tb.thi[tt] <= a.window);
      const unsigned bal = __ballot_sync(FULL, on);
      if (on) tb.tl[base + __popc(bal & ((1u << lane) - 1u))] = tt;
      base += __popc(bal);
    }
    if (lane == 0) tb.tl[MAX_TILES] = base;
  }
  __syncthreads();
  lv.n_live = tb.tl[MAX_TILES];
  return lv;
}

template <typename T, bool NOPE, bool QUANT>
struct Smem {
  using M = Mode<T, QUANT>;
  static constexpr int NKN = NOPE ? M::NK : 0;
  static constexpr size_t Q_ELEMS = (size_t)M::NQ * RB * LDK;
  static constexpr size_t STAGE_ELEMS =
      (size_t)(M::NK + NKN) * BK * LDK + (size_t)M::NV * BK * LDK;
  static constexpr size_t RAW = QUANT ? (size_t)M::STAGES * RAW_BYTES : 0;
  static constexpr size_t BYTES =
      (Q_ELEMS + M::PSTAGES * STAGE_ELEMS) * sizeof(bf16) + RAW +
      (4 * M::STAGES * BK + BK + DMAX / 2 + TAB_INTS) * sizeof(int);
};

template <typename T, bool NOPE, bool QUANT>
__global__ void __launch_bounds__(THREADS, 2)
decode_attn_kernel(const Args<T> a) {
  using M = Mode<T, QUANT>;
  using L = Smem<T, NOPE, QUANT>;
  constexpr int NQ = M::NQ, NK = M::NK, NP = M::NP, NV = M::NV;
  constexpr int S = M::STAGES, PS = M::PSTAGES, MS = 2 * S;
  constexpr int TQK = NQ > NK ? NQ : NK;     // term pairs i + j < TQK
  constexpr int TPV = NP > NV ? NP : NV;
  constexpr int LDV = LDK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_p = reinterpret_cast<bf16*>(smem_raw);
  bf16* st_p = q_p + L::Q_ELEMS;
  unsigned char* raw_p = reinterpret_cast<unsigned char*>(st_p + PS * L::STAGE_ELEMS);
  int* pos_ks = reinterpret_cast<int*>(raw_p + L::RAW);   // MS tiles' slots
  int* seg_ks = pos_ks + MS * BK;
  float* vs_s = reinterpret_cast<float*>(seg_ks + MS * BK);
  float* rinv_s = vs_s + BK;                              // int8: RoPE freqs
  const Tabs tb = carve(reinterpret_cast<int*>(rinv_s + DMAX / 2), a.s);
  auto k_pl = [&](int st, int t) { return st_p + st * L::STAGE_ELEMS + t * BK * LDK; };
  auto kn_pl = [&](int st, int t) { return k_pl(st, NK + t); };
  auto v_pl = [&](int st, int t) { return k_pl(st, NK + L::NKN) + t * BK * LDV; };
  auto raw_kq = [&](int st) {
    return reinterpret_cast<signed char*>(raw_p + st * RAW_BYTES);
  };
  auto raw_vq = [&](int st) { return raw_kq(st) + BK * DMAX; };
  auto raw_ks = [&](int st) {    // [BK][2]
    return reinterpret_cast<float*>(raw_vq(st) + BK * DMAX);
  };
  auto raw_vs = [&](int st) { return raw_ks(st) + 2 * BK; };

  // blockIdx.x: row block, then kv range
  const int rb = blockIdx.x % a.n_rb;
  const int split = blockIdx.x / a.n_rb;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int n_rep = a.H / a.Hk, s = a.s, D = a.D, cap = a.cap;
  const int Dv = a.Dv;
  const int r0 = rb * RB, nr = min(RB, n_rep * s - r0);
  const int kv0 = split * a.span, kv1 = min(cap, kv0 + a.span);
  const int n_t = kv1 > kv0 ? (kv1 - kv0 + BK - 1) / BK : 0;
  const int DP = (D + 15) & ~15, DVP = (Dv + 15) & ~15;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, cq = lane & 3;
  const bool direct = S > 1 && a.direct;           // copies by cp.async
  const bool planes_direct = direct && PS > 1;       // straight into planes

  // Q planes ([SUM] rows hold q_nope), zero past D and past the last row:
  // thread tid takes 8 values (chunk tid % 16) of rows tid / 16 + 8 i,
  // loaded into registers in the prologue's second round and written to
  // the Q planes once the first tiles' copies are on their way.
  const int qch = tid & 15, qr = tid >> 4;
  // block row r's query vector (q_nope for a [SUM] row)
  auto q_row = [&](int r) {
    return ((NOPE && tb.sum_r[r]) ? a.qn : a.q) +
           (((size_t)b * s + tb.rq[r]) * a.H + hk * n_rep + tb.rh[r]) * D;
  };
  float qx[RB / 8][8];
  int pp[16], ps[16];
  const Live lv = prologue<NOPE>(a, tb, b, hk, n_rep, kv0, kv1, n_t, r0, nr, pp, ps, [&] {
    if (QUANT)
      for (int i = tid; i < (D - a.rope_start) / 2; i += THREADS) rinv_s[i] = a.rinv[i];
    if (planes_direct && (D % 16 || Dv % 16)) {   // pads cp.async never writes
      for (int i = tid; i < PS * (int)L::STAGE_ELEMS; i += THREADS)
        st_p[i] = __ushort_as_bfloat16((unsigned short)0);
    }
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
  });
  const int any_sum = lv.any_sum, any_plain = lv.any_plain;
  const int pq_min = lv.pq_min, pq_max = lv.pq_max, n_live = lv.n_live;
  auto live = [&](int pk) {
    return pk >= 0 && pk <= pq_max && (a.window <= 0 || pq_min - pk <= a.window);
  };
  auto t0 = [&](int kt) { return kv0 + tb.tl[kt] * BK; };

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
  // are zero-filled without a read.
  // Thread tid copies 16-byte chunk tid % 16 of slots tid / 16 + 8 i.
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
  auto issue = [&](int kt) {
    const int st = kt % S, k0 = t0(kt);
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
        const signed char* vq = direct ? raw_vq(cs) + c * Dv : a.vq + sh * a.Dv;
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
          split_store<NV>(d < Dv ? to_f(a.v[sh * a.Dv + d]) : 0.f, vr + d, BK * LDV);
      }
    }
  };

  // this thread's two rows (g, g + 8 of its warp's 16)
  const int wr0 = warp * 16;
  const bool w_live = wr0 < nr;
  // which products this warp's rows need: Q.K^T for ordinary rows,
  // Qn.Kn^T for [SUM] rows (both only where the sort leaves a mixed warp)
  const int wrow = min(wr0 + (lane & 15), RB - 1);
  const bool w_sum = NOPE && any_sum &&
                     __any_sync(FULL, wr0 + (lane & 15) < nr && tb.sum_r[wrow]);
  const bool w_plain = __any_sync(FULL, wr0 + (lane & 15) < nr && !tb.sum_r[wrow]);
  int pq[2], sg[2];
  bool rin[2], rsum[2];
  float al[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr0 + g + 8 * h;
    rin[h] = r < nr;
    pq[h] = tb.pos_r[r];
    sg[h] = tb.seg_r[r];
    rsum[h] = NOPE && tb.sum_r[r] != 0;
    al[h] = tb.alibi_r[r];
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
#pragma unroll
      for (int t = 0; t < NQ; ++t) ldsm_x4(fq[t], qrow + t * RB * LDK + kd * 16);
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
      const int tt = tb.tl[kt];
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
  if (qch * 8 < DP) {
#pragma unroll
    for (int i = 0; i < RB / 8; ++i) {
      bf16* dst = q_p + (qr + 8 * i) * LDK + qch * 8;
      if (NQ == 1) {
        store8<1>(dst, RB * LDK, qx[i]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) split_store<NQ>(qx[i][e], dst + e, RB * LDK);
      }
    }
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
    const int hh = hk * n_rep + tb.rh[r], t = tb.rq[r];
    const size_t row = ((size_t)b * s + t) * a.H + hh;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
#pragma unroll
    for (int j = 0; j < NT_V; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * cq + e;
        if (col >= Dv) continue;
        if (a.n_split == 1)
          store(a.o + row * a.Dv + col, acc[j][2 * h + e] * inv);
        else
          a.ws_acc[((size_t)split * rows + row) * a.Dv + col] = acc[j][2 * h + e];
      }
    if (a.n_split > 1 && cq == 0) {
      a.ws_m[(size_t)split * rows + row] = m[h];
      a.ws_l[(size_t)split * rows + row] = l[h];
    }
  }
}

// The MLA mode's shared memory: the Q planes (bf16 only: the latent span,
// 64 x LAT, and the rope span, 64 x ROPE), PS plane stages (latent 32 x
// LAT in NL terms, roped rope span 32 x ROPE in NR terms, unroped one in
// NN terms when NOPE), int8 copy stages, then the tile rings, the tile's
// two scales, the RoPE freqs and the row tables
template <typename G, typename T, bool NOPE, bool QUANT>
struct MlaSmem {
  using M = MlaMode<T, QUANT>;
  static constexpr size_t Q_ELEMS = M::QPLANE ? (size_t)RB * (G::LAT + G::ROPE) : 0;
  static constexpr size_t LAT = (size_t)M::NL * BK * G::LAT;
  static constexpr size_t ROPE = (size_t)M::NR * BK * G::ROPE;
  static constexpr size_t STAGE_ELEMS = LAT + ROPE + (NOPE ? (size_t)M::NN * BK * G::ROPE : 0);
  static constexpr size_t RAW = QUANT ? (size_t)M::S * G::RAW : 0;
  static constexpr size_t BYTES =
      (Q_ELEMS + M::PS * STAGE_ELEMS) * sizeof(bf16) + RAW +
      (4 * M::S * BK + 2 * BK + G::ROPE / 2 + TAB_INTS) * sizeof(int);
};

template <typename G, typename T, bool NOPE, bool QUANT>
__global__ void __launch_bounds__(THREADS, 2)
mla_kernel(const MlaArgs<T> a) {
  using M = MlaMode<T, QUANT>;
  using L = MlaSmem<G, T, NOPE, QUANT>;
  // this instance's geometry
  constexpr int MLA_R = G::LAT, MLA_DR = G::ROPE, MLA_RAW = G::RAW;
  constexpr int CL = G::CL, CR = G::CR, NT_L = G::NT_L, VW = G::VW;
  constexpr int NQ = M::NQ, NL = M::NL, NR = M::NR, NN = M::NN, NP = M::NP;
  constexpr int S = M::S, PS = M::PS, MS = 2 * S, NG = M::NG;
  constexpr int TL = NQ > NL ? NQ : NL;      // term pairs i + j < T*
  constexpr int TR = NQ > NR ? NQ : NR;
  constexpr int TN = NQ > NN ? NQ : NN;
  constexpr int TPV = NP > NL ? NP : NL;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_lat = reinterpret_cast<bf16*>(smem_raw);
  bf16* q_rope = q_lat + (M::QPLANE ? RB * MLA_R : 0);
  bf16* st_p = q_lat + L::Q_ELEMS;
  unsigned char* raw_p = reinterpret_cast<unsigned char*>(st_p + PS * L::STAGE_ELEMS);
  int* pos_ks = reinterpret_cast<int*>(raw_p + L::RAW);   // MS tiles' slots
  int* seg_ks = pos_ks + MS * BK;
  float* cs_s = reinterpret_cast<float*>(seg_ks + MS * BK);   // int8: the tile's
  float* ps_s = cs_s + BK;                                    // ckv, kpe scales
  float* rinv_s = ps_s + BK;                                  // int8: RoPE freqs
  const Tabs tb = carve(reinterpret_cast<int*>(rinv_s + MLA_DR / 2), a.s);
  auto lat_pl = [&](int st, int t) { return st_p + st * L::STAGE_ELEMS + t * BK * MLA_R; };
  auto rope_pl = [&](int st, int t) { return lat_pl(st, NL) + t * BK * MLA_DR; };
  auto nope_pl = [&](int st, int t) { return rope_pl(st, NR) + t * BK * MLA_DR; };
  // int8 copy stage: slot c's latent codes in 16-byte chunks q at
  // q ^ (c % 8) (the conversion pass reads eight slots' chunk q at once),
  // then the rope codes, then the two scales
  auto raw_lat = [&](int st) {
    return reinterpret_cast<signed char*>(raw_p + st * MLA_RAW);
  };
  auto raw_rope = [&](int st) { return raw_lat(st) + BK * MLA_R; };
  auto raw_cs = [&](int st) { return reinterpret_cast<float*>(raw_rope(st) + BK * MLA_DR); };
  auto raw_ps = [&](int st) { return raw_cs(st) + BK; };

  // blockIdx.x: value-column chunk (a geometry wider than VW only), then
  // row block, then cache range; blockIdx.y: batch row
  const int vch = G::NVC > 1 ? (int)blockIdx.x % a.n_vc : 0;
  const int bx = G::NVC > 1 ? (int)blockIdx.x / a.n_vc : (int)blockIdx.x;
  const int rb = bx % a.n_rb, split = bx / a.n_rb, b = blockIdx.y;
  const int n_rep = a.H, s = a.s, cap = a.cap, R = a.R, DR = a.DR, D = R + DR;
  // this CTA's value columns [vc0, vc0 + RV) of the R
  const int vc0 = vch * VW, RV = min(VW, R - vc0), RVP = (RV + 15) & ~15;
  const int r0 = rb * RB, nr = min(RB, n_rep * s - r0);
  const int kv0 = split * a.span, kv1 = min(cap, kv0 + a.span);
  const int n_t = kv1 > kv0 ? (kv1 - kv0 + BK - 1) / BK : 0;
  const int RP = (R + 15) & ~15, DRP = (DR + 15) & ~15;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, cq = lane & 3;
  // thread tid's slot in the copies and conversions, a row of a core
  // matrix (eight lanes fill one), and its 16-byte column offset
  const int cslot = 8 * warp + (lane & 7), cch = lane >> 3;
  const bool direct = S > 1 && a.direct;           // copies by cp.async
  const bool planes_direct = direct && PS > 1;       // straight into planes

  // block row r's query vector (q_nope for a [SUM] row), D = R + DR wide
  auto q_row = [&](int r) {
    return ((NOPE && tb.sum_r[r]) ? a.qn : a.q) +
           (((size_t)b * s + tb.rq[r]) * a.H + tb.rh[r]) * D;
  };
  int pp[16], ps[16];
  const Live lv = prologue<NOPE>(a, tb, b, 0, n_rep, kv0, kv1, n_t, r0, nr, pp, ps, [&] {
    if (QUANT)
      for (int i = tid; i < DR / 2; i += THREADS) rinv_s[i] = a.rinv[i];
    // columns no copy or conversion writes (past R, past DR), which the
    // products read: zero, as is every plane a CTA's rows never fill
    for (int i = tid; i < PS * (int)L::STAGE_ELEMS / 8; i += THREADS)
      reinterpret_cast<uint4*>(st_p)[i] = make_uint4(0u, 0u, 0u, 0u);
  });
  const int any_sum = lv.any_sum, any_plain = lv.any_plain;
  const int pq_min = lv.pq_min, pq_max = lv.pq_max;
  // The prologue lists the tiles that meet the hull of the rows' windows,
  // [pq_min - window, pq_max]; a burst's padded queries (position 0) widen
  // it to the whole cache. Warp 0 keeps, in order, the listed tiles that
  // some row's own window meets.
  if (warp == 0) {
    int base = 0;
    for (int k0 = 0; k0 < lv.n_live; k0 += 32) {
      const int k = k0 + lane, tt = k < lv.n_live ? tb.tl[k] : 0;
      bool on = false;
      if (k < lv.n_live)
        for (int r = 0; r < nr && !on; ++r) {
          const int p = tb.pos_r[r];
          on = tb.tlo[tt] <= p && (a.window <= 0 || p - tb.thi[tt] <= a.window);
        }
      const unsigned bal = __ballot_sync(FULL, on);
      if (on) tb.tl[base + __popc(bal & ((1u << lane) - 1u))] = tt;
      base += __popc(bal);
    }
    if (lane == 0) tb.tl[MAX_TILES] = base;
  }
  __syncthreads();
  const int n_live = tb.tl[MAX_TILES];
  auto live = [&](int pk) {
    return pk >= 0 && pk <= pq_max && (a.window <= 0 || pq_min - pk <= a.window);
  };
  auto t0 = [&](int kt) { return kv0 + tb.tl[kt] * BK; };
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
  auto pk_at = [&](int j, int c) {
    const int p = pos_ks[(j % MS) * BK + c];
    return (t0(j) + c < kv1 && live(p)) ? p : -1;
  };
  // cp.async of tile kt; slots no row attends are zero-filled without a
  // read. bf16: slot `cslot`'s latent row, 16-byte chunks cch + 4 i, into
  // the latent plane of stage kt % S, its rope spans (chunk cch) into
  // theirs, kpe_rope only for ordinary rows and kpe only for [SUM] rows.
  // int8: latent codes (chunk tid % LC of slots tid / LC + SR i, LC the
  // slot's 16-code chunks, SR the slots a round covers), rope codes (RC
  // chunks a slot, thread tid: chunk tid % RC of slot tid / RC) and the
  // two scales (chunks 0 and 1's threads) into copy stage kt % S.
  auto issue = [&](int kt) {
    const int st = kt % S, k0 = t0(kt);
    auto row_of = [&](int c, bool ok) { return (size_t)b * cap + (ok ? k0 + c : 0); };
    if constexpr (QUANT) {
      constexpr int LC = MLA_R / 16, SR = THREADS / LC, RC = MLA_DR / 16;
      const int ch = tid % LC, c0 = tid / LC;
      if (ch < R / 16) {
#pragma unroll
        for (int i = 0; i < BK / SR; ++i) {
          const int c = c0 + SR * i;
          const bool ok = pk_at(kt, c) >= 0;
          cp16(raw_lat(st) + c * MLA_R + (ch ^ (c & 7)) * 16,
               a.ckq + row_of(c, ok) * R + ch * 16, ok);
        }
      }
      if (tid < RC * BK) {
        const int c = tid / RC, rc = tid % RC;
        const bool ok = pk_at(kt, c) >= 0;
        if (rc < DR / 16)
          cp16(raw_rope(st) + c * MLA_DR + rc * 16, a.kpq + row_of(c, ok) * DR + rc * 16, ok);
        const size_t sl = row_of(c, ok);
        if (rc == 0)
          cp4(raw_cs(st) + c, a.cks + sl, ok);
        else if (RC == 2 || rc == 1)
          cp4(raw_ps(st) + c, a.kps + sl, ok);
      }
    } else {
      const bf16* ckv = reinterpret_cast<const bf16*>(a.ckv);
      const bf16* kpr = reinterpret_cast<const bf16*>(a.kpr);
      const bf16* kpe = reinterpret_cast<const bf16*>(a.kpe);
      const int c = cslot;
      const bool ok = pk_at(kt, c) >= 0;
      const size_t row = row_of(c, ok);
#pragma unroll
      for (int i = 0; i < CL / 4; ++i) {
        const int ch = cch + 4 * i;
        if (ch < R / 8)
          cp16(lat_pl(st, 0) + cm(c, ch * 8, CL), ckv + row * R + ch * 8, ok);
      }
#pragma unroll
      for (int i = 0; i < (CR + 3) / 4; ++i) {
        const int ch = cch + 4 * i;
        if (ch < DR / 8) {
          if (any_plain)
            cp16(rope_pl(st, 0) + cm(c, ch * 8, CR), kpr + row * DR + ch * 8, ok);
          if (NOPE && any_sum)
            cp16(nope_pl(st, 0) + cm(c, ch * 8, CR), kpe + row * DR + ch * 8, ok);
        }
      }
    }
  };
  // The conversion pass (int8 from its copy stage; fp32, or rows not 16-
  // byte aligned, from memory), slot `cslot` a thread: the latent plane in
  // chunks of 16 codes (int8) or 8 values, the rope spans by element (bf16,
  // fp32) or by half pair (int8), and in int8 the tile's scales.
  auto convert = [&](int kt) {
    const int st = kt % PS, cs = kt % S, k0 = t0(kt);
    const int* pks = pos_ks + (kt % MS) * BK;
    const bool kn_on = NOPE && any_sum;
    const int c = cslot;
    const bool on = pks[c] >= 0;
    const size_t row = (size_t)b * cap + k0 + c;
    if constexpr (QUANT) {
#pragma unroll
      for (int i = 0; i < MLA_R / 64; ++i) {
        const int q = cch + 4 * i;              // 16-code chunk
        float x[16];
        if (!on || 16 * q >= R) {
#pragma unroll
          for (int e = 0; e < 16; ++e) x[e] = 0.f;
        } else if (direct) {
          const uint4 u = *reinterpret_cast<const uint4*>(
              raw_lat(cs) + c * MLA_R + (q ^ (c & 7)) * 16);
          const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int e = 0; e < 16; ++e) x[e] = (float)(signed char)(w[e >> 2] >> (8 * (e & 3)));
        } else {
          const signed char* p = a.ckq + row * R + 16 * q;
#pragma unroll
          for (int e = 0; e < 16; ++e) x[e] = 16 * q + e < R ? (float)p[e] : 0.f;
        }
        store8<NL>(lat_pl(st, 0) + cm(c, 16 * q, CL), BK * MLA_R,
                   *reinterpret_cast<const float(*)[8]>(x));
        store8<NL>(lat_pl(st, 0) + cm(c, 16 * q + 8, CL), BK * MLA_R,
                   *reinterpret_cast<const float(*)[8]>(x + 8));
      }
      const int half = DR / 2, pk = pks[c];
      const signed char* kq = direct ? raw_rope(cs) + c * MLA_DR : a.kpq + row * DR;
#pragma unroll
      for (int i = 0; i < MLA_DR / 8; ++i) {
        const int j = cch + 4 * i;
        if (j >= half) continue;
        const float x1 = on ? (float)kq[j] : 0.f;
        const float x2 = on ? (float)kq[half + j] : 0.f;
        if (any_plain) {        // the roped keys serve ordinary rows only
          float sn = 0.f, cn = 1.f;
          if (on) sincosf((float)pk * rinv_s[j], &sn, &cn);
          bf16* kr = rope_pl(st, 0);
          split_store<NR>(x1 * cn - x2 * sn, kr + cm(c, j, CR), BK * MLA_DR);
          split_store<NR>(x1 * sn + x2 * cn, kr + cm(c, half + j, CR), BK * MLA_DR);
        }
        if (kn_on) {
          bf16* kx = nope_pl(st, 0);
          split_store<NN>(x1, kx + cm(c, j, CR), BK * MLA_DR);
          split_store<NN>(x2, kx + cm(c, half + j, CR), BK * MLA_DR);
        }
      }
      if (tid < BK) {
        const bool o = pks[tid] >= 0;
        const size_t sl = (size_t)b * cap + k0 + tid;
        cs_s[tid] = !o ? 0.f : direct ? raw_cs(cs)[tid] : a.cks[sl];
        ps_s[tid] = !o ? 0.f : direct ? raw_ps(cs)[tid] : a.kps[sl];
      }
    } else {
#pragma unroll
      for (int i = 0; i < CL / 4; ++i) {
        const int ch = cch + 4 * i;
        float x[8];
        if (!on) {
#pragma unroll
          for (int e = 0; e < 8; ++e) x[e] = 0.f;
        } else {
          load8(a.ckv + row * R + ch * 8, R - ch * 8, x);
        }
        store8<NL>(lat_pl(st, 0) + cm(c, ch * 8, CL), BK * MLA_R, x);
      }
#pragma unroll
      for (int i = 0; i < MLA_DR / 4; ++i) {
        const int d = cch + 4 * i;
        if (d >= DR) continue;
        const size_t off = row * DR + d;
        if (any_plain)
          split_store<NR>(on ? to_f(a.kpr[off]) : 0.f, rope_pl(st, 0) + cm(c, d, CR),
                          BK * MLA_DR);
        if (kn_on)
          split_store<NN>(on ? to_f(a.kpe[off]) : 0.f, nope_pl(st, 0) + cm(c, d, CR),
                          BK * MLA_DR);
      }
    }
  };

  // this thread's two rows (g, g + 8 of its warp's 16)
  const int wr0 = warp * 16;
  // fp32 (mma.sync, per warp): which rope products this warp's rows need,
  // the roped keys for ordinary rows, the unroped ones for [SUM] rows
  // (both only where the sort leaves a mixed warp); the latent product
  // serves both
  const int wrow = min(wr0 + (lane & 15), RB - 1);
  const bool w_live = wr0 < nr;
  const bool w_sum = NOPE && any_sum &&
                     __any_sync(FULL, wr0 + (lane & 15) < nr && tb.sum_r[wrow]);
  const bool w_plain = __any_sync(FULL, wr0 + (lane & 15) < nr && !tb.sum_r[wrow]);
  int pq[2], sg[2];
  bool rin[2], rsum[2];
  float al[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr0 + g + 8 * h;
    rin[h] = r < nr;
    pq[h] = tb.pos_r[r];
    sg[h] = tb.seg_r[r];
    rsum[h] = NOPE && tb.sum_r[r] != 0;
    al[h] = tb.alibi_r[r];
  }
  // fp32: this thread's two query rows in memory (latent, rope span), from
  // which it builds its A fragments (no Q plane)
  const T* qg[2] = {nullptr, nullptr};
  const T* qgr[2] = {nullptr, nullptr};
  if constexpr (!M::QPLANE) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (rin[h]) {
        qg[h] = q_row(wr0 + g + 8 * h);
        qgr[h] = qg[h] + R;
      }
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NT_L][4];
#pragma unroll
  for (int j = 0; j < NT_L; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  auto next = [&](int kt) {
    if (kt + S - 1 < n_live) issue(kt + S - 1);
    meta_issue(kt + 2 * S - 1);
    cp_commit();
  };
  // fp32, mma.sync: ldmatrix lane offsets into core-matrix planes
  const int kn = (lane & 7) + (lane >> 4) * 8, kc = ((lane >> 3) & 1) * 8;   // K
  const int vn = (lane & 7) + ((lane >> 3) & 1) * 8, vc = (lane >> 4) * 8;   // V
  // Q.K^T over the rope span's k-steps from the planes at `pl` (NT terms,
  // term pairs below TT) into sa
  auto rope_scores = [&](auto pl, auto nt, auto tt, float (&sa)[NT_S][4]) {
    constexpr int NT = decltype(nt)::value, TT = decltype(tt)::value;
    for (int kd = 0; kd < DRP / 16; ++kd) {
      uint32_t fq[NQ][4], fk[NT][2][4];
      a_frag_rows<NQ>(qgr, kd * 16 + 2 * cq, DR, fq);
#pragma unroll
      for (int tk = 0; tk < NT; ++tk)
#pragma unroll
        for (int jp = 0; jp < 2; ++jp)
          ldsm_x4(fk[tk][jp], pl(tk) + cm(jp * 16 + kn, kd * 16 + kc, CR));
#pragma unroll
      for (int tk = 0; tk < NT; ++tk)
#pragma unroll
        for (int tq = 0; tq < NQ; ++tq)
          if (tq + tk < TT) {
#pragma unroll
            for (int jp = 0; jp < 2; ++jp) {
              mma(sa[2 * jp], fq[tq], fk[tk][jp][0], fk[tk][jp][1]);
              mma(sa[2 * jp + 1], fq[tq], fk[tk][jp][2], fk[tk][jp][3]);
            }
          }
    }
  };
  // Q.K^T over the latent span, every row of the warp, into sa
  auto latent_scores = [&](auto st, float (&sa)[NT_S][4]) {
    for (int kd = 0; kd < RP / 16; ++kd) {
      uint32_t fq[NQ][4], fk[NL][2][4];
      a_frag_rows<NQ>(qg, kd * 16 + 2 * cq, R, fq);
#pragma unroll
      for (int tk = 0; tk < NL; ++tk)
#pragma unroll
        for (int jp = 0; jp < 2; ++jp)
          ldsm_x4(fk[tk][jp], lat_pl(st, tk) + cm(jp * 16 + kn, kd * 16 + kc, CL));
#pragma unroll
      for (int tk = 0; tk < NL; ++tk)
#pragma unroll
        for (int tq = 0; tq < NQ; ++tq)
          if (tq + tk < TL) {
#pragma unroll
            for (int jp = 0; jp < 2; ++jp) {
              mma(sa[2 * jp], fq[tq], fk[tk][jp][0], fk[tk][jp][1]);
              mma(sa[2 * jp + 1], fq[tq], fk[tk][jp][2], fk[tk][jp][3]);
            }
          }
    }
  };

  // One tile: the scores (sx: the rope span's, roped keys for ordinary
  // rows, unroped for [SUM] rows; sl: the latent span's), the softmax,
  // P.V. bf16: the warpgroup's wgmma, all 64 rows at once, both rope
  // products where the CTA holds both kinds of row (the one a row does not
  // take is dropped), every k-step issued before one wait; fp32: mma.sync
  // per warp.
  auto compute = [&](int kt, bool& issued) {
    const int st = kt % PS;
    const int* pks = pos_ks + (kt % MS) * BK;
    const int* sks = seg_ks + (kt % MS) * BK;
    float sx[NT_S][4], sl[NT_S][4], sn[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sx[j][e] = sl[j][e] = sn[j][e] = 0.f;
    if (direct) {     // the next tile's copies, beside this tile's products
      next(kt);
      issued = true;
    }
    if constexpr (M::QPLANE) {
      wg_fence();
#pragma unroll
      for (int kd = 0; kd < MLA_DR / 16; ++kd) {
        const uint64_t qa = gdesc(q_rope + kd * 128, 128, CR * 128);
#pragma unroll
        for (int t = 0; t < NR; ++t)
          wg_qk(sx, qa, gdesc(rope_pl(st, t) + kd * 128, 128, CR * 128));
        if constexpr (NOPE)
          wg_qk(sn, qa, gdesc(nope_pl(st, 0) + kd * 128, 128, CR * 128));
      }
#pragma unroll
      for (int kd = 0; kd < MLA_R / 16; ++kd)
        wg_qk(sl, gdesc(q_lat + kd * 128, 128, CL * 128),
              gdesc(lat_pl(st, 0) + kd * 128, 128, CL * 128));
      wg_commit();
      wg_wait0();
      hold(sx);
      hold(sl);
      hold(sn);
    } else {
      if (w_plain) rope_scores([&](int t) { return rope_pl(st, t); }, IC<NR>{}, IC<TR>{}, sx);
      if (NOPE && w_sum)
        rope_scores([&](int t) { return nope_pl(st, t); }, IC<NN>{}, IC<TN>{}, sn);
      latent_scores(st, sl);
    }

    // masks, scales, ALiBi, online softmax in base 2 (scores times
    // log2 e); element (j, 2h + e) is row g + 8h, column j * 8 + 2 cq + e
    int cpk[NT_S][2], csk[NT_S][2];
    float ccs[NT_S][2], cps[NT_S][2];
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + 2 * cq + e;
        cpk[j][e] = pks[c];
        csk[j][e] = a.use_seg ? sks[c] : -1;
        ccs[j][e] = QUANT ? cs_s[c] : 1.f;
        cps[j][e] = QUANT ? ps_s[c] : 1.f;
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
          const float xr = rsum[h] ? sn[j][2 * h + e] : sx[j][2 * h + e];
          float x = QUANT ? sl[j][2 * h + e] * ccs[j][e] + xr * cps[j][e]
                          : sl[j][2 * h + e] + xr;
          x *= sl2;
          if (NOPE && rsum[h]) x -= al[h] * LOG2E * (float)dd;
          sx[j][2 * h + e] = ok ? x : -INFINITY;
          tmax = fmaxf(tmax, sx[j][2 * h + e]);
        }
      tmax = fmaxf(tmax, __shfl_xor_sync(FULL, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(FULL, tmax, 2));
      // the running max moves only when the tile's passes it by more than
      // 8 (P stays below 2^8, and most tiles rescale nothing); the result
      // does not depend on where it stands
      const float m_new = tmax > m[h] + 8.f ? tmax : m[h];
      float rs = 0.f;
      alpha[h] = 1.f;
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sx[j][2 * h + e];
          x = m_new == -INFINITY ? 0.f : ex2(x - m_new);
          rs += x;
        }
      if (m_new != m[h]) {
        alpha[h] = ex2(m[h] - m_new);
        m[h] = m_new;
      }
      rs += __shfl_xor_sync(FULL, rs, 1);
      rs += __shfl_xor_sync(FULL, rs, 2);
      l[h] = l[h] * alpha[h] + rs;
    }
    if (__any_sync(FULL, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < NT_L; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }
    }
    // P (times V's scale, ckv_scale, in int8) as NP bf16 terms, in the A
    // layout (of mma.sync's m16n8k16 and, per warp, of wgmma's m64nNk16)
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 2 * kk + (i >> 1), h = i & 1;
        float x0 = sx[j][2 * h], x1 = sx[j][2 * h + 1];
        if (QUANT) {
          x0 *= ccs[j][0];
          x1 *= ccs[j][1];
        }
#pragma unroll
        for (int t = 0; t < NP; ++t) {
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);   // x0 low
          pa[t][kk][i] = *reinterpret_cast<const uint32_t*>(&h2);
          x0 -= __low2float(h2);
          x1 -= __high2float(h2);
        }
      }
    if constexpr (M::QPLANE) {
      // P.V from the latent plane's columns [vc0, vc0 + VW), read
      // transposed: 16 slots a k-step (core matrices CL * 128 bytes apart
      // along K, 128 along N)
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KK; ++kk)
#pragma unroll
        for (int t = 0; t < NP; ++t)
          wg_pv(acc, pa[t][kk],
                gdesc(lat_pl(st, 0) + kk * 2 * CL * 64 + cm(0, vc0, CL), CL * 128, 128));
      wg_commit();
      wg_wait0();
      hold(acc);
    } else {
      // P.V: NG 16-column pairs of V fragments loaded, then their mmas
#pragma unroll
      for (int kk = 0; kk < KK; ++kk)
#pragma unroll
        for (int n4 = 0; n4 < NT_L / (2 * NG); ++n4) {
          if (n4 * NG * 16 < RVP) {
            uint32_t bv[NL][NG][4];
#pragma unroll
            for (int tv = 0; tv < NL; ++tv)
#pragma unroll
              for (int u = 0; u < NG; ++u)
                if ((n4 * NG + u) * 16 < RVP)
                  ldsm_x4_t(bv[tv][u], lat_pl(st, tv) + cm(kk * 16 + vn,
                                                           vc0 + (n4 * NG + u) * 16 + vc, CL));
#pragma unroll
            for (int tv = 0; tv < NL; ++tv)
#pragma unroll
              for (int tp = 0; tp < NP; ++tp)
                if (tp + tv < TPV) {
#pragma unroll
                  for (int u = 0; u < NG; ++u)
                    if ((n4 * NG + u) * 16 < RVP) {
                      const int np = n4 * NG + u;
                      mma(acc[2 * np], pa[tp][kk], bv[tv][u][0], bv[tv][u][1]);
                      mma(acc[2 * np + 1], pa[tp][kk], bv[tv][u][2], bv[tv][u][3]);
                    }
                }
          }
        }
    }
  };

  // The Q planes ([SUM] rows hold q_nope), zero past R (DR) and past the
  // last row: (row, chunk of 8 values) pairs over the block, eight lanes
  // to a core matrix; by cp.async with tile 0's copies, or from memory
  auto q_stage = [&](bool by_copy) {
    constexpr int NCH = CL + CR;
    for (int i = tid; i < RB * NCH; i += THREADS) {
      const int rest = i >> 3, pc = rest % NCH, r = (rest / NCH) * 8 + (i & 7);
      const bool lat = pc < CL;
      const int off = lat ? pc * 8 : R + (pc - CL) * 8, lim = lat ? R : D;
      const bool on = r < nr && off < lim;
      bf16* dst = lat ? q_lat + cm(r, pc * 8, CL) : q_rope + cm(r, (pc - CL) * 8, CR);
      if (by_copy) {
        cp16(dst, on ? q_row(r) + off : a.q, on);
        continue;
      }
      float x[8];
      if (on) {
        load8(q_row(r) + off, lim - off, x);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = 0.f;
      }
      store8<1>(dst, 0, x);
    }
  };
  // The pipeline, as in the GQA mode
  if (direct && n_live > 0) {
    for (int kt = 0; kt < S && kt < n_live; ++kt) {
      const int tt = tb.tl[kt];
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
      if (M::QPLANE && kt == 0) q_stage(true);
      meta_issue(kt + S);
      cp_commit();
    }
  }
  if constexpr (M::QPLANE) {
    if (!direct) q_stage(false);
  }
  // the Q planes are read after the loop's first barrier
  for (int kt = 0; kt < n_live; ++kt) {
    if (direct)
      cp_wait<(S > 1 ? S - 2 : 0)>();   // tile kt's group
    else
      meta_sync(kt);
    fence_async_smem();
    int pk = -1;
    if (tid < BK) {
      pk = pk_at(kt, tid);
      pos_ks[(kt % MS) * BK + tid] = pk;
    }
    bool issued = false;
    if (__syncthreads_or(pk >= 0)) {
      if (!planes_direct) {
        convert(kt);
        fence_async_smem();
        __syncthreads();
      }
      if (M::QPLANE || w_live) compute(kt, issued);
    }
    if (direct && !issued) next(kt);
  }
  if (direct) cp_wait<0>();

  const size_t rows = (size_t)a.B * s * a.H;
  const bool vec = (R & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr0 + g + 8 * h;
    if (r >= nr) continue;
    const size_t row = ((size_t)b * s + tb.rq[r]) * a.H + tb.rh[r];
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
#pragma unroll
    for (int j = 0; j < NT_L; ++j) {
      const int col = j * 8 + 2 * cq;
      if (col >= RV) continue;
      const bool two = col + 1 < RV;
      if (a.n_split == 1)
        store2(a.o + row * R + vc0 + col, acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv, two,
               vec);
      else
        store2(a.ws_acc + ((size_t)split * rows + row) * R + vc0 + col, acc[j][2 * h],
               acc[j][2 * h + 1], two, vec);
    }
    // every value-column chunk holds the same m and l: the first writes them
    if (a.n_split > 1 && cq == 0 && vch == 0) {
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

template <typename T>
int combine(const float* ws_acc, const float* ws_m, const float* ws_l, T* o,
            size_t rows, int Dv, int n_split, cudaStream_t stream) {
  const size_t n = rows * Dv;
  combine_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      ws_acc, ws_m, ws_l, o, rows, Dv, n_split);
  return (int)cudaGetLastError();
}

template <typename T, bool NOPE, bool QUANT>
int launch(const Args<T>& a, cudaStream_t stream) {
  const size_t smem = Smem<T, NOPE, QUANT>::BYTES + (3 * (size_t)a.s + a.H / a.Hk) * 4;
  auto kern = decode_attn_kernel<T, NOPE, QUANT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.n_rb * a.n_split, a.Hk, a.B);
  kern<<<grid, THREADS, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.n_split == 1) return (int)e;
  return combine(a.ws_acc, a.ws_m, a.ws_l, a.o, (size_t)a.B * a.s * a.H, a.Dv,
                 a.n_split, stream);
}

// The MLA mode: `smem` is the bytes `mla_smem_bytes` in decode_attn.py
// computes; a launch whose count differs from the kernel's own is refused.
template <typename G, typename T, bool NOPE, bool QUANT>
size_t mla_smem(int s, int H) {
  return MlaSmem<G, T, NOPE, QUANT>::BYTES + (3 * (size_t)s + H) * 4;
}

// the kernel's shared memory, with the carveout that lets two CTAs share
// an SM (the narrow geometry's)
template <typename G, typename T, bool NOPE, bool QUANT>
cudaError_t mla_attrs(size_t smem) {
  auto kern = mla_kernel<G, T, NOPE, QUANT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename G, typename T, bool NOPE, bool QUANT>
int mla_launch(MlaArgs<T> a, int want_smem, cudaStream_t stream) {
  const size_t smem = mla_smem<G, T, NOPE, QUANT>(a.s, a.H);
  if ((size_t)want_smem != smem) return (int)cudaErrorInvalidValue;
  auto kern = mla_kernel<G, T, NOPE, QUANT>;
  cudaError_t e = mla_attrs<G, T, NOPE, QUANT>(smem);
  if (e != cudaSuccess) return (int)e;
  a.n_vc = (a.R + G::VW - 1) / G::VW;
  const dim3 grid(a.n_rb * a.n_split * a.n_vc, a.B);
  kern<<<grid, THREADS, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.n_split == 1) return (int)e;
  return combine(a.ws_acc, a.ws_m, a.ws_l, a.o, (size_t)a.B * a.s * a.H, a.R,
                 a.n_split, stream);
}

// The operands both modes share; k/v are T in the bf16/fp32 mode and int8
// codes (with ks/vs/rinv) in the int8 mode.
struct Ptrs {
  const void *q, *qn, *k, *kn, *v, *ks, *vs, *rinv, *alibi;
  const void *pos_q, *pos_k, *sum_q, *seg_q, *seg_k;
  void *o, *ws;
};

struct Plan {
  int n_rb, n_split, span;
};

// the plan must tile the rows and the cache exactly (the split plans)
bool plan_ok(const Plan& pl, int rows, int cap, const void* ws) {
  return pl.n_rb == (rows + RB - 1) / RB && pl.n_split >= 1 && pl.span > 0 &&
         pl.span % BK == 0 && pl.span <= MAX_TILES * BK &&
         (long long)pl.n_split * pl.span >= cap &&
         (long long)(pl.n_split - 1) * pl.span < (cap > 0 ? cap : 1) &&
         (pl.n_split == 1 || ws != nullptr);
}

template <typename T>
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
  a.n_rb = pl.n_rb; a.n_split = pl.n_split; a.span = pl.span;
  // 16-byte copies need 16-byte rows and bases
  const uintptr_t al = (uintptr_t)p.k | (uintptr_t)p.v |
                       (use_nope && !quant ? (uintptr_t)p.kn : 0);
  const int row = quant ? 16 : 8;    // elements in 16 bytes
  a.direct = (quant || sizeof(T) == 2) && D % row == 0 && Dv % row == 0 &&
             al % 16 == 0;
  if (quant)
    return use_nope ? launch<T, true, true>(a, st) : launch<T, false, true>(a, st);
  return use_nope ? launch<T, true, false>(a, st) : launch<T, false, false>(a, st);
}

int dispatch(const Ptrs& p, const Plan& pl, int B, int s, int H, int Hk,
             int cap, int D, int Dv, int G, int rope_start, int window,
             int use_nope, int use_seg, int quant, int is_bf16, float scale,
             void* stream) {
  if (D > DMAX || Dv > DMAX || D <= 0 || Dv <= 0 || Hk <= 0 || H % Hk != 0 ||
      (use_nope && (p.qn == nullptr || p.sum_q == nullptr ||
                    (!quant && p.kn == nullptr))) ||
      (use_seg && (p.seg_q == nullptr || p.seg_k == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (quant && (p.ks == nullptr || p.vs == nullptr || p.rinv == nullptr ||
                (G != 1 && G != 2) || rope_start < 0 || rope_start >= D ||
                (D - rope_start) % 2 != 0))
    return (int)cudaErrorInvalidValue;
  if (!plan_ok(pl, H / Hk * s, cap, p.ws)) return (int)cudaErrorInvalidValue;
  if (B == 0 || s == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return run<bf16>(p, pl, B, s, H, Hk, cap, D, Dv, G, rope_start, window,
                     use_nope, use_seg, quant, scale, st);
  return run<float>(p, pl, B, s, H, Hk, cap, D, Dv, G, rope_start, window,
                    use_nope, use_seg, quant, scale, st);
}

// The MLA mode's operands: bf16/fp32 ckv, kpe_rope (kpr), kpe; int8 the
// codes of ckv and kpe (in ckv, kpe) with cks, kps, rinv
struct MlaPtrs {
  const void *q, *qn, *ckv, *kpr, *kpe, *cks, *kps, *rinv, *alibi;
  const void *pos_q, *pos_k, *sum_q, *seg_q, *seg_k;
  void *o, *ws;
};

template <typename T>
int mla_run(const MlaPtrs& p, const Plan& pl, int B, int s, int H, int cap,
            int R, int DR, int window, int use_nope, int use_seg, int quant,
            int smem, float scale, cudaStream_t st) {
  MlaArgs<T> a;
  a.q = static_cast<const T*>(p.q);
  a.qn = static_cast<const T*>(p.qn);
  a.ckv = static_cast<const T*>(p.ckv);
  a.kpr = static_cast<const T*>(p.kpr);
  a.kpe = static_cast<const T*>(p.kpe);
  a.ckq = static_cast<const signed char*>(p.ckv);
  a.kpq = static_cast<const signed char*>(p.kpe);
  a.cks = static_cast<const float*>(p.cks);
  a.kps = static_cast<const float*>(p.kps);
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
  a.ws_m = a.ws_acc == nullptr ? nullptr : a.ws_acc + (size_t)pl.n_split * rows * R;
  a.ws_l = a.ws_m == nullptr ? nullptr : a.ws_m + (size_t)pl.n_split * rows;
  a.B = B; a.s = s; a.H = H; a.cap = cap; a.R = R; a.DR = DR;
  a.window = window; a.use_seg = use_seg; a.scale = scale;
  a.n_rb = pl.n_rb; a.n_split = pl.n_split; a.span = pl.span;
  // 16-byte copies (bf16 queries: the Q planes' too) need 16-byte rows
  // and bases
  const int row = quant ? 16 : 8;    // elements in 16 bytes
  const uintptr_t al = (uintptr_t)p.ckv | (uintptr_t)p.kpe |
                       (quant ? 0 : (uintptr_t)p.kpr) |
                       (sizeof(T) == 2 ? (uintptr_t)p.q | (uintptr_t)p.qn : 0);
  a.direct = (quant || sizeof(T) == 2) && R % row == 0 && DR % row == 0 &&
             al % 16 == 0;
  // the narrowest geometry that holds R and DR (`mla_geometry`)
  const bool narrow = R <= MlaNarrow::LAT && DR <= MlaNarrow::ROPE;
  if (quant) {
    if (narrow)
      return use_nope ? mla_launch<MlaNarrow, T, true, true>(a, smem, st)
                      : mla_launch<MlaNarrow, T, false, true>(a, smem, st);
    return use_nope ? mla_launch<MlaWide, T, true, true>(a, smem, st)
                    : mla_launch<MlaWide, T, false, true>(a, smem, st);
  }
  if (narrow)
    return use_nope ? mla_launch<MlaNarrow, T, true, false>(a, smem, st)
                    : mla_launch<MlaNarrow, T, false, false>(a, smem, st);
  return use_nope ? mla_launch<MlaWide, T, true, false>(a, smem, st)
                  : mla_launch<MlaWide, T, false, false>(a, smem, st);
}

int mla_dispatch(const MlaPtrs& p, const Plan& pl, int B, int s, int H,
                 int cap, int R, int DR, int window, int use_nope,
                 int use_seg, int quant, int is_bf16, int smem, float scale,
                 void* stream) {
  if (R <= 0 || R > MlaWide::LAT || DR <= 0 || DR > MlaWide::ROPE || DR % 2 != 0 || H <= 0 ||
      p.ckv == nullptr || ((quant || use_nope) && p.kpe == nullptr) ||
      (!quant && p.kpr == nullptr) ||
      (use_nope && (p.qn == nullptr || p.sum_q == nullptr)) ||
      (use_seg && (p.seg_q == nullptr || p.seg_k == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (quant && (p.cks == nullptr || p.kps == nullptr || p.rinv == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!plan_ok(pl, H * s, cap, p.ws)) return (int)cudaErrorInvalidValue;
  if (B == 0 || s == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return mla_run<bf16>(p, pl, B, s, H, cap, R, DR, window, use_nope, use_seg,
                         quant, smem, scale, st);
  return mla_run<float>(p, pl, B, s, H, cap, R, DR, window, use_nope, use_seg,
                        quant, smem, scale, st);
}

template <typename G, typename T, bool NOPE, bool QUANT>
int mla_occupancy(int s, int H, int* n) {
  const size_t smem = mla_smem<G, T, NOPE, QUANT>(s, H);
  cudaError_t e = mla_attrs<G, T, NOPE, QUANT>(smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, mla_kernel<G, T, NOPE, QUANT>, THREADS, smem);
}

template <typename G>
int mla_occupancy_of(int is_bf16, int quant, int nope, int s, int H, int* n) {
  if (is_bf16)
    return quant ? (nope ? mla_occupancy<G, bf16, true, true>(s, H, n)
                         : mla_occupancy<G, bf16, false, true>(s, H, n))
                 : (nope ? mla_occupancy<G, bf16, true, false>(s, H, n)
                         : mla_occupancy<G, bf16, false, false>(s, H, n));
  return quant ? (nope ? mla_occupancy<G, float, true, true>(s, H, n)
                       : mla_occupancy<G, float, false, true>(s, H, n))
               : (nope ? mla_occupancy<G, float, true, false>(s, H, n)
                       : mla_occupancy<G, float, false, false>(s, H, n));
}

}  // namespace

// Every entry point returns the launch's cudaError_t (0 = launched).
// Pointers the flags switch off may be null. `is_bf16` is the type of q,
// q_nope and o. The split plan (n_rb row blocks of 64 rows, n_split kv
// ranges of `span` slots) comes from `decode_split_plan` (GQA) or
// `mla_split_plan`; with n_split > 1 `ws` holds n_split * B * s * H *
// (Dv + 2) fp32 partials, and a combine kernel runs after the main one on
// the same stream.
extern "C" int decode_attn_fwd(
    const void* q, const void* qn, const void* k, const void* kn,
    const void* v, const void* alibi, const void* pos_q, const void* pos_k,
    const void* sum_q, const void* seg_q, const void* seg_k, void* o,
    void* ws, int B, int s, int H, int Hk, int cap, int D, int Dv,
    int window, int use_nope, int use_seg, int is_bf16, int n_rb,
    int n_split, int span, float scale, void* stream) {
  const Ptrs p{q, qn, k, kn, v, nullptr, nullptr, nullptr, alibi,
               pos_q, pos_k, sum_q, seg_q, seg_k, o, ws};
  return dispatch(p, Plan{n_rb, n_split, span}, B, s, H, Hk, cap, D, Dv, 1,
                  0, window, use_nope, use_seg, 0, is_bf16, scale, stream);
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
  return dispatch(p, Plan{n_rb, n_split, span}, B, s, H, Hk, cap, D, Dv, G,
                  rope_start, window, use_nope, use_seg, 1, is_bf16, scale,
                  stream);
}

// The absorbed-MLA mode on the latent cache in place: q, qn (B, s, H,
// R + DR); ckv (B, cap, R), the latent and the values; kpe_rope (roped,
// for ordinary rows) and kpe (unroped, for [SUM] rows) (B, cap, DR); o
// (B, s, H, R). `smem`: the shared memory the plan's mirror computed.
extern "C" int decode_attn_mla_fwd(
    const void* q, const void* qn, const void* ckv, const void* kpe_rope,
    const void* kpe, const void* alibi, const void* pos_q, const void* pos_k,
    const void* sum_q, const void* seg_q, const void* seg_k, void* o,
    void* ws, int B, int s, int H, int cap, int R, int DR, int window,
    int use_nope, int use_seg, int is_bf16, int n_rb, int n_split, int span,
    int smem, float scale, void* stream) {
  const MlaPtrs p{q, qn, ckv, kpe_rope, kpe, nullptr, nullptr, nullptr, alibi,
                  pos_q, pos_k, sum_q, seg_q, seg_k, o, ws};
  return mla_dispatch(p, Plan{n_rb, n_split, span}, B, s, H, cap, R, DR,
                      window, use_nope, use_seg, 0, is_bf16, smem, scale,
                      stream);
}

// Its int8 mode: ckv (B, cap, R) and kpe (B, cap, DR) int8 codes,
// ckv_scale and kpe_scale (B, cap) fp32 (ckv_scale is the values' scale
// too), rinv (DR / 2) fp32; the kernel ropes the kpe span itself.
extern "C" int decode_attn_mla_q8_fwd(
    const void* q, const void* qn, const void* ckv, const void* kpe,
    const void* ckv_scale, const void* kpe_scale, const void* rinv,
    const void* alibi, const void* pos_q, const void* pos_k,
    const void* sum_q, const void* seg_q, const void* seg_k, void* o,
    void* ws, int B, int s, int H, int cap, int R, int DR, int window,
    int use_nope, int use_seg, int is_bf16, int n_rb, int n_split, int span,
    int smem, float scale, void* stream) {
  const MlaPtrs p{q, qn, ckv, nullptr, kpe, ckv_scale, kpe_scale, rinv, alibi,
                  pos_q, pos_k, sum_q, seg_q, seg_k, o, ws};
  return mla_dispatch(p, Plan{n_rb, n_split, span}, B, s, H, cap, R, DR,
                      window, use_nope, use_seg, 1, is_bf16, smem, scale,
                      stream);
}

// The MLA kernel's resident CTAs per SM (into *n) for a mode, the
// geometry that holds R and DR, and a call's s and H, as the runtime's
// occupancy calculator gives them.
extern "C" int decode_attn_mla_ctas_per_sm(int is_bf16, int quant, int nope,
                                           int s, int H, int R, int DR, int* n) {
  if (R <= MlaNarrow::LAT && DR <= MlaNarrow::ROPE)
    return mla_occupancy_of<MlaNarrow>(is_bf16, quant, nope, s, H, n);
  return mla_occupancy_of<MlaWide>(is_bf16, quant, nope, s, H, n);
}
