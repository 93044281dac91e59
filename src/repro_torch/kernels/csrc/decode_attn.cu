// Decode/burst attention into the KV cache for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attn/decode_attn.py, `_kernel`
// (launched by `decode_attention_bshd`), the Pallas TPU kernel, in its
// bf16/fp32 mode (the int8 mode waits for the int8-cache slice).
//
// Computes, for s burst queries per batch row, an online-softmax pass over
// the row's cache in its native (B, cap, Hk, D) layout: a slot is
// attendable iff filled (pos_k >= 0), causal, within `window` when
// window > 0, and segment-compatible (seg_k < 0 shared, else equal to the
// query's). [SUM] rows score the NoPE stream minus ALiBi * distance. Rows
// with no key give 0. Cache blocks whose slots are all empty are skipped.
//
// What bounds it on this card: at the decode shape (B=8, cap=2048, s=64,
// H=32, Hk=8, D=128) it reads ~100 MB of roped K, raw K and V for
// ~4.3 GFLOP, ~43 FLOP/byte, under the ~295 FLOP/byte ridge: memory bound,
// ~30 us at 3.35 TB/s. The design therefore reads each cache tile once for
// all query heads that share it (GQA): one CTA per (kv head, batch row)
// stages a 32-slot K/V tile in shared memory and serves all n_rep query
// heads x s queries of its group from it, holding m, l and the output
// accumulator for up to 256 such rows in registers (512 threads, 8 rows x
// 8 value columns each). More rows are served in further passes. The
// products are fp32 FMA (no tensor cores yet); with only B*Hk CTAs the
// card is under-filled at small batch, and split-kv (flash-decoding) is the
// later fix. Capacity need not be a multiple of the tile: the tail is
// masked here, no padding copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BK = 32;         // cache slots per kv block
constexpr int RMAX = 256;      // query rows (n_rep heads x s queries) per pass
constexpr int DMAX = 128;      // largest head dim (qk and v)
constexpr int THREADS = 512;   // 32 row groups x 16 column groups
constexpr int LDK = DMAX + 1;  // padded row stride: conflict-free column reads
constexpr int LDP = BK + 1;
constexpr int RI = RMAX / 32;  // rows per thread
constexpr int CJ = BK / 16;    // score columns per thread
constexpr int VJ = DMAX / 16;  // value columns per thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
struct Args {
  const T *q, *qn, *k, *kn, *v;
  const float* alibi;
  const int *pos_q, *pos_k, *sum_q, *seg_q, *seg_k;
  T* o;
  int B, s, H, Hk, cap, D, Dv, window, use_seg;
  float scale;
};

__host__ __device__ constexpr size_t smem_floats(bool nope) {
  return (size_t)RMAX * LDK + (size_t)BK * LDK + (nope ? (size_t)BK * LDK : 0) +
         (size_t)BK * DMAX + (size_t)RMAX * LDP + RMAX;
}

__host__ __device__ constexpr size_t smem_bytes(bool nope) {
  return smem_floats(nope) * sizeof(float) + (3 * RMAX + 2 * BK) * sizeof(int);
}

template <typename T, bool NOPE>
__global__ void __launch_bounds__(THREADS, 1)
decode_attn_kernel(const Args<T> a) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + RMAX * LDK;
  float* kn_s = k_s + BK * LDK;
  float* v_s = kn_s + (NOPE ? BK * LDK : 0);
  float* p_s = v_s + BK * DMAX;
  float* alibi_r = p_s + RMAX * LDP;
  int* pos_r = reinterpret_cast<int*>(smem + smem_floats(NOPE));
  int* sum_r = pos_r + RMAX;
  int* seg_r = sum_r + RMAX;
  int* pos_ks = seg_r + RMAX;
  int* seg_ks = pos_ks + BK;

  const int hk = blockIdx.x, b = blockIdx.y;
  const int n_rep = a.H / a.Hk, s = a.s, D = a.D, Dv = a.Dv, cap = a.cap;
  const int R = n_rep * s;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n_kb = (cap + BK - 1) / BK;

  for (int r0 = 0; r0 < R; r0 += RMAX) {
    const int nr = min(RMAX, R - r0);
    __syncthreads();   // the previous pass is done with the row tiles
    // row r of this pass = query head hk * n_rep + (r0 + r) / s, query (r0 + r) % s
    for (int r = tid; r < RMAX; r += THREADS) {
      int p = 0, sm = 0, sg = 0;
      float al = 0.f;
      if (r < nr) {
        const int hh = hk * n_rep + (r0 + r) / s, t = (r0 + r) % s;
        const size_t bs = (size_t)b * s + t;
        p = a.pos_q[bs];
        sm = (NOPE && a.sum_q != nullptr) ? (a.sum_q[bs] != 0) : 0;
        sg = a.use_seg ? a.seg_q[bs] : 0;
        al = a.alibi[hh];
      }
      pos_r[r] = p;
      sum_r[r] = sm;
      seg_r[r] = sg;
      alibi_r[r] = al;
    }
    __syncthreads();
    for (int idx = tid; idx < nr * D; idx += THREADS) {
      const int r = idx / D, d = idx - r * D;
      const int hh = hk * n_rep + (r0 + r) / s, t = (r0 + r) % s;
      const size_t off = (((size_t)b * s + t) * a.H + hh) * D + d;
      q_s[r * LDK + d] = (NOPE && sum_r[r]) ? to_f(a.qn[off]) : to_f(a.q[off]);
    }
    const int any_sum = __syncthreads_or(tid < RMAX ? sum_r[tid] : 0);

    float m[RI], l[RI], acc[RI][VJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
#pragma unroll
      for (int j = 0; j < VJ; ++j) acc[i][j] = 0.f;
    }

    for (int kb = 0; kb < n_kb; ++kb) {
      const int k0 = kb * BK;
      __syncthreads();   // the previous block's tiles are no longer read
      if (tid < BK) {
        const int slot = k0 + tid;
        const bool in = slot < cap;
        pos_ks[tid] = in ? a.pos_k[(size_t)b * cap + slot] : -1;
        seg_ks[tid] = (in && a.use_seg) ? a.seg_k[(size_t)b * cap + slot] : -1;
      }
      // occupancy skip: a block of empty slots contributes nothing
      if (!__syncthreads_or(tid < BK && pos_ks[tid] >= 0)) continue;
      for (int idx = tid; idx < BK * D; idx += THREADS) {
        const int c = idx / D, d = idx - c * D, slot = k0 + c;
        float x = 0.f, xn = 0.f;
        if (slot < cap) {
          const size_t off = (((size_t)b * cap + slot) * a.Hk + hk) * D + d;
          x = to_f(a.k[off]);
          if (NOPE && any_sum) xn = to_f(a.kn[off]);
        }
        k_s[c * LDK + d] = x;
        if (NOPE) kn_s[c * LDK + d] = xn;
      }
      for (int idx = tid; idx < BK * Dv; idx += THREADS) {
        const int c = idx / Dv, d = idx - c * Dv, slot = k0 + c;
        v_s[c * DMAX + d] =
            slot < cap ? to_f(a.v[(((size_t)b * cap + slot) * a.Hk + hk) * Dv + d]) : 0.f;
      }
      __syncthreads();

      // scores: rows ty + 32 i, columns tx + 16 j
      float sc[RI][CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) sc[i][j] = 0.f;
      const int ni = (nr - ty + 31) / 32;   // rows this thread holds
      if (NOPE && any_sum) {
        for (int d = 0; d < D; ++d) {
          float kr[CJ], kx[CJ];
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            kr[j] = k_s[(tx + 16 * j) * LDK + d];
            kx[j] = kn_s[(tx + 16 * j) * LDK + d];
          }
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            if (i < ni) {
              const int r = ty + 32 * i;
              const float qv = q_s[r * LDK + d];
              const bool rs = sum_r[r] != 0;
#pragma unroll
              for (int j = 0; j < CJ; ++j) sc[i][j] += qv * (rs ? kx[j] : kr[j]);
            }
          }
        }
      } else {
        for (int d = 0; d < D; ++d) {
          float kr[CJ];
#pragma unroll
          for (int j = 0; j < CJ; ++j) kr[j] = k_s[(tx + 16 * j) * LDK + d];
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            if (i < ni) {
              const float qv = q_s[(ty + 32 * i) * LDK + d];
#pragma unroll
              for (int j = 0; j < CJ; ++j) sc[i][j] += qv * kr[j];
            }
          }
        }
      }

      // masks, ALiBi, online softmax (all lanes take part in the shuffles)
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = ty + 32 * i;
        const bool row_in = r < nr;
        const int pq = row_in ? pos_r[r] : 0;
        const bool sum_row = row_in && sum_r[r] != 0;
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int c = tx + 16 * j;
          const int pk = pos_ks[c];
          const int dd = pq - pk;
          bool ok = row_in && pk >= 0 && dd >= 0 && (a.window <= 0 || dd <= a.window);
          if (a.use_seg) ok = ok && (seg_ks[c] < 0 || seg_ks[c] == seg_r[r]);
          float x = sc[i][j] * a.scale;
          if (NOPE && sum_row) x -= alibi_r[r] * (float)dd;
          sc[i][j] = ok ? x : -INFINITY;
          tmax = fmaxf(tmax, sc[i][j]);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
        const float m_new = fmaxf(m[i], tmax);
        float alpha = 1.f, rsum = 0.f;
        float p[CJ];
#pragma unroll
        for (int j = 0; j < CJ; ++j) p[j] = 0.f;
        if (m_new != -INFINITY) {
          alpha = expf(m[i] - m_new);
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            p[j] = sc[i][j] == -INFINITY ? 0.f : expf(sc[i][j] - m_new);
            rsum += p[j];
          }
          m[i] = m_new;
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
        l[i] = l[i] * alpha + rsum;
#pragma unroll
        for (int j = 0; j < VJ; ++j) acc[i][j] *= alpha;
        if (row_in) {
#pragma unroll
          for (int j = 0; j < CJ; ++j) p_s[r * LDP + tx + 16 * j] = p[j];
        }
      }
      __syncthreads();

      for (int c = 0; c < BK; ++c) {
        float pv[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) pv[i] = i < ni ? p_s[(ty + 32 * i) * LDP + c] : 0.f;
#pragma unroll
        for (int j = 0; j < VJ; ++j) {
          const int col = tx + 16 * j;
          if (col < Dv) {
            const float vv = v_s[c * DMAX + col];
#pragma unroll
            for (int i = 0; i < RI; ++i) acc[i][j] += pv[i] * vv;
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 32 * i;
      if (r >= nr) continue;
      const int hh = hk * n_rep + (r0 + r) / s, t = (r0 + r) % s;
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
      const size_t ob = (((size_t)b * s + t) * a.H + hh) * Dv;
#pragma unroll
      for (int j = 0; j < VJ; ++j) {
        const int col = tx + 16 * j;
        if (col < Dv) store(a.o + ob + col, acc[i][j] * inv);
      }
    }
  }
}

template <typename T, bool NOPE>
int launch(const Args<T>& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(NOPE);
  auto kern = decode_attn_kernel<T, NOPE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.Hk, a.B);
  kern<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* q, const void* qn, const void* k, const void* kn,
        const void* v, const void* alibi, const void* pos_q,
        const void* pos_k, const void* sum_q, const void* seg_q,
        const void* seg_k, void* o, int B, int s, int H, int Hk, int cap,
        int D, int Dv, int window, int use_nope, int use_seg, float scale,
        cudaStream_t st) {
  Args<T> a;
  a.q = static_cast<const T*>(q);
  a.qn = static_cast<const T*>(qn);
  a.k = static_cast<const T*>(k);
  a.kn = static_cast<const T*>(kn);
  a.v = static_cast<const T*>(v);
  a.alibi = static_cast<const float*>(alibi);
  a.pos_q = static_cast<const int*>(pos_q);
  a.pos_k = static_cast<const int*>(pos_k);
  a.sum_q = static_cast<const int*>(sum_q);
  a.seg_q = static_cast<const int*>(seg_q);
  a.seg_k = static_cast<const int*>(seg_k);
  a.o = static_cast<T*>(o);
  a.B = B; a.s = s; a.H = H; a.Hk = Hk; a.cap = cap; a.D = D; a.Dv = Dv;
  a.window = window; a.use_seg = use_seg; a.scale = scale;
  return use_nope ? launch<T, true>(a, st) : launch<T, false>(a, st);
}

}  // namespace

// Returns the launch's cudaError_t (0 = launched). Pointers the flags
// switch off may be null.
extern "C" int decode_attn_fwd(
    const void* q, const void* qn, const void* k, const void* kn,
    const void* v, const void* alibi, const void* pos_q, const void* pos_k,
    const void* sum_q, const void* seg_q, const void* seg_k, void* o,
    int B, int s, int H, int Hk, int cap, int D, int Dv, int window,
    int use_nope, int use_seg, int is_bf16, float scale, void* stream) {
  if (D > DMAX || Dv > DMAX || D <= 0 || Dv <= 0 || Hk <= 0 || H % Hk != 0 ||
      (use_nope && (qn == nullptr || kn == nullptr || sum_q == nullptr)) ||
      (use_seg && (seg_q == nullptr || seg_k == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || s == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return run<__nv_bfloat16>(q, qn, k, kn, v, alibi, pos_q, pos_k, sum_q,
                              seg_q, seg_k, o, B, s, H, Hk, cap, D, Dv, window,
                              use_nope, use_seg, scale, st);
  return run<float>(q, qn, k, kn, v, alibi, pos_q, pos_k, sum_q, seg_q, seg_k,
                    o, B, s, H, Hk, cap, D, Dv, window, use_nope, use_seg,
                    scale, st);
}
