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
// What bounds it on this card: at dti-llama prefill (B=8, S=2048, H=32,
// D=128, window 1024) each query sees ~1k keys, ~0.27 TFLOP per call
// against ~0.5 GB of operands, far above the ~295 FLOP/byte ridge, so the
// bound is arithmetic. This first version does the products as fp32 FMA
// from shared memory (no tensor cores), so it runs far from the bf16 peak;
// mma/wgmma, TMA and warp specialisation are the work of later PRs.
//
// Design: one CTA per (q block of 64 rows, head, batch row). The TPU grid
// walked the kv band as a sequential grid axis carrying m/l/acc in VMEM;
// Hopper has no sequential grid axis, so the CTA loops over its own band
// of kv blocks. It stages its q tile once (fp32 in shared memory; [SUM]
// rows stage q_nope instead, since their scores use the NoPE stream only),
// then per kv block stages K, K_nope (only when the q tile holds a [SUM]
// row), V (and V0 with reset), computes a 64x64 score tile as 4x4 micro
// tiles per thread, and keeps m, l and the 64xDv accumulator in registers.
// The band is physical (blocks within `window` rows of the q block), the
// mask positional, as in the reference. The ragged last block is masked
// here; no gcd-shrunk block sizes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;         // query rows per CTA
constexpr int BK = 64;         // keys per kv block
constexpr int DMAX = 128;      // largest head dim (qk and v)
constexpr int THREADS = 256;   // 16 row groups x 16 column groups
constexpr int LDQ = DMAX + 1;  // padded row stride: conflict-free column reads
constexpr int LDP = BK + 1;
constexpr int RI = BQ / 16;    // rows per thread
constexpr int CJ = BK / 16;    // score columns per thread
constexpr int VJ = DMAX / 16;  // value columns per thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
struct Args {
  const T *q, *qn, *k, *kn, *v, *v0;
  const float* alibi;
  const int *pos_q, *pos_k, *sum_q, *sum_k, *valid_k, *seg_q, *seg_k;
  T* o;
  float* lse;
  int B, S, H, Hk, D, Dv, window, sum_isolated, use_seg;
  float scale, y_min, y_max, midpoint;
};

__host__ __device__ constexpr size_t smem_floats(bool nope, bool reset) {
  return (size_t)BQ * LDQ + (size_t)BK * LDQ + (nope ? (size_t)BK * LDQ : 0) +
         (size_t)BK * DMAX + (reset ? (size_t)BK * DMAX : 0) +
         (size_t)BQ * LDP + (reset ? (size_t)BQ * LDP : 0);
}

__host__ __device__ constexpr size_t smem_bytes(bool nope, bool reset) {
  return smem_floats(nope, reset) * sizeof(float) + (3 * BQ + 3 * BK) * sizeof(int);
}

template <typename T, bool NOPE, bool RESET>
__global__ void __launch_bounds__(THREADS)
windowed_attn_kernel(const Args<T> a) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + BQ * LDQ;
  float* kn_s = k_s + BK * LDQ;
  float* v_s = kn_s + (NOPE ? BK * LDQ : 0);
  float* v0_s = v_s + BK * DMAX;
  float* p_s = v0_s + (RESET ? BK * DMAX : 0);
  float* pa_s = p_s + BQ * LDP;
  int* pos_qs = reinterpret_cast<int*>(smem + smem_floats(NOPE, RESET));
  int* sum_qs = pos_qs + BQ;
  int* seg_qs = sum_qs + BQ;
  int* pos_ks = seg_qs + BQ;
  int* flag_ks = pos_ks + BK;   // bit 0: attendable key slot, bit 1: [SUM] key
  int* seg_ks = flag_ks + BK;

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hk);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int S = a.S, D = a.D, Dv = a.Dv;
  const int q0 = iq * BQ;
  const float alibi_h = a.alibi[h];

  for (int r = tid; r < BQ; r += THREADS) {
    const int qi = q0 + r;
    const bool in = qi < S;
    const size_t bs = (size_t)b * S + qi;
    pos_qs[r] = in ? a.pos_q[bs] : 0;
    sum_qs[r] = (in && a.sum_q != nullptr) ? (a.sum_q[bs] != 0) : 0;
    seg_qs[r] = (in && a.use_seg) ? a.seg_q[bs] : 0;
  }
  __syncthreads();
  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx - r * D, qi = q0 + r;
    float x = 0.f;
    if (qi < S) {
      const size_t off = (((size_t)b * S + qi) * a.H + h) * D + d;
      x = (NOPE && sum_qs[r]) ? to_f(a.qn[off]) : to_f(a.q[off]);
    }
    q_s[r * LDQ + d] = x;
  }
  const int tile_has_sum = __syncthreads_or(tid < BQ ? sum_qs[tid] : 0);

  float m[RI], l[RI], acc[RI][VJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < VJ; ++j) acc[i][j] = 0.f;
  }

  // physical band: kv blocks holding rows [q0 - window, q0 + BQ - 1]
  const int last = min(q0 + BQ, S) - 1;
  const int kb_lo = max(q0 - a.window, 0) / BK;
  const int kb_hi = last / BK;

  for (int kb = kb_lo; kb <= kb_hi; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();   // the previous block's tiles are no longer read
    for (int c = tid; c < BK; c += THREADS) {
      const int kj = k0 + c;
      const bool in = kj < S;
      const size_t bs = (size_t)b * S + kj;
      pos_ks[c] = in ? a.pos_k[bs] : 0;
      const int ok = in && (a.valid_k == nullptr || a.valid_k[bs] != 0);
      const int sk = (in && a.sum_isolated) ? (a.sum_k[bs] != 0) : 0;
      flag_ks[c] = ok | (sk << 1);
      seg_ks[c] = (in && a.use_seg) ? a.seg_k[bs] : 0;
    }
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int c = idx / D, d = idx - c * D, kj = k0 + c;
      float x = 0.f, xn = 0.f;
      if (kj < S) {
        const size_t off = (((size_t)b * S + kj) * a.Hk + hk) * D + d;
        x = to_f(a.k[off]);
        if (NOPE && tile_has_sum) xn = to_f(a.kn[off]);
      }
      k_s[c * LDQ + d] = x;
      if (NOPE) kn_s[c * LDQ + d] = xn;
    }
    for (int idx = tid; idx < BK * Dv; idx += THREADS) {
      const int c = idx / Dv, d = idx - c * Dv, kj = k0 + c;
      float x = 0.f, x0 = 0.f;
      if (kj < S) {
        const size_t off = (((size_t)b * S + kj) * a.Hk + hk) * Dv + d;
        x = to_f(a.v[off]);
        if (RESET) x0 = to_f(a.v0[off]);
      }
      v_s[c * DMAX + d] = x;
      if (RESET) v0_s[c * DMAX + d] = x0;
    }
    __syncthreads();

    // scores: rows ty + 16 i, columns tx + 16 j
    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
    if (NOPE && tile_has_sum) {
      bool rs[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) rs[i] = sum_qs[ty + 16 * i] != 0;
      for (int d = 0; d < D; ++d) {
        float kr[CJ], kx[CJ];
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          kr[j] = k_s[(tx + 16 * j) * LDQ + d];
          kx[j] = kn_s[(tx + 16 * j) * LDQ + d];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float qv = q_s[(ty + 16 * i) * LDQ + d];
#pragma unroll
          for (int j = 0; j < CJ; ++j) s[i][j] += qv * (rs[i] ? kx[j] : kr[j]);
        }
      }
    } else {
      for (int d = 0; d < D; ++d) {
        float kr[CJ];
#pragma unroll
        for (int j = 0; j < CJ; ++j) kr[j] = k_s[(tx + 16 * j) * LDQ + d];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float qv = q_s[(ty + 16 * i) * LDQ + d];
#pragma unroll
          for (int j = 0; j < CJ; ++j) s[i][j] += qv * kr[j];
        }
      }
    }

    // masks, ALiBi, online softmax
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      const bool row_in = q0 + r < S;
      const bool sum_row = sum_qs[r] != 0;
      float dist[CJ];
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = tx + 16 * j;
        const int dd = pos_qs[r] - pos_ks[c];
        const int f = flag_ks[c];
        bool ok = row_in && (f & 1) && dd >= 0 && dd <= a.window;
        ok = ok && (!(f & 2) || dd == 0);
        if (a.use_seg) ok = ok && seg_qs[r] == seg_ks[c];
        float x = s[i][j] * a.scale;
        if (NOPE && sum_row) x -= alibi_h * (float)dd;
        s[i][j] = ok ? x : -INFINITY;
        dist[j] = (float)dd;
        tmax = fmaxf(tmax, s[i][j]);
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
          p[j] = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
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
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = tx + 16 * j;
        p_s[r * LDP + c] = p[j];
        if (RESET) {
          const float ad = a.y_min + (a.y_max - a.y_min) /
                                         (1.f + expf(-(dist[j] - a.midpoint)));
          pa_s[r * LDP + c] = sum_row ? p[j] * ad : 0.f;
        }
      }
    }
    __syncthreads();

    // acc += P V (+ P a(d) (V0 - V) on [SUM] rows)
    for (int c = 0; c < BK; ++c) {
      float pv[RI], pr[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        pv[i] = p_s[(ty + 16 * i) * LDP + c];
        if (RESET) pr[i] = pa_s[(ty + 16 * i) * LDP + c];
      }
#pragma unroll
      for (int j = 0; j < VJ; ++j) {
        const int col = tx + 16 * j;
        if (col < Dv) {
          const float vv = v_s[c * DMAX + col];
          const float dv0 = RESET ? v0_s[c * DMAX + col] - vv : 0.f;
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            acc[i][j] += pv[i] * vv;
            if (RESET) acc[i][j] += pr[i] * dv0;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    const size_t ob = (((size_t)b * S + qi) * a.H + h) * Dv;
#pragma unroll
    for (int j = 0; j < VJ; ++j) {
      const int col = tx + 16 * j;
      if (col < Dv) store(a.o + ob + col, acc[i][j] * inv);
    }
    if (tx == 0)
      a.lse[((size_t)b * a.H + h) * S + qi] = l[i] > 0.f ? m[i] + logf(l[i]) : 1e30f;
  }
}

template <typename T, bool NOPE, bool RESET>
int launch(const Args<T>& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(NOPE, RESET);
  auto kern = windowed_attn_kernel<T, NOPE, RESET>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.S + BQ - 1) / BQ, a.H, a.B);
  kern<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args<T>& a, bool nope, bool reset, cudaStream_t st) {
  if (nope) return reset ? launch<T, true, true>(a, st) : launch<T, true, false>(a, st);
  return reset ? launch<T, false, true>(a, st) : launch<T, false, false>(a, st);
}

template <typename T>
Args<T> make_args(const void* q, const void* qn, const void* k, const void* kn,
                  const void* v, const void* v0, const void* alibi,
                  const void* pos_q, const void* pos_k, const void* sum_q,
                  const void* sum_k, const void* valid_k, const void* seg_q,
                  const void* seg_k, void* o, void* lse, int B, int S, int H,
                  int Hk, int D, int Dv, int window, int sum_isolated,
                  int use_seg, float scale, float y_min, float y_max,
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
  a.scale = scale; a.y_min = y_min; a.y_max = y_max; a.midpoint = midpoint;
  return a;
}

}  // namespace

// Returns the launch's cudaError_t (0 = launched). Pointers the flags
// switch off may be null; valid_k may be null (every key valid).
extern "C" int windowed_attn_fwd(
    const void* q, const void* qn, const void* k, const void* kn,
    const void* v, const void* v0, const void* alibi, const void* pos_q,
    const void* pos_k, const void* sum_q, const void* sum_k,
    const void* valid_k, const void* seg_q, const void* seg_k, void* o,
    void* lse, int B, int S, int H, int Hk, int D, int Dv, int window,
    int use_nope, int use_reset, int sum_isolated, int use_seg, int is_bf16,
    float scale, float y_min, float y_max, float midpoint, void* stream) {
  if (D > DMAX || Dv > DMAX || D <= 0 || Dv <= 0 || Hk <= 0 || H % Hk != 0 ||
      window <= 0 || (use_nope && (qn == nullptr || kn == nullptr || sum_q == nullptr)) ||
      (use_reset && v0 == nullptr) || (sum_isolated && sum_k == nullptr) ||
      (use_seg && (seg_q == nullptr || seg_k == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    auto a = make_args<__nv_bfloat16>(q, qn, k, kn, v, v0, alibi, pos_q, pos_k,
                                      sum_q, sum_k, valid_k, seg_q, seg_k, o,
                                      lse, B, S, H, Hk, D, Dv, window,
                                      sum_isolated, use_seg, scale, y_min,
                                      y_max, midpoint);
    return dispatch(a, use_nope != 0, use_reset != 0, st);
  }
  auto a = make_args<float>(q, qn, k, kn, v, v0, alibi, pos_q, pos_k, sum_q,
                            sum_k, valid_k, seg_q, seg_k, o, lse, B, S, H, Hk,
                            D, Dv, window, sum_isolated, use_seg, scale, y_min,
                            y_max, midpoint);
  return dispatch(a, use_nope != 0, use_reset != 0, st);
}
