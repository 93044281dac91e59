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
// What bounds it on this card: at the dti-llama training shape (B=8,
// S=2048, H=32, Hk=8, D=128, window 1024) each pass does ~0.4-0.5 TFLOP of
// products on ~0.5 GB of operands, far above the ~295 FLOP/byte ridge, so
// the bound is arithmetic. This first version multiplies in fp32 FMA from
// shared memory (no tensor cores); mma/wgmma and TMA are later PRs' work.
//
// Design:
// * dq: one CTA per (q tile of 64 rows, query head, batch row). It stages
//   its q tile once (q_nope on [SUM] rows, as the forward stages it), its
//   do tile, lse and delta, then walks the same physical kv band as the
//   forward (kv blocks of 32 within `window` rows), keeping the 64 x D dq
//   accumulator in registers. A [SUM] row's gradient goes to dq_nope and an
//   ordinary row's to dq, so one accumulator serves both streams.
// * dk/dv: one CTA per (kv tile of 32 keys, kv head, batch row). The TPU
//   kernel accumulated per query head and reduced onto kv heads outside
//   (`_head_sum`, a (B,H,S,D) fp32 buffer per output); here the CTA loops
//   over the n_rep query heads of its group and the q tiles of the
//   transposed band (q rows within `window` after its keys), accumulating
//   dk, dk_nope, dv and dv0 per kv head directly: no per-query-head buffer
//   and no atomics. Its K/K_nope/V/V0 tile is staged once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 32;         // keys per tile
constexpr int DMAX = 128;      // largest head dim (qk and v)
constexpr int THREADS = 256;   // 16 row groups x 16 column groups
constexpr int LD = DMAX + 1;   // padded row stride: conflict-free column reads
constexpr int LDP = BK + 1;
constexpr int RI = BQ / 16;    // score rows per thread
constexpr int CJ = BK / 16;    // score columns per thread
constexpr int KI = BK / 16;    // dk/dv keys per thread
constexpr int VJ = DMAX / 16;  // head-dim columns per thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
struct Args {
  const T *q, *qn, *k, *kn, *v, *v0, *dout;
  const float *lse, *delta, *alibi;
  const int *pos_q, *pos_k, *sum_q, *sum_k, *valid_k, *seg_q, *seg_k;
  T *g0, *g1, *g2, *g3;   // dq, dq_nope | dk, dv, dk_nope, dv0
  int B, S, H, Hk, D, Dv, window, sum_isolated, use_seg;
  float scale, y_min, y_max, midpoint;
};

// Shared memory, in floats: q, do (BQ x LD); k, k_nope, v, v0 (BK x LD);
// ds, p (1 - a sigma), p a sigma (BQ x LDP); then the per-row and per-key
// index operands.
constexpr size_t SMEM_FLOATS = 2 * (size_t)BQ * LD + 4 * (size_t)BK * LD +
                               3 * (size_t)BQ * LDP + 2 * BQ;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float) + (3 * BQ + 3 * BK) * sizeof(int);

struct Smem {
  float *q, *dout, *k, *kn, *v, *v0, *ds, *pv, *pa, *lse, *delta;
  int *pos_q, *sum_q, *seg_q, *pos_k, *flag_k, *seg_k;   // flag_k: bit 0 key ok, bit 1 [SUM] key
};

__device__ Smem carve(float* smem) {
  Smem s;
  s.q = smem;
  s.dout = s.q + BQ * LD;
  s.k = s.dout + BQ * LD;
  s.kn = s.k + BK * LD;
  s.v = s.kn + BK * LD;
  s.v0 = s.v + BK * LD;
  s.ds = s.v0 + BK * LD;
  s.pv = s.ds + BQ * LDP;
  s.pa = s.pv + BQ * LDP;
  s.lse = s.pa + BQ * LDP;
  s.delta = s.lse + BQ;
  s.pos_q = reinterpret_cast<int*>(s.delta + BQ);
  s.sum_q = s.pos_q + BQ;
  s.seg_q = s.sum_q + BQ;
  s.pos_k = s.seg_q + BQ;
  s.flag_k = s.pos_k + BK;
  s.seg_k = s.flag_k + BK;
  return s;
}

// Row operands of q tile [q0, q0 + BQ) for query head h: indices, lse and
// delta, then q (q_nope on [SUM] rows) and do. Returns whether the tile
// holds a [SUM] row. Ends synchronised.
template <typename T, bool NOPE>
__device__ int stage_rows(const Smem& sm, const Args<T>& a, int b, int h, int q0) {
  const int tid = threadIdx.x;
  for (int r = tid; r < BQ; r += THREADS) {
    const int qi = q0 + r;
    const bool in = qi < a.S;
    const size_t bs = (size_t)b * a.S + qi;
    const size_t row = ((size_t)b * a.H + h) * a.S + qi;
    sm.pos_q[r] = in ? a.pos_q[bs] : 0;
    sm.sum_q[r] = (in && a.sum_q != nullptr) ? (a.sum_q[bs] != 0) : 0;
    sm.seg_q[r] = (in && a.use_seg) ? a.seg_q[bs] : 0;
    sm.lse[r] = in ? a.lse[row] : 1e30f;
    sm.delta[r] = in ? a.delta[row] : 0.f;
  }
  __syncthreads();
  for (int idx = tid; idx < BQ * a.D; idx += THREADS) {
    const int r = idx / a.D, d = idx - r * a.D, qi = q0 + r;
    float x = 0.f;
    if (qi < a.S) {
      const size_t off = (((size_t)b * a.S + qi) * a.H + h) * a.D + d;
      x = (NOPE && sm.sum_q[r]) ? to_f(a.qn[off]) : to_f(a.q[off]);
    }
    sm.q[r * LD + d] = x;
  }
  for (int idx = tid; idx < BQ * a.Dv; idx += THREADS) {
    const int r = idx / a.Dv, d = idx - r * a.Dv, qi = q0 + r;
    sm.dout[r * LD + d] =
        qi < a.S ? to_f(a.dout[(((size_t)b * a.S + qi) * a.H + h) * a.Dv + d]) : 0.f;
  }
  return __syncthreads_or(tid < BQ ? sm.sum_q[tid] : 0);
}

// Key operands of kv tile [k0, k0 + BK) for kv head hk. K_nope is staged
// when `nope`, V0 when `reset`. Ends synchronised.
template <typename T>
__device__ void stage_keys(const Smem& sm, const Args<T>& a, int b, int hk, int k0,
                           bool nope, bool reset) {
  const int tid = threadIdx.x;
  for (int c = tid; c < BK; c += THREADS) {
    const int kj = k0 + c;
    const bool in = kj < a.S;
    const size_t bs = (size_t)b * a.S + kj;
    sm.pos_k[c] = in ? a.pos_k[bs] : 0;
    const int ok = in && (a.valid_k == nullptr || a.valid_k[bs] != 0);
    const int sk = (in && a.sum_isolated) ? (a.sum_k[bs] != 0) : 0;
    sm.flag_k[c] = ok | (sk << 1);
    sm.seg_k[c] = (in && a.use_seg) ? a.seg_k[bs] : 0;
  }
  for (int idx = tid; idx < BK * a.D; idx += THREADS) {
    const int c = idx / a.D, d = idx - c * a.D, kj = k0 + c;
    const size_t off = (((size_t)b * a.S + kj) * a.Hk + hk) * a.D + d;
    sm.k[c * LD + d] = kj < a.S ? to_f(a.k[off]) : 0.f;
    if (nope) sm.kn[c * LD + d] = kj < a.S ? to_f(a.kn[off]) : 0.f;
  }
  for (int idx = tid; idx < BK * a.Dv; idx += THREADS) {
    const int c = idx / a.Dv, d = idx - c * a.Dv, kj = k0 + c;
    const size_t off = (((size_t)b * a.S + kj) * a.Hk + hk) * a.Dv + d;
    sm.v[c * LD + d] = kj < a.S ? to_f(a.v[off]) : 0.f;
    if (reset) sm.v0[c * LD + d] = kj < a.S ? to_f(a.v0[off]) : 0.f;
  }
  __syncthreads();
}

// The (q tile, kv tile) math shared by both passes: writes scale * ds to
// sm.ds and, for the dk/dv pass, p (1 - a sigma) to sm.pv and p a sigma to
// sm.pa. Rows ty + 16 i, keys tx + 16 j. Ends synchronised.
template <typename T, bool NOPE, bool RESET, bool DKV>
__device__ void tile_ds(const Smem& sm, const Args<T>& a, float alibi_h, int q0,
                        int tile_has_sum) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[RI][CJ], dpv[RI][CJ], dp0[RI][CJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) s[i][j] = dpv[i][j] = dp0[i][j] = 0.f;

  if (NOPE && tile_has_sum) {
    bool rs[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) rs[i] = sm.sum_q[ty + 16 * i] != 0;
    for (int d = 0; d < a.D; ++d) {
      float kr[CJ], kx[CJ];
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        kr[j] = sm.k[(tx + 16 * j) * LD + d];
        kx[j] = sm.kn[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float qv = sm.q[(ty + 16 * i) * LD + d];
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] += qv * (rs[i] ? kx[j] : kr[j]);
      }
    }
  } else {
    for (int d = 0; d < a.D; ++d) {
      float kr[CJ];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kr[j] = sm.k[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float qv = sm.q[(ty + 16 * i) * LD + d];
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] += qv * kr[j];
      }
    }
  }

  // dp = do . v (and do . v0 for the reset stream of [SUM] rows)
  const bool use_v0 = RESET && tile_has_sum;
  for (int d = 0; d < a.Dv; ++d) {
    float vr[CJ], v0r[CJ];
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      vr[j] = sm.v[(tx + 16 * j) * LD + d];
      v0r[j] = use_v0 ? sm.v0[(tx + 16 * j) * LD + d] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float dov = sm.dout[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        dpv[i][j] += dov * vr[j];
        if (RESET) dp0[i][j] += dov * v0r[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    const bool row_in = q0 + r < a.S;
    const bool sum_row = sm.sum_q[r] != 0;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int c = tx + 16 * j;
      const int dd = sm.pos_q[r] - sm.pos_k[c];
      const int f = sm.flag_k[c];
      bool ok = row_in && (f & 1) && dd >= 0 && dd <= a.window;
      ok = ok && (!(f & 2) || dd == 0);
      if (a.use_seg) ok = ok && sm.seg_q[r] == sm.seg_k[c];
      float x = s[i][j] * a.scale;
      if (NOPE && sum_row) x -= alibi_h * (float)dd;
      const float p = ok ? expf(x - sm.lse[r]) : 0.f;
      float asig = 0.f;
      if (RESET && sum_row)
        asig = a.y_min + (a.y_max - a.y_min) / (1.f + expf(-((float)dd - a.midpoint)));
      const float dp = RESET ? dpv[i][j] + asig * (dp0[i][j] - dpv[i][j]) : dpv[i][j];
      sm.ds[r * LDP + c] = a.scale * p * (dp - sm.delta[r]);
      if (DKV) {
        const float pa = p * asig;
        sm.pv[r * LDP + c] = p - pa;
        if (RESET) sm.pa[r * LDP + c] = pa;
      }
    }
  }
  __syncthreads();
}

template <typename T, bool NOPE, bool RESET>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const Args<T> a) {
  extern __shared__ float smem[];
  const Smem sm = carve(smem);
  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hk);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = iq * BQ;
  const float alibi_h = a.alibi[h];

  const int tile_has_sum = stage_rows<T, NOPE>(sm, a, b, h, q0);
  bool rs[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) rs[i] = NOPE && sm.sum_q[ty + 16 * i] != 0;
  float acc[RI][VJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < VJ; ++j) acc[i][j] = 0.f;

  // the forward's physical band: keys in rows [q0 - window, q0 + BQ - 1]
  const int last = min(q0 + BQ, a.S) - 1;
  const int kb_lo = max(q0 - a.window, 0) / BK;
  const int kb_hi = last / BK;
  for (int kb = kb_lo; kb <= kb_hi; ++kb) {
    __syncthreads();   // the previous block's tiles are no longer read
    stage_keys(sm, a, b, hk, kb * BK, NOPE && tile_has_sum, RESET && tile_has_sum);
    tile_ds<T, NOPE, RESET, false>(sm, a, alibi_h, q0, tile_has_sum);
    for (int c = 0; c < BK; ++c) {
      float dsr[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) dsr[i] = sm.ds[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < VJ; ++j) {
        const int col = tx + 16 * j;
        if (col < a.D) {
          const float kv = sm.k[c * LD + col];
          const float kx = NOPE && tile_has_sum ? sm.kn[c * LD + col] : 0.f;
#pragma unroll
          for (int i = 0; i < RI; ++i) acc[i][j] += dsr[i] * (rs[i] ? kx : kv);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= a.S) continue;
    const size_t ob = (((size_t)b * a.S + qi) * a.H + h) * a.D;
#pragma unroll
    for (int j = 0; j < VJ; ++j) {
      const int col = tx + 16 * j;
      if (col >= a.D) continue;
      store(a.g0 + ob + col, rs[i] ? 0.f : acc[i][j]);
      if (NOPE) store(a.g1 + ob + col, rs[i] ? acc[i][j] : 0.f);
    }
  }
}

template <typename T, bool NOPE, bool RESET>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const Args<T> a) {
  extern __shared__ float smem[];
  const Smem sm = carve(smem);
  const int ik = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_rep = a.H / a.Hk;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = ik * BK;

  stage_keys(sm, a, b, hk, k0, NOPE, RESET);
  float dk[KI][VJ], dkn[KI][VJ], dv[KI][VJ], dv0[KI][VJ];
#pragma unroll
  for (int i = 0; i < KI; ++i)
#pragma unroll
    for (int j = 0; j < VJ; ++j) dk[i][j] = dkn[i][j] = dv[i][j] = dv0[i][j] = 0.f;

  // the transposed band: query rows [k0, k0 + BK - 1 + window]
  const int qb_lo = k0 / BQ;
  const int qb_hi = min(k0 + BK - 1 + a.window, a.S - 1) / BQ;
  for (int rep = 0; rep < n_rep; ++rep) {
    const int h = hk * n_rep + rep;
    const float alibi_h = a.alibi[h];
    for (int qb = qb_lo; qb <= qb_hi; ++qb) {
      const int q0 = qb * BQ;
      __syncthreads();   // the previous q tile is no longer read
      const int tile_has_sum = stage_rows<T, NOPE>(sm, a, b, h, q0);
      tile_ds<T, NOPE, RESET, true>(sm, a, alibi_h, q0, tile_has_sum);
      for (int r = 0; r < BQ; ++r) {
        const bool sum_row = NOPE && sm.sum_q[r] != 0;   // uniform over the CTA
        float dsr[KI], pvr[KI], par[KI];
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          const int c = ty + 16 * i;
          dsr[i] = sm.ds[r * LDP + c];
          pvr[i] = sm.pv[r * LDP + c];
          par[i] = RESET ? sm.pa[r * LDP + c] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < VJ; ++j) {
          const int col = tx + 16 * j;
          const float qv = col < a.D ? sm.q[r * LD + col] : 0.f;
          const float dov = col < a.Dv ? sm.dout[r * LD + col] : 0.f;
#pragma unroll
          for (int i = 0; i < KI; ++i) {
            if (sum_row) dkn[i][j] += dsr[i] * qv;
            else dk[i][j] += dsr[i] * qv;
            dv[i][j] += pvr[i] * dov;
            if (RESET) dv0[i][j] += par[i] * dov;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= a.S) continue;
    const size_t bk = ((size_t)b * a.S + kj) * a.Hk + hk;
#pragma unroll
    for (int j = 0; j < VJ; ++j) {
      const int col = tx + 16 * j;
      if (col < a.D) {
        store(a.g0 + bk * a.D + col, dk[i][j]);
        if (NOPE) store(a.g2 + bk * a.D + col, dkn[i][j]);
      }
      if (col < a.Dv) {
        store(a.g1 + bk * a.Dv + col, dv[i][j]);
        if (RESET) store(a.g3 + bk * a.Dv + col, dv0[i][j]);
      }
    }
  }
}

template <typename T, bool NOPE, bool RESET>
int launch(const Args<T>& a, bool dkv, cudaStream_t stream) {
  auto kern = dkv ? dkv_kernel<T, NOPE, RESET> : dq_kernel<T, NOPE, RESET>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid = dkv ? dim3((a.S + BK - 1) / BK, a.Hk, a.B)
                        : dim3((a.S + BQ - 1) / BQ, a.H, a.B);
  kern<<<grid, THREADS, SMEM_BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args<T>& a, bool nope, bool reset, bool dkv, cudaStream_t st) {
  if (nope) return reset ? launch<T, true, true>(a, dkv, st) : launch<T, true, false>(a, dkv, st);
  return reset ? launch<T, false, true>(a, dkv, st) : launch<T, false, false>(a, dkv, st);
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
  a.window = n[6]; a.sum_isolated = n[9]; a.use_seg = n[10];
  a.scale = f[0]; a.y_min = f[1]; a.y_max = f[2]; a.midpoint = f[3];
  return dispatch(a, n[7] != 0, n[8] != 0, dkv, static_cast<cudaStream_t>(stream));
}

int entry(bool dkv, const void* q, const void* qn, const void* k, const void* kn,
          const void* v, const void* v0, const void* dout, const void* lse,
          const void* delta, const void* alibi, const void* pos_q, const void* pos_k,
          const void* sum_q, const void* sum_k, const void* valid_k, const void* seg_q,
          const void* seg_k, void* g0, void* g1, void* g2, void* g3, int B, int S,
          int H, int Hk, int D, int Dv, int window, int use_nope, int use_reset,
          int sum_isolated, int use_seg, int is_bf16, float scale, float y_min,
          float y_max, float midpoint, void* stream) {
  const bool outs_ok = dkv ? (g0 && g1 && (!use_nope || g2) && (!use_reset || g3))
                           : (g0 && (!use_nope || g1));
  if (D > DMAX || Dv > DMAX || D <= 0 || Dv <= 0 || Hk <= 0 || H % Hk != 0 ||
      window <= 0 || !outs_ok ||
      (use_nope && (qn == nullptr || kn == nullptr || sum_q == nullptr)) ||
      (use_reset && (v0 == nullptr || sum_q == nullptr)) ||
      (sum_isolated && sum_k == nullptr) ||
      (use_seg && (seg_q == nullptr || seg_k == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  const void* p[21] = {q, qn, k, kn, v, v0, dout, lse, delta, alibi, pos_q, pos_k,
                       sum_q, sum_k, valid_k, seg_q, seg_k, g0, g1, g2, g3};
  const int n[11] = {B, S, H, Hk, D, Dv, window, use_nope, use_reset, sum_isolated, use_seg};
  const float f[4] = {scale, y_min, y_max, midpoint};
  return is_bf16 ? run<__nv_bfloat16>(p, n, f, dkv, stream)
                 : run<float>(p, n, f, dkv, stream);
}

}  // namespace

// Both entry points return the launch's cudaError_t (0 = launched).
// Operands the flags switch off may be null; valid_k may be null (every
// key valid). lse and delta are fp32 (B, H, S); alibi fp32 (H,).
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
      int use_seg, int is_bf16, float scale, float y_min, float y_max,             \
      float midpoint, void *stream
#define WINDOWED_BWD_ARGS                                                          \
  q, qn, k, kn, v, v0, dout, lse, delta, alibi, pos_q, pos_k, sum_q, sum_k,        \
      valid_k, seg_q, seg_k, g0, g1, g2, g3, B, S, H, Hk, D, Dv, window, use_nope, \
      use_reset, sum_isolated, use_seg, is_bf16, scale, y_min, y_max, midpoint,    \
      stream

extern "C" int windowed_attn_dq(WINDOWED_BWD_PARAMS) {
  return entry(false, WINDOWED_BWD_ARGS);
}

extern "C" int windowed_attn_dkv(WINDOWED_BWD_PARAMS) {
  return entry(true, WINDOWED_BWD_ARGS);
}
